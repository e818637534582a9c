"""Kernel C's divisions (``div_rn`` and ``div64`` in
``kernels/scans/csrc/battery.cu``), emulated exactly on the CPU.  Both
take y = RN(1/b) and Markstein's correction: q0 = RN(a y), nr = RN(b q0 -
a), q = RN(q0 - nr y).  div_rn works in f32 for b in [2^-50, 2^50] and
takes a dividend with |a| in [2^-50, 2^50); there it must equal the IEEE
quotient RN32(a/b) bit for bit.  div64 works in f64 and rounds once to
f32, for every finite a and positive normal b, subnormal results
included.  The divisors are those of the battery step: 0.1, one-way
efficiencies, sample periods and capacities in joules."""
import math
from fractions import Fraction

import numpy as np
import pytest

DIVISORS = [0.1, 0.95, 0.9, 0.001, 0.002, 3.0e6, 7294965.5, 1.0e9,
            2.0 ** -50, 2.0 ** 50]


def rn(x: Fraction, p: int, emin: int) -> Fraction:
    """``x`` rounded to nearest, ties to even, in binary with a ``p``-bit
    significand and the least normal exponent ``emin`` (gradual
    underflow below it)."""
    if x == 0:
        return Fraction(0)
    sign = -1 if x < 0 else 1
    x = abs(x)
    e = math.floor(math.log2(x.numerator) - math.log2(x.denominator))
    while Fraction(2) ** e > x:
        e -= 1
    while Fraction(2) ** (e + 1) <= x:
        e += 1
    ulp = Fraction(2) ** (max(e, emin) - (p - 1))
    m = x / ulp
    n = m.numerator // m.denominator
    rem = m - n
    if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and n % 2):
        n += 1
    return sign * n * ulp


def rn32(x):
    return rn(x, 24, -126)


def rn64(x):
    return rn(x, 53, -1022)


def ieee32(a: float, b: float) -> bytes:
    with np.errstate(over="ignore"):          # an overflow is inf on both
        return (np.float32(a) / np.float32(b)).tobytes()


def f32(x: Fraction) -> bytes:
    return np.float32(float(x)).tobytes()


def div_rn(a: float, b: float):
    """The kernel's div_rn: (quotient, a in its range)."""
    A, B = Fraction(a), Fraction(b)
    y = rn32(1 / B)
    q0 = rn32(A * y)
    nr = rn32(B * q0 - A)
    return rn32(q0 - nr * y), 2.0 ** -50 <= abs(a) < 2.0 ** 50


def div64(a: float, b: float) -> bytes:
    """The kernel's div64 as float32 bytes: the f64 steps exactly, then
    numpy's rounding of that f64 value to f32 (a signed zero where it
    underflows, as the card's conversion gives)."""
    A, B = Fraction(a), Fraction(b)
    y = rn64(1 / B)
    q0 = rn64(A * y)
    nr = rn64(B * q0 - A)
    with np.errstate(over="ignore"):
        return np.float32(float(rn64(q0 - nr * y))).tobytes()


def _dividends(b, seed, n=500):
    rng = np.random.default_rng(seed)
    mags = 2.0 ** rng.uniform(-149, 100, n)
    a = (rng.choice([-1.0, 1.0], n) * mags).astype(np.float32)
    near = (b * np.array([1, 2, 3, 0.5, 1e-30, 1e-38])).astype(np.float32)
    return [float(x) for x in np.concatenate([a, near]) if x != 0]


@pytest.mark.parametrize("b", DIVISORS)
def test_div_rn_is_the_ieee_quotient_wherever_it_passes(b):
    b = float(np.float32(b))
    passed = 0
    for a in _dividends(b, int(abs(math.log2(b)) * 1000) + 7):
        q, ok = div_rn(a, b)
        if ok:
            passed += 1
            assert f32(q) == ieee32(a, b), (a, b)
    assert passed > 150


@pytest.mark.parametrize("b", DIVISORS)
def test_div64_is_the_ieee_quotient_for_every_finite_dividend(b):
    b = float(np.float32(b))
    for a in _dividends(b, int(abs(math.log2(b)) * 1000) + 11, n=300):
        assert div64(a, b) == ieee32(a, b), (a, b)


def test_a_subnormal_quotient_is_div64s():
    """An empty battery's residue: div_rn refuses it, div64 is exact."""
    a, b = float(np.float32(3e-39)), float(np.float32(3.0e6))
    assert not div_rn(a, b)[1]
    assert div64(a, b) == ieee32(a, b)


@pytest.mark.parametrize("zero", [0.0, -0.0])
def test_a_zero_dividend_keeps_its_sign(zero):
    """For a zero a every step is exact (the products are zeros), so
    float arithmetic is the kernel's: q0 = a y, nr = b q0 - a, q = q0 - nr
    y, which is a itself, sign included, as IEEE's a / b, in f32 (div_rn)
    and in f64 (div64)."""
    for b in DIVISORS:
        for t in (np.float32, np.float64):
            a, bb = t(zero), t(np.float32(b))
            y = t(1) / bb
            q0 = a * y
            nr = bb * q0 - a
            q = np.float32(q0 - nr * y)
            want = np.float32(zero) / np.float32(b)
            assert q.tobytes() == want.tobytes() == np.float32(zero).tobytes()
