"""Kernel I's plain version (sliding amplitudes in the v1 bin-minor layout)
and ``phase_tables_v1`` held against the JAX reference on the same numpy
inputs.

(a) ``phase_tables_v1`` equals the reference's ``ops._phase_tables`` bit
    for bit (both host float64 cast to float32);
(b) ``sliding_goertzel_v1`` (plain) against ``sliding_goertzel_pallas(...,
    interpret=True)`` on the same centred segments, for one segment and
    for several (the carry of the previous segment's prefix table): the
    two take float32 prefix sums in their own orders over a window, so
    within 1e-5 of the amplitude scale max |x - mean|;
(c) scaled by the warm-up ramp, as the reference's benchmark wrapper does,
    it equals the port's kernel E path (``ops.sliding_bin_power``) bit for
    bit (the same prefix sums, the tables in another layout), and the
    float64 oracle within 1e-5 of the scale.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.goertzel import ops as jops  # noqa: E402
from repro.kernels.goertzel.goertzel import (  # noqa: E402
    sliding_goertzel_pallas)
from repro_torch.core.telemetry import warmup_scale  # noqa: E402
from repro_torch.kernels.goertzel import ops as tops  # noqa: E402
from repro_torch.kernels.goertzel import sliding_v1 as tv1  # noqa: E402
from repro_torch.kernels.goertzel.ref import sliding_bin_power_ref  # noqa

DT = 0.01
FREQS = (0.39, 1.0, 2.2)
WIN = 500


def _trace(n, seed=0):
    """A 1 Hz and a 2.2 Hz tone on 5e8 W, with noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) * DT
    return (5e8 + 1e5 * np.sin(2 * np.pi * t)
            + 3e4 * np.sin(2 * np.pi * 2.2 * t + 0.7)
            + 1e3 * rng.normal(size=n)).astype(np.float32)


def _segments(x, win):
    """The float64-centred trace as float32 ``[S, win]`` segments, the
    tail zero-padded."""
    xc = tops.centre(torch.from_numpy(x)[None])
    return tops.segments(xc, win)[0]


@pytest.mark.parametrize("freqs,dt,win", [(FREQS, DT, WIN),
                                          ((0.25, 0.5, 1.0, 2.0, 3.0, 5.0,
                                            9.0), 0.002, 2000)])
def test_phase_tables_v1_match_reference_bitwise(freqs, dt, win):
    for got, want in zip(tops.phase_tables_v1(freqs, dt, win),
                         jops._phase_tables(freqs, dt, win)):
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [WIN, 3 * WIN, 4 * WIN + 123])
def test_sliding_v1_plain_matches_pallas(n):
    x = _trace(n, seed=n)
    xseg = _segments(x, WIN)
    cosp, sinp, rot = (torch.from_numpy(t)
                       for t in tops.phase_tables_v1(FREQS, DT, WIN))
    got = tv1.sliding_goertzel_v1(xseg, cosp, sinp, rot)
    want = np.asarray(sliding_goertzel_pallas(
        jnp.asarray(xseg.numpy()), *(jnp.asarray(t.numpy())
                                     for t in (cosp, sinp, rot)),
        interpret=True))
    S = -(-n // WIN)
    assert tuple(got.shape) == want.shape == (S, WIN, len(FREQS))
    scale = float(xseg.abs().max())
    assert np.abs(got.numpy() - want).max() <= 1e-5 * scale


def test_sliding_v1_block_s_contract():
    xseg = torch.zeros((3, WIN))
    cosp, sinp, rot = (torch.from_numpy(t)
                       for t in tops.phase_tables_v1(FREQS, DT, WIN))
    with pytest.raises(ValueError, match="blocks of block_s=2"):
        tv1.sliding_goertzel_v1(xseg, cosp, sinp, rot, block_s=2)
    assert tv1.sliding_goertzel_v1(xseg, cosp, sinp, rot,
                                   block_s=3).shape == (3, WIN, 3)
    with pytest.raises(ValueError, match="no kernel for meta"):
        tv1.sliding_goertzel_v1(*(t.to("meta") for t in (xseg, cosp, sinp,
                                                         rot)))


@pytest.mark.parametrize("n", [3 * WIN, 4 * WIN + 123])
def test_sliding_v1_warmup_scaled_matches_kernel_e_path(n):
    x = _trace(n, seed=n + 1)
    xseg = _segments(x, WIN)
    cosp, sinp, rot = (torch.from_numpy(t)
                       for t in tops.phase_tables_v1(FREQS, DT, WIN))
    raw = tv1.sliding_goertzel_v1(xseg, cosp, sinp, rot)
    v1 = (raw.reshape(-1, len(FREQS))[:n]
          * warmup_scale(torch.arange(n), WIN)[:, None])
    e = tops.sliding_bin_power(torch.from_numpy(x), DT, FREQS, win=WIN)
    scale = float(xseg.abs().max())
    assert torch.equal(v1, e)
    oracle = sliding_bin_power_ref(x, DT, np.asarray(FREQS), WIN)
    assert np.abs(v1.double().numpy() - oracle).max() <= 1e-5 * scale
