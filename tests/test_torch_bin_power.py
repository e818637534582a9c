"""Kernel H's plain version (Goertzel resonators on disjoint windows) and
``bin_power`` held against the JAX reference on the same numpy inputs.

(a) ``goertzel_windows`` (plain) against ``goertzel_pallas(...,
    interpret=True)`` on the same windows and coefficients: the same
    rounding steps (the FMAs XLA contracts the reference into), so within
    one float32 rounding of the amplitude, rel 1e-6 of the largest;
(b) ``bin_power`` against the reference's ``bin_power(..., interpret=
    True)`` over win x K: the two centre each window differently (the
    port's mean in float64, the reference's a float32 sum in XLA's order),
    and the float32 recurrence near coef = 2 turns any input difference
    into rounding noise of about 1e-4 of the amplitude scale (max |x -
    mean|) in both; so each is held within 3e-4 of the scale of the other
    and of the float64 recurrence;
(c) the reference's contract cases: the trailing partial window, n < win,
    W padded to block_w, a known 30 W at 2 Hz, and integer bins against
    the correlation oracle ``bin_power_ref``;
(d) on the traces ``chip_smoke.py`` phase 15 runs, the port's error
    against the float64 recurrence is no worse than twice the reference's
    own (run as a script, this file prints both), and ``chip_smoke.py``'s
    limits carry the reference's errors as printed.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.goertzel import ref as jref  # noqa: E402
from repro.kernels.goertzel.goertzel import goertzel_pallas  # noqa: E402
from repro.kernels.goertzel.ops import bin_power as jbin_power  # noqa: E402
from repro_torch.control import synthesize_ramp  # noqa: E402
from repro_torch.core.spectrum import GRID_CRITICAL_HZ  # noqa: E402
from repro_torch.kernels.goertzel import ops as tops  # noqa: E402
from repro_torch.kernels.goertzel import windows as tw  # noqa: E402
from repro_torch.kernels.goertzel.ref import (  # noqa: E402
    bin_power_recurrence_ref, bin_power_ref, centred_windows, goertzel_ref)

DT = 0.001
TOL = 3e-4          # of the amplitude scale, (b)


def oracle(x, dt, freqs, win):
    """``bin_power`` in float64, on the same float32 coefficients."""
    return bin_power_recurrence_ref(x, tops.goertzel_coef(freqs, dt).numpy(),
                                    win)


def _scale(x):
    x = np.asarray(x, np.float64)
    return np.abs(x - x.mean()).max()


@pytest.mark.parametrize("win", [256, 1000, 1024])
@pytest.mark.parametrize("n_freqs", [1, 3, 4])
def test_goertzel_windows_plain_matches_pallas(win, n_freqs):
    rng = np.random.default_rng(win + n_freqs)
    wnd = rng.normal(0.0, 20.0, (16, win)).astype(np.float32)
    coef = tops.goertzel_coef(np.linspace(0.5, 10.0, n_freqs), DT)
    want = np.asarray(goertzel_pallas(jnp.asarray(wnd),
                                      jnp.asarray(coef.numpy()),
                                      interpret=True))
    got = tw.goertzel_windows(torch.from_numpy(wnd), coef).numpy()
    assert got.shape == (16, n_freqs)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # both sit within float32 rounding noise of the float64 recurrence
    assert np.abs(got - goertzel_ref(wnd, coef.numpy())).max() <= (
        TOL * np.abs(wnd).max())


@pytest.mark.parametrize("win", [256, 1000, 1024])
@pytest.mark.parametrize("n_freqs", [1, 3, 4])
def test_bin_power_matches_reference(win, n_freqs):
    rng = np.random.default_rng(win + n_freqs)
    x = rng.normal(100.0, 20.0, win * 8 + win // 3).astype(np.float32)
    freqs = np.linspace(0.5, 10.0, n_freqs)
    want = np.asarray(jbin_power(jnp.asarray(x), DT, jnp.asarray(freqs),
                                 win=win, interpret=True))
    got = tops.bin_power(x, DT, freqs, win=win, device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape == (9,
                                                                       n_freqs)
    scale = _scale(x)
    assert np.abs(got.numpy() - want).max() <= TOL * scale
    assert np.abs(got.numpy() - oracle(x, DT, freqs, win)).max() <= (
        TOL * scale)


@jax.jit
def _reference_coef(freqs, dt):
    """``ops.bin_power``'s coefficient line, compiled as it is there."""
    return 2.0 * jnp.cos(2 * jnp.pi * jnp.asarray(freqs) * dt)


@pytest.mark.parametrize("dt", [0.001, 0.002, 0.01])
def test_goertzel_coef_follows_the_reference(dt):
    """The coefficients take the reference wrapper's float32 angle; the
    port rounds the float64 cosine of it once, where XLA's float32 cosine
    is now and then one ulp off.  On the grid-critical bins (the monitor's,
    and phase 15's) they are equal."""
    want = np.asarray(_reference_coef(jnp.asarray(GRID_CRITICAL_HZ), dt))
    assert np.array_equal(tops.goertzel_coef(GRID_CRITICAL_HZ, dt).numpy(),
                          want)
    freqs = np.random.default_rng(0).uniform(0.05, 50.0, 500)
    want = np.asarray(_reference_coef(jnp.asarray(freqs), dt))
    got = tops.goertzel_coef(freqs, dt).numpy()
    assert np.abs(got - want).max() <= np.spacing(np.float32(2.0))
    assert (got != want).mean() < 0.02


def test_bin_power_recovers_known_amplitude():
    """A 30 W, 2 Hz oscillation reads about 30 on the 2 Hz bin."""
    t = np.arange(8000) * DT
    x = 200 + 30 * np.sin(2 * np.pi * 2.0 * t)
    got = tops.bin_power(x.astype(np.float32), DT, [1.0, 2.0, 5.0],
                         win=1000, device="cpu").numpy()
    amps = got.mean(axis=0)
    assert abs(amps[1] - 30.0) < 1.5
    assert amps[0] < 3.0 and amps[2] < 3.0
    want = np.asarray(jbin_power(jnp.asarray(x, jnp.float32), DT,
                                 jnp.asarray([1.0, 2.0, 5.0]), win=1000,
                                 interpret=True))
    assert np.abs(got - want).max() <= TOL * _scale(x)


def test_bin_power_integer_bins_match_correlation():
    """At integer cycles per window the recurrence is the DFT bin: the
    correlation oracles (the port's float64 one and the reference's) agree
    with ``bin_power`` as the reference test holds it."""
    win = 1000
    x = np.random.default_rng(0).normal(100, 15, win * 4).astype(np.float32)
    freqs = np.array([1.0, 3.0, 7.0])
    got = tops.bin_power(x, DT, freqs, win=win, device="cpu").numpy()
    ref = bin_power_ref(x.reshape(4, win), DT, freqs)
    np.testing.assert_allclose(got, ref, rtol=5e-3, atol=0.05)
    np.testing.assert_allclose(
        ref, np.asarray(jref.bin_power_ref(x.reshape(4, win), DT, freqs)),
        rtol=1e-4, atol=1e-4)


def test_bin_power_block_padding():
    """W = 5 with block_w 4 pads to 8 windows and trims back to 5."""
    x = np.random.default_rng(1).normal(50, 5, 5 * 256).astype(np.float32)
    seen = []
    real = tops.goertzel_windows

    def spy(windows, coef, *, block_w):
        seen.append((tuple(windows.shape), block_w,
                     bool((windows[5:] == 0).all())))
        return real(windows, coef, block_w=block_w)

    tops.goertzel_windows = spy
    try:
        got = tops.bin_power(x, DT, [2.0], win=256, block_w=4, device="cpu")
    finally:
        tops.goertzel_windows = real
    assert seen == [((8, 256), 4, True)]
    assert got.shape == (5, 1) and torch.isfinite(got).all()
    want = np.asarray(jbin_power(jnp.asarray(x), DT, jnp.asarray([2.0]),
                                 win=256, block_w=4, interpret=True))
    assert np.abs(got.numpy() - want).max() <= TOL * _scale(x)


def test_bin_power_monitors_trailing_partial_window():
    """The n % win tail is its own window: its mean over its true count,
    pad samples exactly 0, amplitudes rescaled by win / count."""
    win, n = 1000, 2500
    t = np.arange(n) * DT
    x = (200.0 + np.where(t >= 2.0, 30.0 * np.sin(2 * np.pi * 4.0 * t),
                          0.0)).astype(np.float32)
    seen = []
    real = tops.goertzel_windows

    def spy(windows, coef, *, block_w):
        seen.append(windows.clone())
        return real(windows, coef, block_w=block_w)

    tops.goertzel_windows = spy
    try:
        got = tops.bin_power(x, DT, [4.0], win=win, device="cpu").numpy()
    finally:
        tops.goertzel_windows = real
    tail = seen[0][2]
    assert (tail[500:] == 0).all() and abs(float(tail[:500].double().sum())
                                           ) < 1e-3
    assert got.shape == (3, 1)
    assert abs(got[2, 0] - 30.0) < 1.5
    assert got[0, 0] < 3.0 and got[1, 0] < 3.0
    want = np.asarray(jbin_power(jnp.asarray(x), DT, jnp.asarray([4.0]),
                                 win=win, interpret=True))
    assert np.abs(got - want).max() <= TOL * _scale(x)
    assert np.abs(got - oracle(x, DT, [4.0], win)).max() <= TOL * _scale(x)


def test_bin_power_trace_shorter_than_window():
    """n < win gives one partial window normalized by the true count."""
    t = np.arange(500) * DT
    x = (100.0 + 20.0 * np.sin(2 * np.pi * 4.0 * t)).astype(np.float32)
    got = tops.bin_power(x, DT, [4.0], win=1000, device="cpu").numpy()
    assert got.shape == (1, 1)
    assert abs(got[0, 0] - 20.0) < 1.0
    want = np.asarray(jbin_power(jnp.asarray(x), DT, jnp.asarray([4.0]),
                                 win=1000, interpret=True))
    assert np.abs(got - want).max() <= TOL * _scale(x)


def test_bin_power_without_a_card_raises_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.ones(300, np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tops.bin_power(x, DT, [1.0], win=100)
    assert tops.bin_power(x, DT, [1.0], win=100, device="cpu").shape == (3, 1)
    with pytest.raises(ValueError, match="no kernel for meta"):
        tw.goertzel_windows(torch.zeros((8, 4), device="meta"),
                            torch.zeros(2, device="meta"))


# the traces of chip_smoke.py phase 15: the 600 s 1 kHz replay (W = 150 of
# 4000), the same cut to 598 765 samples (a 2765-sample tail) and the
# canonical 48 s ramp at 2 ms (win 2000)
def phase15_traces():
    long = synthesize_ramp(duration_s=600.0, dt=0.001, ramp_start_s=60.0,
                           ramp_end_s=300.0)
    return {"600s": (long, 0.001, 4000),
            "600s_tail": (long[:598765], 0.001, 4000),
            "ramp48": (synthesize_ramp(dt=0.002), 0.002, 2000)}


def phase15_errors():
    """Per trace: the reference's and the port's max |bin_power - the
    float64 recurrence| over the amplitude scale, on the CPU."""
    rows = {}
    for name, (x, dt, win) in phase15_traces().items():
        o = oracle(x, dt, GRID_CRITICAL_HZ, win)
        scale = np.abs(centred_windows(x, win)[0]).max()
        ref = np.asarray(jbin_power(jnp.asarray(x), dt,
                                    jnp.asarray(GRID_CRITICAL_HZ), win=win,
                                    interpret=True))
        port = tops.bin_power(x, dt, GRID_CRITICAL_HZ, win=win,
                              device="cpu").numpy()
        rows[name] = (float(np.abs(ref - o).max() / scale),
                      float(np.abs(port - o).max() / scale))
    return rows


def test_bin_power_no_worse_than_twice_the_reference_on_phase15_traces():
    """The port within twice the reference's error on the CPU, and
    chip_smoke.py's limits (``BIN_POWER_REF_ERR``) the reference's errors
    to the digits printed below."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    errors = phase15_errors()
    assert set(errors) == set(chip_smoke.BIN_POWER_REF_ERR)
    for name, (ref_err, port_err) in errors.items():
        assert port_err <= 2.0 * ref_err, (name, ref_err, port_err)
        assert chip_smoke.BIN_POWER_REF_ERR[name] == float(f"{ref_err:.4g}")


if __name__ == "__main__":
    for name, (ref_err, port_err) in phase15_errors().items():
        print(f"{name}: reference {ref_err:.4g}, port {port_err:.4g} of the "
              f"amplitude scale against the float64 recurrence")
