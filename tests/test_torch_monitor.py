"""Kernel A's plain version (the fused sliding monitor) against the JAX
reference's ``sliding_monitor_fused`` (its Pallas kernel in interpret
mode, as tests/test_kernels.py runs it) and the float64 oracle.

(a) zero-mean traces: worst within 1e-4 of the amplitude scale, classes
    and peaks equal off the threshold band, levels and detect exact;
(b) a trace on a 5e8 W DC level: the port within 1e-3 of the signal
    amplitude of ``sliding_bin_power_ref``, and within 1e-4 of JAX fed
    the trace the port centred in float64;
(c) chunked calls that pass the prefix state on equal one call.

The amplitude scale of a row is max |x - mean|: no bin amplitude can
exceed twice it, and the f32 prefix sums' rounding scales with it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.goertzel import ops as jops  # noqa: E402
from repro.kernels.goertzel.goertzel import sliding_monitor_pallas  # noqa
from repro_torch.core.telemetry import CLS_BAND  # noqa: E402
from repro_torch.kernels.goertzel import monitor as tmon  # noqa: E402
from repro_torch.kernels.goertzel import ops as tops  # noqa: E402
from repro_torch.kernels.goertzel.ref import sliding_bin_power_ref  # noqa

TOL = 1e-4
DT, WIN, N = 0.01, 400, 3000
FREQS = (0.5, 1.0, 2.0, 9.0)
SUSTAIN, COOL = 30, 50


def _trace(seed, n=N):
    """A 1 Hz burst switched on at 10 s over a 2 Hz tone and noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) * DT
    x = (2e4 * np.sin(2 * np.pi * 1.0 * t) * (t > 10.0)
         + 5e3 * np.sin(2 * np.pi * 2.0 * t + 0.3)
         + 1e3 * rng.standard_normal(n))
    return x - x.mean()


def _threshold_in_a_gap(worst, scale):
    """A threshold with no sample's worst amplitude within 1e-3 of the
    scale of it, near the upper third of the amplitude range."""
    v = np.sort(worst)
    gaps = np.diff(v)
    lo = np.searchsorted(v, np.quantile(v, 0.6))
    i = lo + int(np.argmax(gaps[lo:] > 2e-3 * scale))
    return float(0.5 * (v[i] + v[i + 1]))


def _jax_fused(x, thr):
    w, lv, de, pk = jops.sliding_monitor_fused(
        jnp.asarray(x, jnp.float32), DT, FREQS, win=WIN, threshold=thr,
        sustain_n=SUSTAIN, cool_n=COOL, interpret=True)
    return np.asarray(w), np.asarray(lv), int(de), np.asarray(pk)


@pytest.mark.parametrize("seed", [0, 1])
def test_zero_mean_trace_matches_reference(seed):
    x = _trace(seed).astype(np.float32)
    scale = float(np.abs(x).max())
    thr = _threshold_in_a_gap(_jax_fused(x, 1e9)[0], scale)
    wj, lj, dj, pj = _jax_fused(x, thr)
    wt, lt, dt_, pt = tops.sliding_monitor_fused(
        torch.as_tensor(x)[None], DT, FREQS, win=WIN, threshold=thr,
        sustain_n=SUSTAIN, cool_n=COOL)
    wt, lt, pt = wt[0].numpy(), lt[0].numpy(), pt[0].numpy()
    assert np.abs(wt - wj).max() <= TOL * scale
    np.testing.assert_allclose(pt, pj[:, :len(FREQS)], rtol=0,
                               atol=TOL * scale)
    np.testing.assert_array_equal(lt, lj)
    assert int(dt_[0]) == dj >= 0                 # it does escalate
    assert lj.max() >= 1 and (lj == 0).any()


def test_classes_match_off_the_threshold_band():
    x = _trace(2).astype(np.float32)
    scale = float(np.abs(x).max())
    thr, rel = 1.2e4, 0.8e4
    xseg = tops.segments(tops.centre(torch.as_tensor(x)[None]), WIN)
    B, S, _ = xseg.shape
    cosp, sinp, rot = (torch.as_tensor(t)
                       for t in tops.phase_tables(FREQS, DT, WIN))
    zeros = torch.zeros((1, len(FREQS), WIN))
    wt, ct, pt, _, _ = tmon.sliding_monitor(
        xseg, cosp, sinp, rot, torch.tensor([thr]), torch.tensor([rel]),
        torch.tensor([N]), torch.tensor([0]), zeros, zeros)
    ref_x = jnp.asarray(xseg[0].numpy())
    cj, sj, rj = jops._phase_tables_v2(FREQS, DT, WIN)
    zj = jnp.zeros_like(jnp.asarray(cj))
    wj, cls_j, pk_j, _, _ = sliding_monitor_pallas(
        ref_x, jnp.asarray(cj), jnp.asarray(sj), jnp.asarray(rj),
        jnp.asarray([[thr, rel, N, 0.0]], jnp.float32), zj, zj,
        k=len(FREQS), block_s=1, interpret=True)
    wj, cls_j = np.asarray(wj).ravel(), np.asarray(cls_j).ravel()
    w, c = wt[0].reshape(-1).numpy(), ct[0].reshape(-1).numpy()
    assert np.abs(w - wj).max() <= TOL * scale
    off_band = ((np.abs(wj - thr) > TOL * scale)
                & (np.abs(wj - rel) > TOL * scale))
    np.testing.assert_array_equal(c[off_band], cls_j[off_band])
    assert (c == CLS_BAND).any() and off_band.mean() > 0.99
    np.testing.assert_allclose(pt[0].numpy(), np.asarray(pk_j)[:, :4],
                               rtol=0, atol=TOL * scale)


def test_dc_trace_follows_the_float64_oracle():
    """On a 5e8 W DC level the float32 mean the reference subtracts is
    hundreds of watts off; the port centres in float64."""
    ac = _trace(3)
    x = (5e8 + ac).astype(np.float32)
    amp = 2e4
    ref = sliding_bin_power_ref(x, DT, FREQS, WIN)
    wt, _, _, pt = tops.sliding_monitor_fused(
        torch.as_tensor(x)[None], DT, FREQS, win=WIN, threshold=1e9,
        sustain_n=SUSTAIN, cool_n=COOL)
    assert np.abs(wt[0].numpy() - ref.max(1)).max() <= 1e-3 * amp
    live = np.arange(N) >= WIN - 1
    seg_peaks = np.stack([
        np.where(live[s * WIN:(s + 1) * WIN, None],
                 ref[s * WIN:(s + 1) * WIN], 0).max(0)
        for s in range(-(-N // WIN))])
    np.testing.assert_allclose(pt[0].numpy(), seg_peaks, rtol=0,
                               atol=1e-3 * amp)
    # JAX on the trace the port centred in float64 agrees to 1e-4
    xc = tops.centre(torch.as_tensor(x)[None])[0].numpy()
    wj = _jax_fused(xc, 1e9)[0]
    assert np.abs(wt[0].numpy() - wj).max() <= TOL * float(
        np.abs(xc).max())


def test_chunked_state_in_out_equals_one_call():
    x = np.stack([_trace(4), _trace(5)]).astype(np.float32)
    xseg = tops.segments(tops.centre(torch.as_tensor(x)), WIN)
    B, S, _ = xseg.shape
    cosp, sinp, rot = (torch.as_tensor(t)
                       for t in tops.phase_tables(FREQS, DT, WIN))
    thr, rel = torch.tensor([1.2e4, 9e3]), torch.tensor([1e4, 9e3])
    n = torch.tensor([N, N])
    zeros = torch.zeros((B, len(FREQS), WIN))
    full = tmon.sliding_monitor(xseg, cosp, sinp, rot, thr, rel, n,
                                torch.tensor([0, 0]), zeros, zeros)
    parts, re, im = [], zeros, zeros
    for lo, hi in [(0, 3), (3, 4), (4, S)]:
        out = tmon.sliding_monitor(
            xseg[:, lo:hi].contiguous(), cosp, sinp, rot, thr, rel, n,
            torch.tensor([lo, lo]), re, im)
        parts.append(out[:3])
        re, im = out[3], out[4]
    for i in range(3):
        assert torch.equal(torch.cat([p[i] for p in parts], 1), full[i])
    assert torch.equal(re, full[3]) and torch.equal(im, full[4])


def test_phase_tables_match_reference():
    c, s, r = tops.phase_tables(FREQS, DT, WIN)
    cj, sj, rj = jops._phase_tables_v2(FREQS, DT, WIN)
    k = len(FREQS)
    np.testing.assert_array_equal(c, cj[:k])
    np.testing.assert_array_equal(s, sj[:k])
    np.testing.assert_array_equal(r, rj[:k])


def _witness_operands(seed, B, n, win, K):
    """Seeded operands of one monitor call on [B, n] traces cut into
    win-sample segments (the last zero-tailed when n % win != 0), with a
    seeded prefix state in."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((B, n)).astype(np.float32) * 1e3)
    xseg = tops.segments(x, win)
    freqs = FREQS[:K]
    cosp, sinp, rot = (torch.as_tensor(t)
                       for t in tops.phase_tables(freqs, DT, win))
    re0 = torch.as_tensor(rng.standard_normal((B, K, win)).astype(np.float32))
    im0 = torch.as_tensor(rng.standard_normal((B, K, win)).astype(np.float32))
    seg0 = torch.as_tensor(rng.integers(0, 3, B))
    seg0[0] = 0                          # row 0 starts in its warm-up
    n_live = seg0 * win + n
    return xseg, cosp, sinp, rot, seg0, n_live, re0, im0


@pytest.mark.parametrize("B,n,win,K", [(1, 400, 400, 4), (2, 1000, 300, 3),
                                       (3, 2501, 512, 4), (1, 77, 128, 2)])
def test_plain_monitor_equals_plain_sliding_reduced_like_the_witness(
        B, n, win, K):
    """Kernel A's plain version against kernel E's, reduced the way
    chip_smoke.py's witness reduces E: A's worst is the amax over bins of
    E's amplitudes, A's peaks the amax per segment of E's amplitudes
    masked to live samples, A's state out E's; bit for bit (the two plain
    versions take the same operations)."""
    from repro_torch.kernels.goertzel import sliding as tsl
    xseg, cosp, sinp, rot, seg0, n_live, re0, im0 = _witness_operands(
        n + win, B, n, win, K)
    thr = torch.full((B,), 2e3)
    worst, _, peaks, nre, nim = tmon.sliding_monitor(
        xseg, cosp, sinp, rot, thr, thr * 0.5, n_live, seg0, re0, im0)
    amps, ere, eim = tsl.sliding_bin_power_v2(xseg, cosp, sinp, rot, seg0,
                                              re0, im0)
    S = xseg.shape[1]
    idx = ((seg0[:, None] + torch.arange(S))[..., None] * win
           + torch.arange(win))
    live = (idx >= win - 1) & (idx < n_live[:, None, None])
    assert torch.equal(worst, amps.amax(-1))
    assert torch.equal(peaks, torch.where(live[..., None], amps, 0.0)
                       .amax(2))
    assert torch.equal(nre, ere) and torch.equal(nim, eim)
    assert (~live).any()      # the zero tail and the warm-up are masked
