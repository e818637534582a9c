"""Kernel E's plain version (per-bin sliding amplitudes), the monitor's
online carry path and the shared escalation step, held against the JAX
reference on the same numpy inputs.

(a) ``sliding_bin_power`` (plain) against the reference's (its Pallas
    kernel in interpret mode) fed the trace the port centred in float64:
    within 1e-4 of the amplitude scale; on a 5e8 W DC trace against the
    float64 oracle within 1e-3 of the signal amplitude (the reference's
    float32 mean is hundreds of watts off there, ROADMAP queue C);
(b) the port's chunked carry calls equal its offline call bit for bit,
    for ``sliding_bin_power`` and the online ``sliding_monitor_fused``,
    at the reference tests' uneven tick sizes;
(c) a reference stream stopped mid-window resumes in the port
    (``from_reference_carry``) and matches the reference run to the end
    within 1e-4 of the amplitude scale;
(d) ``escalation_step`` and ``TelemetrySource.measure`` equal the
    reference's exactly.

The amplitude scale of a trace is max |x - mean|: no bin amplitude can
exceed twice it, and the float32 prefix sums' rounding scales with it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.control import OnlineGoertzelDetector as JDetector  # noqa: E402
from repro.control import ReplaySource as JReplay  # noqa: E402
from repro.core import telemetry as jtel  # noqa: E402
from repro.kernels.goertzel import ops as jops  # noqa: E402
from repro_torch import control  # noqa: E402
from repro_torch.convert import from_reference_carry  # noqa: E402
from repro_torch.core import telemetry as ttel  # noqa: E402
from repro_torch.kernels.goertzel import ops as tops  # noqa: E402
from repro_torch.kernels.goertzel import sliding as tsl  # noqa: E402
from repro_torch.kernels.goertzel.ref import sliding_bin_power_ref  # noqa

TOL = 1e-4
DT = 0.002
FREQS = (0.5, 1.0, 2.0, 9.0)
WIN = 2000
# the reference tests' tick sizes (tests/test_control.py): ticks smaller
# than one window, window-crossing ticks and a final partial tick
CARRY_TICKS = [7, 250, 1999, 2000, 3, 1211, 777, 2000, 753]
REPLAY_TICKS = [900, 37, 2048, 1500, 1, 2000]


def _noisy_ramp(n=9000, seed=0):
    """The reference tests' trace: a 9 Hz ramp on 5e8 W, with noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) * DT
    return (5e8 + 4e7 * np.sin(2 * np.pi * 9.0 * t) * np.clip(t / 10, 0, 1)
            + 1e5 * rng.normal(size=n)).astype(np.float32)


def _ac(seed, n=3000, dt=0.01):
    """A zero-mean trace: a 1 Hz burst from 10 s over a 2 Hz tone."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) * dt
    x = (2e4 * np.sin(2 * np.pi * 1.0 * t) * (t > 10.0)
         + 5e3 * np.sin(2 * np.pi * 2.0 * t + 0.3)
         + 1e3 * rng.standard_normal(n))
    return x - x.mean()


def _jax_amps(x, dt, win):
    return np.asarray(jops.sliding_bin_power(jnp.asarray(x, jnp.float32),
                                             dt, FREQS, win=win,
                                             interpret=True))


# ---------------------------------------------------------------------------
# (a) against the reference and the float64 oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_zero_mean_trace_matches_reference(seed):
    x = _ac(seed).astype(np.float32)
    xc = tops.centre(torch.as_tensor(x)[None])[0].numpy()
    got = tops.sliding_bin_power(torch.as_tensor(x), 0.01, FREQS, win=400)
    ref = _jax_amps(xc, 0.01, 400)
    assert got.shape == ref.shape == (len(x), len(FREQS))
    assert np.abs(got.numpy() - ref).max() <= TOL * float(np.abs(xc).max())


def test_dc_trace_follows_the_float64_oracle():
    x = (5e8 + _ac(3)).astype(np.float32)
    got = tops.sliding_bin_power(torch.as_tensor(x), 0.01, FREQS,
                                 win=400).numpy()
    ref = sliding_bin_power_ref(x, 0.01, FREQS, 400)
    assert np.abs(got - ref).max() <= 1e-3 * 2e4
    # and JAX on the trace the port centred agrees to 1e-4 of the scale
    xc = tops.centre(torch.as_tensor(x)[None])[0].numpy()
    assert np.abs(got - _jax_amps(xc, 0.01, 400)).max() <= TOL * float(
        np.abs(xc).max())


def test_rows_are_independent_and_state_in_out_equals_one_call():
    """Kernel E's plain version on two rows at once equals each row
    alone, and calls that pass the prefix state on equal one call."""
    x = np.stack([_ac(4), _ac(5)]).astype(np.float32)
    xseg = tops.segments(tops.centre(torch.as_tensor(x)), 400)
    B, S, _ = xseg.shape
    cosp, sinp, rot = (torch.as_tensor(t)
                       for t in tops.phase_tables(FREQS, 0.01, 400))
    zeros = torch.zeros((B, len(FREQS), 400))
    seg0 = torch.zeros(B, dtype=torch.int64)
    full = tsl.sliding_bin_power_v2(xseg, cosp, sinp, rot, seg0, zeros,
                                    zeros)
    assert full[0].shape == (B, S, 400, len(FREQS))
    one = tsl.sliding_bin_power_v2(xseg[1:], cosp, sinp, rot, seg0[1:],
                                   zeros[1:], zeros[1:])
    assert torch.equal(one[0], full[0][1:])
    parts, re, im = [], zeros, zeros
    for lo, hi in [(0, 3), (3, 4), (4, S)]:
        amps, re, im = tsl.sliding_bin_power_v2(
            xseg[:, lo:hi].contiguous(), cosp, sinp, rot, seg0 + lo, re, im)
        parts.append(amps)
    assert torch.equal(torch.cat(parts, 1), full[0])
    assert torch.equal(re, full[1]) and torch.equal(im, full[2])


def test_wrapper_checks_operands_and_device():
    xseg = torch.zeros((1, 2, 8))
    cosp = sinp = torch.zeros((3, 8))
    rot = torch.zeros((3, 2))
    zeros = torch.zeros((1, 3, 8))
    with pytest.raises(ValueError, match="seg0"):
        tsl.sliding_bin_power_v2(xseg, cosp, sinp, rot,
                                 torch.zeros(1, dtype=torch.int32), zeros,
                                 zeros)
    with pytest.raises(ValueError, match="no kernel for meta"):
        tsl.sliding_bin_power_v2(*(t.to("meta") for t in (
            xseg, cosp, sinp, rot, torch.zeros(1, dtype=torch.int64),
            zeros, zeros)))


# ---------------------------------------------------------------------------
# (b) chunked carry calls equal one offline call
# ---------------------------------------------------------------------------

def test_carry_uneven_chunks_bit_identical():
    x = torch.as_tensor(_noisy_ramp())
    off = tops.sliding_bin_power(x, DT, FREQS, win=WIN)
    carry = tops.sliding_carry_init(DT, FREQS, win=WIN,
                                    mean=tops.trace_mean(x), device="cpu")
    assert sum(CARRY_TICKS) == len(x) and CARRY_TICKS[-1] < WIN
    outs, pos = [], 0
    for s in CARRY_TICKS:
        amps, carry = tops.sliding_bin_power(x[pos:pos + s], DT, FREQS,
                                             win=WIN, carry=carry)
        assert amps.shape == (s, len(FREQS))
        outs.append(amps)
        pos += s
    assert carry.offset == len(x) and carry.fill == len(x) % WIN
    assert torch.equal(torch.cat(outs), off)


@pytest.mark.parametrize("fused", [False, True])
def test_replay_detector_matches_offline(fused):
    """A trace through ``ReplaySource`` in uneven ticks: the detector's
    per-sample output equals one offline call bit for bit, and its
    per-tick amplitudes are the offline amplitudes at the tick's end."""
    x = _noisy_ramp(seed=3 if not fused else 5)
    thr, rel = 2.5e7, 2.0e7
    src = control.ReplaySource(x, DT, tick_s=0.5, tick_sizes=REPLAY_TICKS)
    det = control.OnlineGoertzelDetector(
        DT, FREQS, window_s=WIN * DT, mean=tops.trace_mean(x), fused=fused,
        threshold_w=thr, release_w=rel, sustain_s=0.5, cooldown_s=1.0,
        device="cpu")
    assert det.win == WIN
    frames = []
    while (chunk := src.next_tick()) is not None:
        frames.append(det.step(chunk))
    off = tops.sliding_bin_power(torch.as_tensor(x), DT, FREQS,
                                 win=WIN).numpy()
    for f in frames:
        np.testing.assert_array_equal(f.amps, off[f.sample_idx])
    if not fused:
        np.testing.assert_array_equal(
            np.concatenate([f.tick_amps for f in frames]), off)
        return
    woff, loff, _, _ = tops.sliding_monitor_fused(
        torch.as_tensor(x)[None], DT, FREQS, win=WIN, threshold=thr,
        release=rel, sustain_n=det.sustain_n, cool_n=det.cool_n)
    np.testing.assert_array_equal(
        np.concatenate([f.tick_worst for f in frames]), woff[0].numpy())
    assert frames[-1].level == int(loff[0, -1])
    assert max(f.level for f in frames) == int(loff.max()) >= 1


def test_carry_resumes_mid_window():
    x = torch.as_tensor(_noisy_ramp(n=5000, seed=1))
    carry = tops.sliding_carry_init(DT, FREQS, win=WIN,
                                    mean=tops.trace_mean(x), device="cpu")
    a1, carry = tops.sliding_bin_power(x[:500], DT, FREQS, win=WIN,
                                       carry=carry)
    assert carry.offset == 500 and carry.fill == 500
    a2, carry = tops.sliding_bin_power(x[500:], DT, FREQS, win=WIN,
                                       carry=carry)
    assert carry.offset == 5000
    off = tops.sliding_bin_power(x, DT, FREQS, win=WIN)
    assert torch.equal(torch.cat([a1, a2]), off)


@pytest.mark.parametrize("fused", [False, True])
def test_carry_refuses_a_chunk_on_another_device(fused):
    """A tensor chunk is never moved to the carry's device behind the
    caller's back (that would run the plain version on a card tensor);
    host numpy data is copied."""
    init = tops.monitor_carry_init if fused else tops.sliding_carry_init
    carry = init(DT, FREQS, win=WIN, device="cpu")
    kw = (dict(threshold=2.5e7, sustain_n=250, cool_n=500) if fused
          else {})
    call = tops.sliding_monitor_fused if fused else tops.sliding_bin_power
    with pytest.raises(ValueError, match="carry is on cpu"):
        call(torch.zeros(16, device="meta"), DT, FREQS, win=WIN,
             carry=carry, **kw)
    out = call(np.zeros(16, np.float32), DT, FREQS, win=WIN, carry=carry,
               **kw)
    assert out[0].device.type == "cpu" and out[0].shape[0] == 16


# ---------------------------------------------------------------------------
# (c) a reference stream resumes in the port
# ---------------------------------------------------------------------------

def _jax_stream(x, sizes, fused, carry):
    outs = []
    pos = 0
    for s in sizes:
        if fused:
            w, lv, amps, carry = jops.sliding_monitor_fused(
                x[pos:pos + s], DT, FREQS, win=WIN, threshold=2.5e7,
                release=2.0e7, sustain_n=250, cool_n=500, carry=carry)
            outs.append((np.asarray(w), np.asarray(lv), np.asarray(amps)))
        else:
            amps, carry = jops.sliding_bin_power(x[pos:pos + s], DT, FREQS,
                                                 win=WIN, carry=carry)
            outs.append(np.asarray(amps))
        pos += s
    return outs, carry


@pytest.mark.parametrize("fused", [False, True])
def test_reference_stream_resumes_in_the_port(fused):
    x = _noisy_ramp(n=6000, seed=2)
    mean = float(jops.trace_mean(x))
    head, tail = [2500, 1100], [1400, 1000]      # stop mid-window
    init = jops.monitor_carry_init if fused else jops.sliding_carry_init
    _, jcarry = _jax_stream(x, head, fused, init(DT, FREQS, win=WIN,
                                                  mean=mean))
    ref, _ = _jax_stream(x[sum(head):], tail, fused, jcarry)
    carry = from_reference_carry(jcarry, n_bins=len(FREQS), device="cpu")
    sl = carry.sliding if fused else carry
    assert sl.prev_re.shape == (1, len(FREQS), WIN)
    assert (sl.offset, sl.fill) == (3600, 1600)
    scale = float(np.abs(x.astype(np.float64) - x.mean()).max())
    pos = sum(head)
    for s, r in zip(tail, ref):
        chunk = torch.as_tensor(x[pos:pos + s])
        if fused:
            w, lv, amps, carry = tops.sliding_monitor_fused(
                chunk, DT, FREQS, win=WIN, threshold=2.5e7, release=2.0e7,
                sustain_n=250, cool_n=500, carry=carry)
            assert np.abs(w.numpy() - r[0]).max() <= TOL * scale
            np.testing.assert_array_equal(lv.numpy(), r[1])
            assert np.abs(amps.numpy() - r[2]).max() <= TOL * scale
        else:
            amps, carry = tops.sliding_bin_power(chunk, DT, FREQS, win=WIN,
                                                 carry=carry)
            assert np.abs(amps.numpy() - r).max() <= TOL * scale
        pos += s
    if fused:
        assert int(carry.esc[0, 0]) >= 1          # the stream escalated


# ---------------------------------------------------------------------------
# (d) the shared escalation step and the sensor model
# ---------------------------------------------------------------------------

def test_escalation_step_matches_reference_sample_by_sample():
    rng = np.random.default_rng(11)
    amps = np.repeat(rng.uniform(0.0, 2.0, 60), rng.integers(1, 9, 60))
    amps = amps.astype(np.float32)
    kw = dict(threshold=1.2, win=5, n=len(amps) - 7, sustain_n=3,
              cool_n=4, max_level=3, release=0.6)
    jc = jtel.escalation_init()
    tc = tuple(ttel.escalation_init(1).unbind(-1))
    levels = []
    for i, a in enumerate(amps):
        jc, jl = jtel.escalation_step(jc, jnp.float32(a), jnp.int32(i), **kw)
        tc, tl = ttel.escalation_step(tc, torch.tensor([a]),
                                      torch.tensor([i]), **kw)
        assert [int(v) for v in jc] == [int(v[0]) for v in tc]
        assert int(jl) == int(tl[0])
        levels.append(int(tl[0]))
    assert max(levels) >= 2 and levels[-1] < max(levels)


@pytest.mark.parametrize("cfg", [
    {},
    {"period_s": 0.01, "latency_s": 0.004, "noise_w": 50.0,
     "quantization_w": 10.0},
    {"period_s": 0.008, "averaged": True, "quantization_w": 0.0},
])
def test_sensor_model_equals_reference(cfg):
    w = _noisy_ramp(n=3000, seed=4).astype(np.float64)
    ref = jtel.TelemetrySource(**cfg).measure(w, DT, seed=7)
    got = ttel.TelemetrySource(**cfg).measure(w, DT, seed=7)
    np.testing.assert_array_equal(got, ref)
    # the replay source degrades chunks through it, seed per tick
    sensor = ttel.TelemetrySource(**cfg)
    src = control.ReplaySource(w, DT, tick_s=0.5, sensor=sensor, seed=3)
    jsrc = JReplay(w, DT, tick_s=0.5, sensor=jtel.TelemetrySource(**cfg),
                   seed=3)
    while (chunk := src.next_tick()) is not None:
        np.testing.assert_array_equal(chunk, jsrc.next_tick())


def test_detector_frames_match_reference_detector():
    """The fused detector's frames against the reference's on the same
    stream, the reference fed the port's float64-centred mean rounded to
    float32 (it subtracts in float32): amplitudes within 1e-4 of the
    amplitude scale, levels equal."""
    x = _noisy_ramp(seed=6)
    mean = float(np.float32(tops.trace_mean(x)))
    kw = dict(window_s=WIN * DT, mean=mean, threshold_w=2.5e7,
              release_w=2.0e7, sustain_s=0.5, cooldown_s=1.0)
    det = control.OnlineGoertzelDetector(DT, FREQS, device="cpu", **kw)
    jdet = JDetector(DT, FREQS, **kw)
    scale = float(np.abs(x.astype(np.float64) - x.mean()).max())
    src = control.ReplaySource(x, DT, tick_s=0.5, tick_sizes=REPLAY_TICKS)
    while (chunk := src.next_tick()) is not None:
        f, jf = det.step(chunk), jdet.step(chunk)
        assert (f.tick, f.sample_idx, f.level) == (jf.tick, jf.sample_idx,
                                                   jf.level)
        assert np.abs(f.amps - jf.amps).max() <= TOL * scale
        assert np.abs(f.tick_worst - jf.tick_worst).max() <= TOL * scale
