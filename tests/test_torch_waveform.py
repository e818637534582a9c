"""The port's phases, waveform synthesis, aggregation and swing stats,
held against the JAX reference on the same seeded inputs (rtol 1e-6)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import phases as jph  # noqa: E402
from repro.core import waveform as jwf  # noqa: E402
from repro_torch.core import phases as tph  # noqa: E402
from repro_torch.core import waveform as twf  # noqa: E402
from repro_torch.convert import from_reference_fields  # noqa: E402

RTOL = 1e-6

TIMELINES = [(1.0, 0.25, False), (1.5, 0.19, True), (0.7, 0.3, False)]


def _cfgs():
    return [jwf.WaveformConfig(dt=0.005, steps=6, jitter_s=0.02),
            jwf.WaveformConfig(dt=0.01, steps=5, jitter_s=0.03,
                               ckpt_every=2,
                               ckpt_phase=jph.Phase("ckpt", 0.3, jph.CKPT),
                               include_host=True),
            jwf.WaveformConfig(dt=0.008, steps=4, edp_spikes=False)]


@pytest.mark.parametrize("period,comm,moe", TIMELINES)
def test_synthetic_timeline_matches(period, comm, moe):
    a = jph.synthetic_timeline(period, comm, moe_notch=moe)
    b = tph.synthetic_timeline(period, comm, moe_notch=moe)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert b.period_s == pytest.approx(a.period_s, rel=1e-15)
    assert (dataclasses.asdict(a.scaled(1.7))
            == dataclasses.asdict(b.scaled(1.7)))


@pytest.mark.parametrize("ci", range(3))
@pytest.mark.parametrize("ti", range(len(TIMELINES)))
def test_levels_and_chip_waveform_match(ci, ti):
    cfg = _cfgs()[ci]
    tl = jph.synthetic_timeline(*TIMELINES[ti][:2], moe_notch=TIMELINES[ti][2])
    tcfg = from_reference_fields("WaveformConfig", dataclasses.asdict(cfg))
    ttl = from_reference_fields("IterationTimeline", dataclasses.asdict(tl))
    lv_j = jwf.phase_levels(tl, cfg)
    lv_t = twf.phase_levels(ttl, tcfg)
    np.testing.assert_array_equal(lv_j, lv_t)
    ref = np.asarray(jwf.chip_waveform_jax(
        lv_j, cfg.dt, edp_spikes=cfg.edp_spikes,
        include_host=cfg.include_host))
    out = twf.chip_waveform(torch.as_tensor(lv_t)[None], cfg.dt,
                            edp_spikes=tcfg.edp_spikes,
                            include_host=tcfg.include_host)[0].numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL)
    if cfg.edp_spikes:
        assert out.max() > 220.0          # the EDP overshoot is there


def test_jitter_shifts_match():
    for cfg in _cfgs():
        for seed in (0, 1, 7):
            np.testing.assert_array_equal(
                jwf.jitter_shifts(cfg, seed, 64),
                twf.jitter_shifts(from_reference_fields(
                    "WaveformConfig", dataclasses.asdict(cfg)), seed, 64))


@pytest.mark.parametrize("ci", range(3))
def test_aggregate_and_swing_match(ci):
    cfg = _cfgs()[ci]
    tl = jph.synthetic_timeline(1.5, 0.19, moe_notch=True)
    chip = np.asarray(jwf.chip_waveform_jax(jwf.phase_levels(tl, cfg),
                                            cfg.dt))
    fleets = [256.0, 4096.0, 512.0]
    shifts = np.stack([jwf.jitter_shifts(cfg, s, 64) for s in (0, 1, 2)])
    ref = np.stack([np.asarray(jwf.aggregate_jax(jnp.asarray(chip), f, sh))
                    for f, sh in zip(fleets, shifts)])
    out = twf.aggregate(torch.as_tensor(np.stack([chip] * 3)),
                        torch.tensor(fleets), torch.as_tensor(shifts)).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL)
    st = twf.swing_stats(torch.as_tensor(out))
    for i in range(3):
        sj = jwf.swing_stats_jax(jnp.asarray(ref[i]))
        for k, v in sj.items():
            np.testing.assert_allclose(float(st[k][i]), float(v), rtol=RTOL,
                                       err_msg=k)


def test_swing_stats_respect_valid_prefix():
    rng = np.random.default_rng(3)
    w = rng.uniform(1e4, 2e4, size=(2, 400)).astype(np.float32)
    st = twf.swing_stats(torch.as_tensor(w), torch.tensor([400, 250]))
    sj = jwf.swing_stats_jax(jnp.asarray(w[1, :250]))
    for k, v in sj.items():
        np.testing.assert_allclose(float(st[k][1]), float(v), rtol=RTOL,
                                   err_msg=k)
