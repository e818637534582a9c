"""Keyed randomness in the port's Study against the reference.

* The reference's acceptance Study (``tests/test_study.py``
  ``_acceptance_study``: two workload lengths, a disabled baseline, a GPU
  floor with a battery, and Firefly with noisy telemetry, ``key=0``),
  with a ``CombinedMitigation`` config added, built in both packages at
  a short size (dt 0.01, 4 steps, 64 chips) and run in pad and bucket
  mode: every record's metrics within rel 1e-4 (``energy_overhead`` also
  abs 1e-6), the ramps within 4 float32 ulps of the level per dt (the
  ramp departure, ROADMAP queue C), and the verdicts equal but where a
  metric sits within that band of its limit.  The noisy Firefly rows
  draw the reference's noise (``core/prng.py``), so they are held like
  every other row.
* ``scenarios()`` and ``scenario_key()`` against the reference's, key
  words against ``jax.random.key_data``.
* The same root key gives the same records; rows of different keys draw
  different noise; ``key=None`` gives every row the shared draw.

Run as a script, it prints the worst gap of each metric.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_study_keys.py
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.convert import (from_reference_fields,  # noqa: E402
                                 key_from_reference)

DT = 0.01
N_CHIPS = 64
RTOL = 1e-4
RAMPS = ("max_ramp_up_w_per_s", "max_ramp_down_w_per_s")
LIMIT_OF = {"max_ramp_up_w_per_s": "ramp_up_w_per_s",
            "max_ramp_down_w_per_s": "ramp_down_w_per_s",
            "dynamic_range_w": "dynamic_range_w",
            "band_energy_fraction": "max_energy_fraction",
            "ac_rms_frac": "min_ac_rms_frac"}


def _cfg(m, **kw):
    kw.setdefault("dt", DT)
    kw.setdefault("steps", 4)
    return m.WaveformConfig(**kw)


def _acceptance_study(key=0, **kw):
    """The reference's acceptance Study at the short size, plus a
    ``CombinedMitigation`` rack stage."""
    cfg = _cfg(core, jitter_s=0.02)
    tl_short = core.synthetic_timeline(1.0, 0.3)
    tl_long = core.synthetic_timeline(2.0, 0.3, moe_notch=True)
    dc = core.aggregate(core.chip_waveform(tl_short, cfg), N_CHIPS, cfg)
    swing = float(dc.max() - dc.min())
    bat = core.RackBattery(capacity_j=swing, max_discharge_w=swing,
                           max_charge_w=swing, target_tau_s=5.0)
    gpu = core.GpuPowerSmoothing(mpf_frac=0.8, ramp_up_w_per_s=2000,
                                 ramp_down_w_per_s=2000, stop_delay_s=1.0)
    ff = core.Firefly(telemetry=core.TelemetrySource(
        period_s=0.02, latency_s=0.02, noise_w=20.0))
    spec = core.example_specs(job_mw=dc.mean() / 1e6)["moderate"]
    return core.Study(
        {"short": tl_short, "long": tl_long}, fleets=[N_CHIPS],
        configs={"none": None, "mpf80+bat": (gpu, bat),
                 "noisy_ff": (ff, None),
                 "comb": (None, core.CombinedMitigation(gpu, bat, N_CHIPS))},
        specs=spec, seeds=[0, 1], wave_cfg=cfg, key=key, **kw)


def _port(m):
    if m is None:
        return None
    return from_reference_fields(type(m).__name__, dataclasses.asdict(m))


def port_study(ref, key=0, **kw):
    """The port's Study of the reference's ``ref``."""
    return api.Study(
        {k: from_reference_fields("IterationTimeline", dataclasses.asdict(v))
         for k, v in ref.workloads.items()},
        fleets=ref.fleets,
        configs={c.name: (_port(c.device), _port(c.rack))
                 for c in ref.configs},
        specs=[from_reference_fields("UtilitySpec", dataclasses.asdict(s))
               for _, s in ref.specs],
        seeds=ref.seeds,
        wave_cfg=from_reference_fields("WaveformConfig",
                                       dataclasses.asdict(ref.wave_cfg)),
        key=key, device="cpu", **kw)


@pytest.fixture(scope="module")
def acceptance():
    ref = _acceptance_study()
    return ref, port_study(ref)


def compare_records(ref_res, port_res, spec, dt=DT):
    """Hold the port's records to the reference's; returns the worst gap
    of each metric (rel, or in ramp bands) and the near-limit count."""
    lim = spec.limits()
    eps = float(np.finfo(np.float32).eps)
    worst, near = {}, 0
    for a, b in zip(ref_res.records, port_res.records):
        for k in ("workload", "n_chips", "config", "seed", "spec",
                  "n_samples", "row"):
            assert a[k] == b[k], k
        assert set(a["metrics"]) == set(b["metrics"])
        band = 4 * eps * a["mean_mw"] * 1e6 / dt
        pairs = [(k, a[k], b[k]) for k in (
            "mean_mw", "swing_mw", "swing_mitigated_mw", "energy_overhead",
            "paper_band_frac")]
        pairs += [(k, v, b["metrics"][k]) for k, v in a["metrics"].items()]
        is_near = False
        for k, v, w in pairs:
            if k in RAMPS:
                gap = abs(v - w) / band
                assert gap <= 1.0, (k, a["config"], v, w, band)
            else:
                atol = 1e-6 if k == "energy_overhead" else 0.0
                assert abs(v - w) <= RTOL * abs(v) + atol, (
                    k, a["config"], v, w)
                gap = abs(v - w) / max(abs(v), 1e-30)
            worst[k] = max(worst.get(k, 0.0), gap)
            if k in LIMIT_OF:
                tol = band if k in RAMPS else RTOL * abs(lim[LIMIT_OF[k]])
                is_near |= abs(v - float(lim[LIMIT_OF[k]])) <= tol
        if is_near:
            near += 1
            continue
        assert a["spec_ok"] == b["spec_ok"], (a, b)
        assert tuple(a["violations"]) == tuple(b["violations"])
    return worst, near


@pytest.mark.parametrize("padding", ["pad", "bucket"])
def test_acceptance_study_matches_reference(acceptance, padding):
    ref, port = acceptance
    ref_res = ref.run(padding=padding)
    port_res = port.run(padding=padding)
    assert len(port_res) == len(ref_res) == 16
    _, near = compare_records(ref_res, port_res, ref.specs[0][1])
    assert near <= len(ref_res) // 4, near
    # every stage acted: the floor costs energy, Firefly's ballast too
    eo = port_res.columns["energy_overhead"]
    cfg = port_res.columns["config"]
    assert (eo[cfg == "mpf80+bat"] != 0).all()
    assert (eo[cfg == "noisy_ff"] > 0).all()


def test_scenarios_and_keys_match_reference(acceptance):
    ref, port = acceptance
    rs, ps = ref.scenarios(), port.scenarios()
    assert len(rs) == len(ps) == 16
    for a, b in zip(rs, ps):
        assert (a.index, a.row, a.workload, a.n_chips, a.config.name,
                a.spec_name, a.seed) == (b.index, b.row, b.workload,
                                         b.n_chips, b.config.name,
                                         b.spec_name, b.seed)
        assert b.config.enabled == a.config.enabled
    for r in range(ref.n_rows):
        want = np.asarray(jax.random.key_data(ref.scenario_key(r)))
        assert np.array_equal(port.scenario_key(r).numpy(), want)
    # a root given as a key's words is that key
    words = np.asarray(jax.random.key_data(jax.random.PRNGKey(7)))
    by_words = port_study(ref, key=key_from_reference(words))
    assert torch.equal(by_words.scenario_key(3),
                       port_study(ref, key=7).scenario_key(3))
    assert port_study(ref, key=None).scenario_key(0) is None


def _noisy_pair(key):
    """One noisy Firefly config on two rows that differ only in their key
    (jitter off, seeds 0 and 1)."""
    cfg = api.WaveformConfig(dt=DT, steps=4, jitter_s=0.0)
    ff = api.Firefly(telemetry=api.TelemetrySource(
        period_s=0.02, latency_s=0.02, noise_w=20.0))
    return api.Study({"w": api.synthetic_timeline(1.0, 0.3)}, fleets=[64],
                     configs={"ff": (ff, None)}, seeds=[0, 1], wave_cfg=cfg,
                     key=key, device="cpu")


def test_keyed_noise_is_per_row_and_reproducible():
    a = _noisy_pair(0).run().records
    b = _noisy_pair(0).run().records
    assert a == b
    # the rows' only difference is their key
    assert a[0]["energy_overhead"] != a[1]["energy_overhead"]
    other = _noisy_pair(1).run().records
    assert other[0]["energy_overhead"] != a[0]["energy_overhead"]
    shared = _noisy_pair(None).run().records
    assert shared[0]["energy_overhead"] == shared[1]["energy_overhead"]
    assert shared[0]["swing_mitigated_mw"] == shared[1]["swing_mitigated_mw"]


if __name__ == "__main__":
    ref = _acceptance_study()
    port = port_study(ref)
    for padding in ("pad", "bucket"):
        worst, near = compare_records(ref.run(padding=padding),
                                      port.run(padding=padding),
                                      ref.specs[0][1])
        print(f"{padding}: {near} near-limit records; worst gap per metric "
              "(rel; ramps as a share of the 4-ulp band)")
        for k, v in worst.items():
            print(f"  {k:24s} {v:.3g}")
