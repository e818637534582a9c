"""A small mixed-length Study built in both packages (the port's through
``convert.py``) and run in pad mode (bucket mode: test_torch_study_bucket.py,
a file of its own so that each file's reference compile stays short):
verdicts equal except
records with a metric within 1e-4 of its limit (counted), metrics within
rel 1e-4, and ``energy_overhead`` also abs 1e-6 (the order of the
reference's float32 energy sums, ROADMAP queue C).  A flattened trace (a
GPU floor and a small battery at 64 chips) has its ramps held to a
float64 box filter instead, and the reference's to within 4 float32 ulps
of the level per dt of that (ROADMAP queue C, the ramp departure).

Run as a script, it prints the worst port-vs-reference gap of each metric
in both padding modes: the readings behind ROADMAP queue C.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_study.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core  # noqa: E402
from repro.core.study import Study as JaxStudy  # noqa: E402
from repro_torch.core.study import Study as TorchStudy  # noqa: E402
from repro_torch.convert import from_reference_fields  # noqa: E402

RTOL = 1e-4
DT = 0.01
SPEC_NAMES = ("moderate", "tight")
LIMIT_OF = {"max_ramp_up_w_per_s": "ramp_up_w_per_s",
            "max_ramp_down_w_per_s": "ramp_down_w_per_s",
            "dynamic_range_w": "dynamic_range_w",
            "band_energy_fraction": "max_energy_fraction",
            "ac_rms_frac": "min_ac_rms_frac"}


def _reference_study_args():
    cfg = core.WaveformConfig(dt=DT, steps=6, jitter_s=0.02)
    workloads = {"dense_1s": core.synthetic_timeline(1.0, 0.25),
                 "moe_1p5s": core.synthetic_timeline(1.5, 0.25,
                                                     moe_notch=True)}
    gpu = core.GpuPowerSmoothing(mpf_frac=0.7, ramp_up_w_per_s=2000,
                                 ramp_down_w_per_s=2000, stop_delay_s=0.3)
    bat = core.RackBattery(capacity_j=2e5, max_discharge_w=1e5,
                           max_charge_w=1e5, switch_latency_s=0.02)
    # too small to flatten the dense workload, so the backstop behind it
    # escalates on those rows and not on the MoE ones
    small = core.RackBattery(capacity_j=5e3, max_discharge_w=5e3,
                             max_charge_w=5e3)
    bs = core.TelemetryBackstop(critical_hz=(0.5, 1.0, 2.0), window_s=2.0,
                                amp_threshold_w=1.2e4, sustain_s=0.3,
                                cooldown_s=0.5)
    # one structure group (disabled stages join it), so the reference
    # compiles one pipeline per call
    configs = {"none": None, "mpf": (gpu, None),
               "bat+bs": (None, core.Stack([small, bs])),
               "mpf+bat+bs": (gpu, core.Stack([bat, bs]))}
    specs = [core.example_specs(0.05)[n] for n in SPEC_NAMES]
    return dict(workloads=workloads, fleets=[256], configs=configs,
                specs=specs, seeds=[0, 1], wave_cfg=cfg)


def _port(m):
    if m is None:
        return None
    if isinstance(m, core.Stack):
        return from_reference_fields("Stack", {"stages": [
            (type(s).__name__, dataclasses.asdict(s)) for s in m.stages]})
    return from_reference_fields(type(m).__name__, dataclasses.asdict(m))


def _port_study_args(ref):
    return dict(
        workloads={k: from_reference_fields("IterationTimeline",
                                            dataclasses.asdict(v))
                   for k, v in ref["workloads"].items()},
        fleets=ref["fleets"],
        configs={k: None if v is None else (_port(v[0]), _port(v[1]))
                 for k, v in ref["configs"].items()},
        specs=[from_reference_fields("UtilitySpec", dataclasses.asdict(s))
               for s in ref["specs"]],
        seeds=ref["seeds"],
        wave_cfg=from_reference_fields("WaveformConfig",
                                       dataclasses.asdict(ref["wave_cfg"])))


def _atol(key):
    return 1e-6 if key == "energy_overhead" else 0.0


def _pairs(a, b):
    """(metric, reference value, port value) of one record pair."""
    out = [(k, a[k], b[k]) for k in ("mean_mw", "swing_mw",
                                      "swing_mitigated_mw",
                                      "energy_overhead", "paper_band_frac")]
    return out + [(k, v, b["metrics"][k]) for k, v in a["metrics"].items()]


def _compare(ref, port, specs):
    limits = {s.name: s.limits() for s in specs}
    near = 0
    for a, b in zip(ref.records, port.records):
        for k in ("workload", "n_chips", "config", "seed", "spec",
                  "n_samples"):
            assert a[k] == b[k], k
        assert set(a["metrics"]) == set(b["metrics"])
        for k, v, w in _pairs(a, b):
            assert abs(v - w) <= RTOL * abs(v) + _atol(k), (
                k, a["config"], v, w)
        lim = limits[a["spec"]]
        is_near = any(abs(v - float(lim[LIMIT_OF[k]]))
                      <= RTOL * abs(float(lim[LIMIT_OF[k]]))
                      for k, v in a["metrics"].items() if k in LIMIT_OF)
        if is_near:
            near += 1
            continue
        assert a["spec_ok"] == b["spec_ok"], (a, b)
        assert tuple(a["violations"]) == tuple(b["violations"])
    return near


@pytest.fixture(scope="module")
def studies():
    ref = _reference_study_args()
    return ref, _port_study_args(ref)


def check_study_matches_reference(studies, padding):
    ref_args, port_args = studies
    ref = JaxStudy(**ref_args, padding=padding).run()
    port = TorchStudy(**port_args, padding=padding, device="cpu").run()
    assert len(port) == len(ref) == 2 * 4 * 2 * 2
    near = _compare(ref, port, ref_args["specs"])
    assert near <= len(ref) // 4, near
    # every stage acted: the floor costs energy, and the backstop shed
    # load on some rows and left others alone
    cfg, eo = port.columns["config"], port.columns["energy_overhead"]
    assert (eo[cfg == "mpf"] > 0).all()
    assert (eo[cfg == "bat+bs"] < -0.1).any()
    assert (np.abs(eo[cfg == "bat+bs"]) < 0.01).any()


def test_study_matches_reference_padded(studies):
    check_study_matches_reference(studies, "pad")


def test_study_result_queries(studies):
    _, port_args = studies
    res = TorchStudy(**port_args, device="cpu").run()
    assert len(res.filter(config=["none", "mpf"], spec="moderate")) == 8
    piv = res.filter(seed=0, spec="tight").pivot("workload", "config",
                                                 "energy_overhead")
    assert set(piv) == {"dense_1s", "moe_1p5s"}
    assert piv["dense_1s"]["none"] == 0.0
    assert all(r["spec_ok"] for r in res.passing())
    recs = res.to_records()
    assert isinstance(recs[0]["violations"], list)
    assert "max_ramp_up_w_per_s" in recs[0]["metrics"]
    assert res.table().count("\n") == len(res) + 1


def _flattened_args():
    """A MoE workload at 64 chips and dt 5 ms behind a GPU floor of 0.9 and
    a small battery: the rack's power is nearly flat (a 14.6 kW level with
    ramps of about 10 W/s), so one float32 ulp of the level per dt is a
    large share of the ramp (ROADMAP queue C, the ramp departure)."""
    gpu = core.GpuPowerSmoothing(mpf_frac=0.9, ramp_up_w_per_s=500,
                                 ramp_down_w_per_s=800, stop_delay_s=0.1)
    bat = core.RackBattery(capacity_j=1e4, max_discharge_w=2e4,
                           max_charge_w=1e4, switch_latency_s=0)
    return dict(workloads={"moe_1p5s": core.synthetic_timeline(
                    1.5, 0.25, moe_notch=True)},
                fleets=[64], configs={"none": None, "flat": (gpu, bat)},
                specs=[core.example_specs(0.0146)[n] for n in SPEC_NAMES],
                seeds=[0, 1],
                wave_cfg=core.WaveformConfig(dt=0.005, steps=6,
                                             jitter_s=0.02))


def test_flattened_trace_ramps_follow_the_float64_oracle():
    """On a flattened trace the port's ramps follow a float64 box filter of
    its own waveform to rel 1e-6, and the reference's (a float32
    convolution) within 4 float32 ulps of the level per dt of it; the
    other metrics within rel 1e-4, and verdicts equal except where a ramp
    sits inside that band around its limit."""
    from repro_torch.core.engine import simulate_batch
    ref_args = _flattened_args()
    port_args = _port_study_args(ref_args)
    ref = JaxStudy(**ref_args).run()
    port = TorchStudy(**port_args, device="cpu").run()
    cfg, dt = port_args["wave_cfg"], ref_args["wave_cfg"].dt
    k = max(int(port_args["specs"][0].time.ramp_window_s / dt), 1)
    limits = {s.name: s.limits() for s in ref_args["specs"]}
    for a, b in zip(ref.records, port.records):
        assert (a["config"], a["seed"], a["spec"]) == (
            b["config"], b["seed"], b["spec"])
        dev, rack = port_args["configs"][a["config"]] or (None, None)
        w = simulate_batch([port_args["workloads"]["moe_1p5s"]], 64, cfg,
                           device_mitigation=dev, rack_mitigation=rack,
                           seeds=a["seed"], device="cpu"
                           ).dc_mitigated[0].numpy().astype(np.float64)
        dp = np.diff(np.convolve(w, np.ones(k) / k, mode="valid")) / dt
        band = 4 * np.finfo(np.float32).eps * w.mean() / dt
        in_band = False
        for key, oracle in (("max_ramp_up_w_per_s", max(dp.max(), 0.0)),
                            ("max_ramp_down_w_per_s", max(-dp.min(), 0.0))):
            got, want = b["metrics"][key], a["metrics"][key]
            assert abs(got - oracle) <= 1e-6 * oracle, (key, got, oracle)
            assert abs(want - oracle) <= band, (key, want, oracle, band)
            lim = float(limits[a["spec"]][LIMIT_OF[key]])
            in_band |= abs(oracle - lim) <= band
        for key, v, u in _pairs(a, b):
            if key not in ("max_ramp_up_w_per_s", "max_ramp_down_w_per_s"):
                assert abs(v - u) <= RTOL * abs(v) + _atol(key), (key, v, u)
        if not in_band:
            assert a["spec_ok"] == b["spec_ok"], (a, b)
            assert tuple(a["violations"]) == tuple(b["violations"])
    # the floor and battery flatten the trace, and that row's ramps are
    # where the reference's float32 convolution departs most
    flat = port.filter(config="flat")
    assert len(flat) == 4
    assert all(r["metrics"]["max_ramp_up_w_per_s"] < 100.0 for r in flat)


if __name__ == "__main__":
    ref_args = _reference_study_args()
    port_args = _port_study_args(ref_args)
    for padding in ("pad", "bucket"):
        ref = JaxStudy(**ref_args, padding=padding).run()
        port = TorchStudy(**port_args, padding=padding, device="cpu").run()
        worst = {}
        for a, b in zip(ref.records, port.records):
            for k, v, w in _pairs(a, b):
                rel, gap = worst.get(k, (0.0, 0.0))
                worst[k] = (max(rel, abs(v - w) / max(abs(v), 1e-30)),
                            max(gap, abs(v - w)))
        print(f"{padding}: worst gap per metric over {len(ref)} records")
        for k, (rel, gap) in worst.items():
            print(f"  {k:24s} rel {rel:.3g}  abs {gap:.3g}")
