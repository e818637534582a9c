"""The port's control plane (``repro_torch.control``) and its design-by-
grid solver against the JAX reference, on the CPU (the kernels' plain
versions), on the same numpy inputs.

(a) ``design(method="grid")`` on an 8 s history: the same winner and the
    same ``grid_ok``; ``energy_overhead`` within abs 1e-6 (the port sums
    energy in float64, the reference in float32: ROADMAP queue C);
    ``mitigated`` within rel 1e-4 of the trace's max |w|;
(b) the power-cap, stagger and redesign transforms: cap and stagger
    exactly (a clamp, and a sum of shifted replicas in group order), the
    redesign within rel 1e-5 of max |w| (the battery's start target is a
    float64 mean in the port);
(c) the closed loop on the canonical 9 Hz ramp, cut to 24 s (the
    reference tests' service replay) so the CPU's plain scans keep the
    file near a minute: the same actions at the same ticks, the same
    redesign choices, recorded amplitudes and margins within rel 1e-4,
    every tick's bin amplitudes within 1e-4 of the amplitude scale (the
    reference centres on a float32 mean, the port on a float64 one), and
    a JSON-safe log.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import control as jcontrol  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core.spec import example_specs as jspecs  # noqa: E402
from repro_torch import api, control  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.kernels.goertzel import ops as tops  # noqa: E402

DT = 0.002
N_CHIPS = 512
RTOL = 1e-4


def _history(peak_amp_w=8e7, t0=14.0, seconds=8.0):
    """An 8 s window of the canonical ramp, scaled by the redesign rung's
    1.25 headroom, as the ladder designs against it."""
    w = control.synthesize_ramp(dt=DT, peak_amp_w=peak_amp_w)
    h = w[int(t0 / DT):int((t0 + seconds) / DT)]
    mean = float(h.mean())
    return (mean + 1.25 * (h - mean)).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) the design search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("job_mw, n_chips, peak, name", [
    (500.0, N_CHIPS, 8e7, "moderate"),        # the loop's own
    (500.0, 2_500_000, 8e7, "moderate"),      # 200 W chips under the floor
    (5.0, 2_500_000, 2e8, "tight"),           # the GPU floor wins
])
def test_design_grid_matches_reference(job_mw, n_chips, peak, name):
    h = _history(peak)
    ref = jengine.design(jspecs(job_mw)[name], h, DT, n_chips,
                         method="grid")
    got = tengine.design(api.example_specs(job_mw)[name], h, DT,
                         n_chips, method="grid", device="cpu")
    assert (got is None) == (ref is None)
    if ref is None:
        return
    assert (got["mpf_frac"], got["battery_capacity_j"]) == (
        ref["mpf_frac"], ref["battery_capacity_j"])
    np.testing.assert_array_equal(got["grid_ok"], ref["grid_ok"])
    assert abs(got["energy_overhead"] - ref["energy_overhead"]) <= 1e-6
    scale = float(np.abs(h).max())
    assert np.abs(got["mitigated"] - ref["mitigated"]).max() <= RTOL * scale
    assert got["report"].ok and got["report"].violations == ()
    # the alternatives rank on overheads rounded to 6 decimals, and the
    # two sums may round across a boundary (the tight case's are 7e-7
    # apart): held to their own order and, where both list a candidate,
    # to the reference's overhead
    alt = {(a["mpf_frac"], a["battery_capacity_j"]): a["energy_overhead"]
           for a in got["alternatives"]}
    for a in ref["alternatives"]:
        key = (a["mpf_frac"], a["battery_capacity_j"])
        if key in alt:
            assert abs(alt[key] - a["energy_overhead"]) <= 1e-6
    keys = [(round(a["energy_overhead"], 6), a["battery_capacity_j"],
             a["mpf_frac"]) for a in got["alternatives"]]
    assert keys == sorted(keys)
    assert len(keys) == min(4, int(got["grid_ok"].sum()))
    assert type(got["rack_mitigation"]).__name__ == type(
        ref["rack_mitigation"]).__name__


def test_unported_design_methods_raise():
    """Every design method runs now; the ones the reference refuses raise
    as there: ``warmstart`` without a predictor and an unknown method."""
    spec = api.example_specs(500.0)["moderate"]
    h = _history()[:300]
    with pytest.raises(ValueError, match="warmstart"):
        tengine.design(spec, h, DT, N_CHIPS, method="warmstart",
                       device="cpu")
    with pytest.raises(ValueError, match="method must be"):
        tengine.design(spec, h, DT, N_CHIPS, method="anneal", device="cpu")
    for method in ("hybrid", "gradient"):
        sol = tengine.design(spec, h, DT, N_CHIPS, method=method, steps=1,
                             device="cpu")
        assert sol is None or sol["method"] == method
    # the grid ignores the gradient keywords, as the reference's does
    a = tengine.design(spec, h, DT, N_CHIPS, method="grid", steps=10,
                       device="cpu")
    b = tengine.design(spec, h, DT, N_CHIPS, method="grid", device="cpu")
    assert (a is None) == (b is None)
    if a is not None:
        assert (a["mpf_frac"], a["battery_capacity_j"]) == (
            b["mpf_frac"], b["battery_capacity_j"])


# ---------------------------------------------------------------------------
# (b) the intervention transforms
# ---------------------------------------------------------------------------

def test_power_cap_and_stagger_transforms_equal_reference():
    w = control.synthesize_ramp(dt=DT)[:20000]
    release = 3e7
    jcap = jcontrol.power_cap_intervention(w, DT, release_amp_w=release,
                                           n_chips=N_CHIPS)
    cap = control.power_cap_intervention(w, DT, release_amp_w=release,
                                         n_chips=N_CHIPS, device="cpu")
    assert cap.params == jcap.params
    np.testing.assert_array_equal(cap.transform(w, DT),
                                  jcap.transform(w, DT))
    for f_hz, groups in [(9.0, 4), (2.0, 3), (0.25, 5)]:
        jst = jcontrol.stagger_intervention(f_hz, DT, n_groups=groups,
                                            history_w=w[:4000])
        st = control.stagger_intervention(f_hz, DT, n_groups=groups,
                                          history_w=w[:4000], device="cpu")
        assert st.params == jst.params
        np.testing.assert_array_equal(st.transform(w, DT),
                                      jst.transform(w, DT))


def test_redesign_transform_matches_reference():
    h = _history(t0=20.0) / 1.25          # the ladder scales it itself
    spec = api.example_specs(500.0)["moderate"]
    jiv = jcontrol.redesign_intervention(jspecs(500.0)["moderate"], h, DT,
                                         N_CHIPS)
    iv = control.redesign_intervention(spec, h, DT, N_CHIPS, device="cpu")
    assert iv.params["mpf_frac"] == jiv.params["mpf_frac"]
    assert iv.params["battery_capacity_j"] == jiv.params["battery_capacity_j"]
    future = control.synthesize_ramp(dt=DT)[14000:20000]
    got, ref = iv.transform(future, DT), jiv.transform(future, DT)
    assert got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-5 * float(np.abs(future).max())


# ---------------------------------------------------------------------------
# (c) the closed loop
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def loop_logs():
    w = control.synthesize_ramp(duration_s=24.0, ramp_start_s=4.0,
                                ramp_end_s=16.0, dt=DT)
    ref = jcontrol.watch_trace(w, DT, spec=jspecs(500.0)["moderate"],
                               n_chips=N_CHIPS)
    got = control.watch_trace(w, DT, spec=api.example_specs(500.0)[
        "moderate"], n_chips=N_CHIPS, device="cpu")
    return w, got, ref


def test_closed_loop_matches_reference(loop_logs):
    w, got, ref = loop_logs
    assert [(r.tick, r.action, r.level, r.bin_hz) for r in got.records] == [
        (r.tick, r.action, r.level, r.bin_hz) for r in ref.records]
    assert any(r.action == "dispatch:redesign" for r in got.records)
    for a, b in zip(got.records, ref.records):
        np.testing.assert_allclose(a.amplitude_w, b.amplitude_w, rtol=RTOL)
        np.testing.assert_allclose(a.margin_w, b.margin_w, rtol=RTOL)
        if a.action == "dispatch:redesign":
            assert a.params["mpf_frac"] == b.params["mpf_frac"]
            np.testing.assert_allclose(a.params["battery_capacity_j"],
                                       b.params["battery_capacity_j"],
                                       rtol=RTOL)
            assert abs(a.params["energy_overhead"]
                       - b.params["energy_overhead"]) <= 1e-6
    scale = float(np.abs(w.astype(np.float64) - w.mean()).max())
    assert len(got.series) == len(ref.series)
    for a, b in zip(got.series, ref.series):
        assert (a["tick"], a["t_s"], a["level"]) == (b["tick"], b["t_s"],
                                                     b["level"])
        assert np.abs(np.subtract(a["amps_w"], b["amps_w"])).max() \
            <= RTOL * scale
    assert got.counterfactual_breach_t_s == ref.counterfactual_breach_t_s


def test_closed_loop_invariants_and_json(loop_logs):
    _, got, ref = loop_logs
    s, r = got.summary(), ref.summary()
    for k in ("n_ticks", "n_dispatches", "final_level", "first_escalate_t_s",
              "breach_t_s", "detection_lead_s", "recession_t_s"):
        assert s[k] == r[k], k
    assert s["n_dispatches"] >= 1 and s["detection_lead_s"] > 0
    blob = json.loads(got.dumps())
    assert blob["summary"]["n_dispatches"] == s["n_dispatches"]
    assert len(blob["series"]) == len(got.series)
    for rec in got.records:
        for v in [rec.tick, rec.t_s, rec.level, rec.amplitude_w,
                  rec.margin_w, rec.latency_s, *rec.params.values()]:
            assert isinstance(v, (int, float, str, list))
    assert "tick" in got.timeline().splitlines()[0]


def test_replay_source_closed_loop_physics():
    """Interventions act on the future only, compose over the pristine
    raw trace, and release restores it."""
    w = np.arange(100, dtype=np.float32) + 100.0
    src = control.ReplaySource(w, DT, tick_s=10 * DT)
    assert (src.next_tick() == w[:10]).all()
    iv = control.Intervention(
        name="halve", params={},
        transform=lambda f, dt: (f * 0.5).astype(np.float32))
    src.apply_interventions([iv])
    assert (src.next_tick() == w[10:20] * 0.5).all()
    assert (src.observed()[:10] == w[:10]).all()
    src.apply_interventions([])
    assert (src.next_tick() == w[20:30]).all()


def test_entry_points_need_the_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = api.example_specs(500.0)["moderate"]
    w = control.synthesize_ramp(duration_s=2.0, dt=DT)
    for call in (
            lambda d: control.watch_trace(w, DT, spec=spec, n_chips=N_CHIPS,
                                          max_ticks=1, device=d),
            lambda d: control.OnlineGoertzelDetector(DT, (9.0,), device=d),
            lambda d: control.InterventionLadder(
                spec=spec, n_chips=N_CHIPS, dt=DT, release_amp_w=1.0,
                device=d),
            lambda d: tengine.design(spec, w, DT, N_CHIPS, method="grid",
                                     device=d),
            lambda d: tops.sliding_carry_init(DT, (9.0,), win=8, device=d),
            lambda d: tops.monitor_carry_init(DT, (9.0,), win=8, device=d)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call(None)
        call("cpu")


if __name__ == "__main__":
    # the port-vs-reference readings behind PERF.md and ROADMAP queue C:
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_control.py
    for job_mw, n_chips, peak, name in [(500.0, N_CHIPS, 8e7, "moderate"),
                                        (500.0, 2_500_000, 8e7, "moderate"),
                                        (5.0, 2_500_000, 2e8, "tight")]:
        h = _history(peak)
        ref = jengine.design(jspecs(job_mw)[name], h, DT, n_chips,
                             method="grid")
        got = tengine.design(api.example_specs(job_mw)[name], h, DT,
                             n_chips, method="grid", device="cpu")
        oh = abs(got["energy_overhead"] - ref["energy_overhead"])
        mit = (np.abs(got["mitigated"] - ref["mitigated"]).max()
               / np.abs(h).max())
        print(f"design {name}, {n_chips} chips: winner "
              f"{(got['mpf_frac'], got['battery_capacity_j'])}, overhead "
              f"gap {oh:.3g}, mitigated gap {mit:.3g} of max |w|")
    w, got, ref = loop_logs.__wrapped__()
    pairs = list(zip(got.records, ref.records))
    scale = float(np.abs(w.astype(np.float64) - w.mean()).max())
    amp = max(abs(a.amplitude_w / b.amplitude_w - 1) for a, b in pairs)
    margin = max(abs(a.margin_w / b.margin_w - 1) for a, b in pairs)
    oh = max(abs(a.params["energy_overhead"] - b.params["energy_overhead"])
             for a, b in pairs if a.action == "dispatch:redesign")
    ticks = max(np.abs(np.subtract(a["amps_w"], b["amps_w"])).max()
                for a, b in zip(got.series, ref.series)) / scale
    print(f"loop: {len(pairs)} records; amplitude rel {amp:.3g}, margin "
          f"rel {margin:.3g}, redesign overhead gap {oh:.3g}, tick "
          f"amplitudes {ticks:.3g} of the scale")
