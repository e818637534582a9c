"""The differentiable design path of the port (``UtilitySpec.loss_jax``,
``engine.design_gradient``/``design_warmstart``/``design`` and
``Study.optimize``) against the reference on the CPU, with kernels J and
K's plain versions, on short traces (200 samples) and at most 3 Adam steps
on both sides.

Tolerances: the hinge components within rtol 1e-4 of the reference's (the
port's ramps are float64 prefix sums, ROADMAP queue C), the loss history
within rtol 1e-3 plus 1e-5 of its largest entry (two libraries' exp and
tanh along a few hundred steps, then 3 Adam steps), the chosen capacity
within rtol 1e-4 and the same MPF, ``energy_overhead`` within abs 1e-6
(unless the two overheads round to different 6-decimal values, the
solvers' ranking key: then only the overheads are held).  One designed
cell of ``Study.optimize`` may choose otherwise than the reference where
the reference fails the port's choice only by a ramp metric at its limit
(ROADMAP queue C): that is checked, not skipped (``_on_the_ramp_edge``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as core
from repro.core import engine as rengine
from repro.core.spec import VIOLATION_ORDER
from repro_torch import api
from repro_torch.core import engine
from repro_torch.core.waveform import job_waveform

DT = 0.01
N_CHIPS = 256
STEPS = 3
LOSS_RTOL = 1e-3
LOSS_ATOL = 1e-5      # of max |loss history|


@pytest.fixture(scope="module")
def problem():
    tl = api.synthetic_timeline(1.0, 0.25)
    cfg = api.WaveformConfig(dt=DT, steps=2, jitter_s=0.02)
    _, w = job_waveform(tl, N_CHIPS, cfg, device="cpu")
    job_mw = float(w.mean()) / 1e6
    return w, api.example_specs(job_mw), core.example_specs(job_mw)


def _same_choice(got, ref, oh="energy_overhead", mpf="mpf_frac",
                 cap="battery_capacity_j"):
    """The same (mpf, capacity) unless the two overheads round to
    different 6-decimal values: the solvers rank candidates by
    ``round(overhead, 6)``, so a float32-level gap across a rounding edge
    legitimately reorders them; then the overheads agree within 1e-6."""
    assert got[oh] == pytest.approx(ref[oh], abs=1e-6)
    if round(got[oh], 6) == round(ref[oh], 6):
        assert got[mpf] == pytest.approx(ref[mpf], rel=1e-4)
        assert got[cap] == pytest.approx(ref[cap], rel=1e-4)


def _same_solution(got, ref):
    _same_choice(got, ref)
    assert got["report"].violations == ref["report"].violations
    assert got["method"] == ref["method"]
    assert len(got["alternatives"]) == len(ref["alternatives"])


# ---------------------------------------------------------------------------
# the spec hinge loss
# ---------------------------------------------------------------------------

def _square(n=400, amp=0.3, mean=1e8, period=1.0):
    t = np.arange(n) * DT
    return (mean * (1 + amp * np.sign(np.sin(2 * np.pi * t / period)))
            ).astype(np.float32)


@pytest.mark.parametrize("margin", [0.0, 0.05, 0.9])
def test_loss_matches_reference(margin):
    spec_t = api.example_specs(100.0)["moderate"]
    spec_r = core.example_specs(100.0)["moderate"]
    # no trace with a small relative wobble: the reference's float32 box
    # filter is off by about 1% on one (ROADMAP queue C, the ramp
    # departure), the port's float64 prefix sums are not
    ws = [_square(), np.full(400, 1e8, np.float32),
          (1e8 + 1e7 * np.sin(np.arange(400) * DT * np.pi)).astype(
              np.float32)]
    got, comps = spec_t.loss_jax(torch.tensor(np.stack(ws)), DT,
                                 margin=margin)
    for i, w in enumerate(ws):
        ref, rcomps = spec_r.loss_jax(jnp.asarray(w), DT, margin=margin)
        assert float(got[i]) == pytest.approx(float(ref), rel=1e-4,
                                              abs=1e-9)
        for k in VIOLATION_ORDER:
            assert float(comps[k][i]) == pytest.approx(
                float(rcomps[k]), rel=1e-4, abs=1e-9), k


def test_loss_zero_iff_compliant_and_aligned_with_flags():
    spec = api.example_specs(100.0)["moderate"]
    flat = torch.full((1, 400), 1e8)
    total, _ = spec.loss_jax(flat, DT)
    ok, _, _ = spec.validate(flat, DT)
    assert float(total[0]) == 0.0 and bool(ok[0])
    square = torch.tensor(_square()[None])
    total, comps = spec.loss_jax(square, DT, margin=0.0)
    ok, flags, _ = spec.validate(square, DT)
    assert not bool(ok[0]) and float(total[0]) > 0
    for name in VIOLATION_ORDER:
        if bool(flags[name][0]):
            assert float(comps[name][0]) > 0, name
        else:
            assert float(comps[name][0]) < 1e-2, name


def test_loss_gradient_matches_jax_and_rows_do_not_mix():
    spec_t = api.example_specs(100.0)["moderate"]
    spec_r = core.example_specs(100.0)["moderate"]
    w = _square(amp=0.05)
    x = torch.tensor(np.stack([w, w[::-1].copy()]), requires_grad=True)
    total, _ = spec_t.loss_jax(x, DT)
    total[0].backward()
    assert float(x.grad[1].abs().max()) == 0.0     # row 1 saw nothing
    ref = np.asarray(jax.grad(lambda v: spec_r.loss_jax(v, DT)[0])(
        jnp.asarray(w)))
    assert np.all(np.isfinite(x.grad[0].numpy()))
    np.testing.assert_allclose(x.grad[0].numpy(), ref, rtol=1e-3,
                               atol=1e-4 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# the solvers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec_name", ["tight", "moderate"])
def test_design_gradient_loss_history_matches_reference(problem, spec_name):
    w, specs_t, specs_r = problem
    got = engine.design_gradient(specs_t[spec_name], w, DT, N_CHIPS,
                                 steps=STEPS, device="cpu")
    ref = rengine.design_gradient(specs_r[spec_name], w, DT, N_CHIPS,
                                  steps=STEPS)
    assert got["loss_history"].shape == ref["loss_history"].shape == (
        6, STEPS)
    np.testing.assert_allclose(
        got["loss_history"], ref["loss_history"], rtol=LOSS_RTOL,
        atol=LOSS_ATOL * np.abs(ref["loss_history"]).max())
    _same_solution(got, ref)
    for m in (got["device_mitigation"], got["rack_mitigation"]):
        assert m is None or m.smooth_tau == 0.0


def test_design_hybrid_never_worse_than_grid(problem):
    w, specs_t, specs_r = problem
    spec = specs_t["tight"]
    grid = engine.design(spec, w, DT, N_CHIPS, method="grid", device="cpu")
    hyb = engine.design(spec, w, DT, N_CHIPS, method="hybrid", steps=STEPS,
                        device="cpu")
    assert hyb is not None and hyb["report"].ok and hyb["method"] == "hybrid"
    assert hyb["energy_overhead"] <= grid["energy_overhead"] + 1e-6
    if round(hyb["energy_overhead"], 6) == round(grid["energy_overhead"], 6):
        assert hyb["battery_capacity_j"] <= grid["battery_capacity_j"] + 1e-6
    ref = rengine.design(specs_r["tight"], w, DT, N_CHIPS, method="hybrid",
                         steps=STEPS)
    _same_solution(hyb, ref)


def test_design_gradient_survives_cap_zero_seed(problem):
    w, specs_t, specs_r = problem
    got = engine.design_gradient(specs_t["tight"], w, DT, N_CHIPS,
                                 seeds=[(0.5, 0.0)], steps=STEPS,
                                 device="cpu")
    assert got is not None and got["report"].ok
    assert np.isfinite(got["loss_history"]).all()
    ref = rengine.design_gradient(specs_r["tight"], w, DT, N_CHIPS,
                                  seeds=[(0.5, 0.0)], steps=STEPS)
    np.testing.assert_allclose(
        got["loss_history"], ref["loss_history"], rtol=LOSS_RTOL,
        atol=LOSS_ATOL * np.abs(ref["loss_history"]).max())


@pytest.mark.parametrize("top_k", [1, 2])
def test_design_gradient_honors_top_k(problem, top_k):
    w, specs_t, _ = problem
    sol = engine.design(specs_t["tight"], w, DT, N_CHIPS, method="gradient",
                        steps=2, top_k=top_k, device="cpu")
    assert sol is not None and len(sol["alternatives"]) <= top_k
    keys = [(round(a["energy_overhead"], 6), a["battery_capacity_j"],
             a["mpf_frac"]) for a in sol["alternatives"]]
    assert keys == sorted(keys)


def test_design_method_validation(problem):
    w, specs_t, _ = problem
    with pytest.raises(ValueError, match="method"):
        engine.design(specs_t["tight"], w, DT, N_CHIPS, method="annealing",
                      device="cpu")
    with pytest.raises(ValueError, match="warmstart"):
        engine.design(specs_t["tight"], w, DT, N_CHIPS, method="warmstart",
                      device="cpu")


# ---------------------------------------------------------------------------
# the warm start, with stub predictors
# ---------------------------------------------------------------------------

def test_warmstart_fast_tier_matches_reference(problem):
    w, specs_t, specs_r = problem
    swing = float(w.max() - w.min())
    stub = lambda spec, w, dt, n, features=None: [(0.0, swing * 1.2, 30.0)]
    got = engine.design(specs_t["tight"], w, DT, N_CHIPS,
                        method="warmstart", warmstart=stub, device="cpu")
    ref = rengine.design(specs_r["tight"], w, DT, N_CHIPS,
                         method="warmstart", warmstart=stub)
    assert got["aux"] == ref["aux"] == {"warmstart_path": "fast"}
    assert got["target_tau_s"] == ref["target_tau_s"] == 30.0
    assert got["rack_mitigation"].target_tau_s == 30.0
    _same_solution(got, ref)


def test_warmstart_polish_tier_matches_reference(problem):
    w, specs_t, specs_r = problem
    bad = lambda spec, w, dt, n, features=None: [(0.05, 1.0, 5.0)]
    got = engine.design(specs_t["tight"], w, DT, N_CHIPS,
                        method="warmstart", warmstart=bad,
                        polish_steps=STEPS, device="cpu")
    ref = rengine.design(specs_r["tight"], w, DT, N_CHIPS,
                         method="warmstart", warmstart=bad,
                         polish_steps=STEPS)
    assert got["aux"]["warmstart_path"] == ref["aux"]["warmstart_path"] \
        == "polish"
    _same_solution(got, ref)


def test_warmstart_hybrid_fallback_tier(problem, monkeypatch):
    """Where the polish finds nothing, the full hybrid answers: with the
    gradient solver stubbed to fail in both packages, the grid's answer."""
    w, specs_t, specs_r = problem
    bad = lambda spec, w, dt, n, features=None: [(0.05, 1.0, 5.0)]
    monkeypatch.setattr(engine, "design_gradient", lambda *a, **k: None)
    monkeypatch.setattr(rengine, "design_gradient", lambda *a, **k: None)
    got = engine.design(specs_t["tight"], w, DT, N_CHIPS,
                        method="warmstart", warmstart=bad, device="cpu")
    ref = rengine.design(specs_r["tight"], w, DT, N_CHIPS,
                         method="warmstart", warmstart=bad)
    assert got["aux"]["warmstart_path"] == "hybrid_fallback"
    assert ref["aux"]["warmstart_path"] == "hybrid_fallback"
    assert got["method"] == "warmstart"
    _same_solution(got, ref)


# ---------------------------------------------------------------------------
# Study.optimize and design_mitigation
# ---------------------------------------------------------------------------

def test_study_optimize_records_match_reference():
    kw = dict(fleets=[N_CHIPS], configs={"none": None}, seeds=[1],
              sample_chips=16)
    st = api.Study({"dense": api.synthetic_timeline(1.0, 0.25)},
                   specs=api.example_specs(0.02),
                   wave_cfg=api.WaveformConfig(dt=DT, steps=2,
                                               jitter_s=0.02),
                   device="cpu", **kw)
    sr = core.Study({"dense": core.synthetic_timeline(1.0, 0.25)},
                    specs=core.example_specs(0.02),
                    wave_cfg=core.WaveformConfig(dt=DT, steps=2,
                                                 jitter_s=0.02), **kw)
    got = st.optimize(method="hybrid", steps=STEPS)
    ref = sr.optimize(method="hybrid", steps=STEPS)
    assert len(got) == len(ref) == 3
    edges = 0
    for a, b in zip(got, ref):
        assert list(a) == list(b)
        if (a["mpf_frac"], a["battery_capacity_j"]) != pytest.approx(
                (b["mpf_frac"], b["battery_capacity_j"]), rel=1e-4):
            edges += 1
            _on_the_ramp_edge(sr, a)
        else:
            _same_choice(a, b)
        for k, v in b.items():
            if k == "metrics":
                assert set(a[k]) == set(v)
            elif k in ("mpf_frac", "battery_capacity_j", "energy_overhead",
                       "swing_mitigated_mw", "paper_band_frac"):
                continue      # the choice (_same_choice) and its metrics
            elif isinstance(v, float):
                assert a[k] == pytest.approx(v, rel=1e-4, abs=1e-6), k
            else:
                assert a[k] == v, k
    # the tight cell: the grid's GPU-only floor (MPF 0.5, no battery) ramps
    # down at exactly the spec's limit; ROADMAP queue C
    assert edges <= 1
    assert len(got.filter(designed=True)) == 3
    both = api.StudyResult(records=st.run().records + got.records)
    assert "designed" in both.to_csv().splitlines()[0]
    assert len(both.filter(designed=False)) == 3


def _on_the_ramp_edge(ref_study, rec):
    """A designed record whose choice the reference did not make: the
    reference judges the port's choice to fail only by ramp metrics within
    2e-3 of their limits, where the port measures them at the limit within
    1e-6 (a GPU floor programmed at the spec's ramp rate ramps at exactly
    the limit; the port's float64 prefix sums measure it there, the
    reference's float32 box filter 0.1% high: 400.39 W/s against 400 in
    this test)."""
    spec = dict(ref_study.specs)[rec["spec"]]
    tl = ref_study.workloads[rec["workload"]]
    cfg = ref_study.wave_cfg
    w = core.aggregate(core.chip_waveform(tl, cfg), rec["n_chips"], cfg,
                       seed=rec["seed"],
                       sample_chips=ref_study.sample_chips).astype(np.float32)
    swing = float(w.max() - w.min())
    _, ok, _, flags, metrics = rengine._eval_candidates(
        spec, w, cfg.dt, rec["n_chips"],
        [(rec["mpf_frac"], rec["battery_capacity_j"])], swing=swing,
        hw=core.DEFAULT_HW)
    assert not bool(np.asarray(ok)[0]) and rec["spec_ok"]
    lim = spec.limits()
    for flag, metric, limit in (("ramp_up", "max_ramp_up_w_per_s",
                                 "ramp_up_w_per_s"),
                                ("ramp_down", "max_ramp_down_w_per_s",
                                 "ramp_down_w_per_s")):
        if bool(np.asarray(flags[flag])[0]):
            assert float(np.asarray(metrics[metric])[0]) == pytest.approx(
                float(lim[limit]), rel=2e-3)
            assert rec["metrics"][metric] == pytest.approx(
                float(lim[limit]), rel=1e-6)
    assert not any(bool(np.asarray(flags[f])[0]) for f in
                   ("dynamic_range", "band_energy", "band_amplitude"))


def test_design_mitigation_passes_gradient_methods_through(problem):
    w, specs_t, _ = problem
    sol = api.design_mitigation(specs_t["tight"], w, DT, N_CHIPS,
                                method="gradient", steps=2, device="cpu")
    assert sol is not None and sol["method"] == "gradient"
    assert "loss_history" in sol and "aux" in sol
