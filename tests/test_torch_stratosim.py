"""The serial reference and the batch helpers of the port (``stratosim``:
``simulate``, ``simulate_jit``, ``simulate_cell``; ``engine``: ``sweep``,
``apply_batch``, ``validate_many``, ``stack_mitigations``,
``BatchResult.scenario``; ``Study(keep_waveforms=True)`` and
``StudyResult.sim_result``; ``np_apply``, ``job_waveform``,
``from_dryrun_cell`` and ``checkpoint_phase``) against the reference on
the CPU, on the same small inputs.

Tolerances: the reference synthesizes its serial waveforms in float64
and the port in float32, so waveforms agree within 2e-6 of their largest
value (1e-5 behind a battery, whose target starts at the port's float64
mean, ROADMAP queue C), scalar metrics within rtol 1e-4 (the Study tests'
tolerance), a swing (a difference of two large numbers) within 4e-6 of
the peak, and ``energy_overhead`` also abs 1e-6 (the reference's float32
energy sums, queue C); spec verdicts are equal (no metric of these cases
sits within 1e-3 of its limit).  Inside the port, ``simulate_jit``
equals ``simulate`` and ``sim_result`` equals the row's own run bit for
bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core as core
from repro.core import engine as rengine
from repro.core import stratosim as rstratosim
from repro.core.phases import (checkpoint_phase as rcheckpoint_phase,
                               from_dryrun_cell as rfrom_dryrun_cell)
from repro.core.smoothing.base import np_apply as rnp_apply
from repro_torch import api
from repro_torch.core import engine, stratosim
from repro_torch.core.phases import checkpoint_phase, from_dryrun_cell
from repro_torch.core.smoothing.base import np_apply
from repro_torch.core.waveform import job_waveform

WAVE_TOL = 2e-6     # of max |waveform|
BATTERY_TOL = 1e-5  # of max |waveform|, behind a battery
RTOL = 1e-4
EO_ATOL = 1e-6      # energy_overhead
DT = 0.01


def _cfg(pkg, **kw):
    return pkg.WaveformConfig(**dict(dict(dt=DT, steps=4, jitter_s=0.02),
                                     **kw))


def _objects(pkg):
    gpu = pkg.GpuPowerSmoothing(mpf_frac=0.7, ramp_up_w_per_s=1500.0,
                                ramp_down_w_per_s=1500.0, stop_delay_s=0.5)
    bat = pkg.RackBattery(capacity_j=2e5, max_discharge_w=3e4,
                          max_charge_w=3e4)
    bs = pkg.TelemetryBackstop(window_s=1.0, sustain_s=0.2,
                               amp_threshold_w=2e3)
    tl = pkg.synthetic_timeline(1.0, 0.25)
    spec = pkg.example_specs(0.05)["lenient"]
    return tl, gpu, bat, bs, spec


def _close(a, b, what="", tol=WAVE_TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=tol * max(np.abs(b).max(), 1e-30),
                               err_msg=what)


def _dict_close(a, b, what="", atol=1e-7):
    assert set(a) == set(b), what
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=RTOL, abs=atol), (what, k)


def _swing_close(a, b, what=""):
    """Swing stats: the swing is a difference of two large numbers."""
    diff = ("swing_w", "swing_frac")
    _dict_close({k: v for k, v in a.items() if k not in diff},
                {k: v for k, v in b.items() if k not in diff}, what)
    assert a["swing_w"] == pytest.approx(b["swing_w"], rel=RTOL,
                                         abs=4e-6 * abs(b["peak_w"])), what
    assert a["swing_frac"] == pytest.approx(b["swing_frac"], rel=RTOL,
                                            abs=4e-6), what


def _sim_close(got, ref, tol=WAVE_TOL):
    for k in ("t", "dc_raw", "chip_raw"):
        _close(getattr(got, k), getattr(ref, k), k)
    _close(got.dc_mitigated, ref.dc_mitigated, "dc_mitigated", tol)
    assert (got.chip_mitigated is None) == (ref.chip_mitigated is None)
    if ref.chip_mitigated is not None:
        _close(got.chip_mitigated, ref.chip_mitigated, "chip_mitigated")
    assert got.energy_overhead == pytest.approx(ref.energy_overhead,
                                                rel=RTOL, abs=EO_ATOL)
    for k in ("swing", "swing_mitigated"):
        _swing_close(getattr(got, k), getattr(ref, k), k)
    for k in ("bands", "bands_mitigated"):
        _dict_close(getattr(got, k), getattr(ref, k), k)
    assert (got.spec_report is None) == (ref.spec_report is None)
    if ref.spec_report is not None:
        assert got.spec_report.violations == ref.spec_report.violations
        _dict_close(got.spec_report.metrics, ref.spec_report.metrics)
    assert set(got.aux) == set(ref.aux)


@pytest.mark.parametrize("stages", ["none", "gpu", "gpu+bat", "bat+bs"])
def test_simulate_matches_reference(stages):
    t_tl, t_gpu, t_bat, t_bs, t_spec = _objects(api)
    r_tl, r_gpu, r_bat, r_bs, r_spec = _objects(core)
    pick = {"none": (None, None), "gpu": (0, None), "gpu+bat": (0, 1),
            "bat+bs": (None, 2)}[stages]

    def stage(i, objs):
        if i is None:
            return None
        if i == 2:
            return objs[-1].Stack((objs[1], objs[2]))
        return objs[i]

    t_objs = (t_gpu, t_bat, t_bs, api)
    r_objs = (r_gpu, r_bat, r_bs, core)
    got = stratosim.simulate(
        t_tl, 256, _cfg(api), device_mitigation=stage(pick[0], t_objs),
        rack_mitigation=stage(pick[1], t_objs), spec=t_spec, seed=1,
        device="cpu")
    ref = rstratosim.simulate(
        r_tl, 256, _cfg(core), device_mitigation=stage(pick[0], r_objs),
        rack_mitigation=stage(pick[1], r_objs), spec=r_spec, seed=1)
    _sim_close(got, ref, WAVE_TOL if pick[1] is None else BATTERY_TOL)
    jit = stratosim.simulate_jit(
        t_tl, 256, _cfg(api), device_mitigation=stage(pick[0], t_objs),
        rack_mitigation=stage(pick[1], t_objs), spec=t_spec, seed=1,
        device="cpu")
    for k in ("dc_raw", "dc_mitigated", "chip_raw"):
        np.testing.assert_array_equal(getattr(jit, k), getattr(got, k))
    assert jit.energy_overhead == got.energy_overhead
    assert jit.spec_report == got.spec_report
    assert jit.bands_mitigated == got.bands_mitigated
    assert set(jit.aux) == set(got.aux)


def test_simulate_keyed_matches_reference():
    """A keyed Firefly on noisy telemetry: the device stage draws from
    fold_in(key, 0), in both packages."""
    ff_t = api.Firefly(telemetry=api.TelemetrySource(noise_w=20.0))
    ff_r = core.Firefly(telemetry=core.TelemetrySource(noise_w=20.0))
    tl_t, tl_r = api.synthetic_timeline(1.0), core.synthetic_timeline(1.0)
    got = stratosim.simulate(tl_t, 64, _cfg(api), device_mitigation=ff_t,
                             key=7, device="cpu")
    ref = rstratosim.simulate(tl_r, 64, _cfg(core), device_mitigation=ff_r,
                              key=jax.random.PRNGKey(7))
    _close(got.chip_mitigated, ref.chip_mitigated, "chip_mitigated")
    _close(got.dc_mitigated, ref.dc_mitigated, "dc_mitigated")
    jit = stratosim.simulate_jit(tl_t, 64, _cfg(api),
                                 device_mitigation=ff_t, key=7, device="cpu")
    np.testing.assert_array_equal(jit.dc_mitigated, got.dc_mitigated)
    _dict_close(got.aux["device"], ref.aux["device"], "aux")


def test_np_apply_matches_reference_with_key():
    rng = np.random.default_rng(0)
    w = (700.0 + 300.0 * np.sign(np.sin(np.arange(600) / 30.0))
         + rng.normal(0, 10, 600)).astype(np.float32)
    ff_t = api.Firefly(telemetry=api.TelemetrySource(noise_w=15.0))
    ff_r = core.Firefly(telemetry=core.TelemetrySource(noise_w=15.0))
    out, aux = np_apply(ff_t, w, 0.002, key=3, device="cpu")
    rout, raux = rnp_apply(ff_r, w, 0.002, jax.random.PRNGKey(3))
    _close(out, rout)
    _dict_close(aux, raux)
    assert isinstance(out, np.ndarray) and out.dtype == np.float32


def _cell(a2a):
    cell = {"n_chips": 512,
            "exact": {"flops": 3.2e18, "bytes": 4.0e15},
            "collectives": {"all-reduce": 6.0e9},
            "memory": {"state_bytes_per_device": 4e9}}
    if a2a:
        cell["collectives"]["all-to-all"] = 2.0e9
    return cell


@pytest.mark.parametrize("a2a", [False, True])
def test_from_dryrun_cell_and_checkpoint_phase(a2a):
    cell = _cell(a2a)
    for overlap, mfu in ((0.0, 0.5), (0.4, 0.35)):
        got = from_dryrun_cell(cell, overlap=overlap, mfu=mfu)
        ref = rfrom_dryrun_cell(cell, overlap=overlap, mfu=mfu)
        assert [dataclasses.astuple(p) for p in got.phases] == [
            dataclasses.astuple(p) for p in ref.phases]
    assert dataclasses.astuple(checkpoint_phase(cell)) == \
        dataclasses.astuple(rcheckpoint_phase(cell))
    assert checkpoint_phase({}).duration_s == rcheckpoint_phase({}).duration_s


def test_simulate_cell_matches_reference():
    cell = _cell(True)
    _, t_gpu, _, _, t_spec = _objects(api)
    _, r_gpu, _, _, r_spec = _objects(core)
    kw = dict(steps=3, dt=DT, jitter_s=0.02)
    # the GPU floor alone: behind this battery the trace is flat to 2e-4,
    # and its band fractions measure float32 rounding
    got = stratosim.simulate_cell(cell, device_mitigation=t_gpu,
                                  spec=t_spec, device="cpu", **kw)
    ref = rstratosim.simulate_cell(cell, device_mitigation=r_gpu,
                                   spec=r_spec, **kw)
    _sim_close(got, ref)


def test_job_waveform_matches_reference():
    tl_t, tl_r = api.synthetic_timeline(1.5, 0.2), core.synthetic_timeline(
        1.5, 0.2)
    t, w = job_waveform(tl_t, 1024, _cfg(api), seed=2, device="cpu")
    rt, rw = core.job_waveform(tl_r, 1024, _cfg(core), seed=2)
    np.testing.assert_array_equal(t, rt)
    _close(w, rw)


def test_sweep_matches_reference():
    t_tl, t_gpu, t_bat, t_bs, t_spec = _objects(api)
    r_tl, r_gpu, r_bat, r_bs, r_spec = _objects(core)
    wl_t = {"a": t_tl, "b": api.synthetic_timeline(0.5, 0.3, moe_notch=True)}
    wl_r = {"a": r_tl, "b": core.synthetic_timeline(0.5, 0.3,
                                                    moe_notch=True)}
    cfgs_t = [(None, None), (t_gpu, None), (None, t_bat), (t_gpu, t_bat)]
    cfgs_r = [(None, None), (r_gpu, None), (None, r_bat), (r_gpu, r_bat)]
    got = engine.sweep(wl_t, [128, 512], cfgs_t, _cfg(api), spec=t_spec,
                       seeds=(0, 1), device="cpu")
    ref = rengine.sweep(wl_r, [128, 512], cfgs_r, _cfg(core), spec=r_spec,
                        seeds=(0, 1))
    assert len(got) == len(ref) == 32
    for a, b in zip(got, ref):
        assert set(a) == set(b)
        for k, v in b.items():
            if k == "swing_mitigated_mw":
                assert a[k] == pytest.approx(v, rel=RTOL,
                                             abs=4e-6 * b["mean_mw"] * 2), k
            elif isinstance(v, float):
                assert a[k] == pytest.approx(v, rel=RTOL, abs=EO_ATOL), k
            else:
                assert a[k] == v, k


def test_apply_batch_matches_reference():
    rng = np.random.default_rng(4)
    w = np.repeat(rng.uniform(300, 1000, 40), 25).astype(np.float32)
    mpfs = (0.3, 0.6, 0.9)
    got, gaux = engine.apply_batch(
        [api.GpuPowerSmoothing(mpf_frac=m) for m in mpfs], w, 0.002,
        device="cpu")
    ref, raux = rengine.apply_batch(
        [core.GpuPowerSmoothing(mpf_frac=m) for m in mpfs], w, 0.002)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(gaux["floor_w"], raux["floor_w"], rtol=0)
    np.testing.assert_allclose(gaux["energy_overhead"],
                               raux["energy_overhead"], rtol=1e-5)
    bats_t = [api.RackBattery(capacity_j=c, max_discharge_w=200.0,
                              max_charge_w=200.0) for c in (50.0, 400.0)]
    bats_r = [core.RackBattery(capacity_j=c, max_discharge_w=200.0,
                               max_charge_w=200.0) for c in (50.0, 400.0)]
    got, gaux = engine.apply_batch(bats_t, w, 0.002, device="cpu")
    ref, raux = rengine.apply_batch(bats_r, w, 0.002)
    _close(got, ref, tol=BATTERY_TOL)
    np.testing.assert_allclose(gaux["soc_min_frac"], raux["soc_min_frac"],
                               rtol=1e-5, atol=1e-7)


def test_validate_many_matches_reference_and_per_row():
    rng = np.random.default_rng(5)
    ws = (1e6 + np.cumsum(rng.normal(0, 2e3, (6, 800)), axis=1)
          ).astype(np.float32)
    spec_t = api.example_specs(1.0)["moderate"]
    spec_r = core.example_specs(1.0)["moderate"]
    ok, reports = engine.validate_many(ws, spec_t, DT, device="cpu")
    rok, rreports = rengine.validate_many(ws, spec_r, DT)
    np.testing.assert_array_equal(ok, rok)
    for a, b in zip(reports, rreports):
        assert a.violations == b.violations
        _dict_close(a.metrics, b.metrics)
    for i in range(len(ws)):
        one_ok, one = engine.validate_many(ws[i:i + 1], spec_t, DT,
                                           device="cpu")
        assert bool(one_ok[0]) == bool(ok[i])
        assert one[0].violations == reports[i].violations


def test_stack_mitigations_matches_reference_leaves():
    gpus_t = [api.GpuPowerSmoothing(mpf_frac=m, stop_delay_s=s)
              for m, s in ((0.5, 1.0), (0.8, 2.0))]
    gpus_r = [core.GpuPowerSmoothing(mpf_frac=m, stop_delay_s=s)
              for m, s in ((0.5, 1.0), (0.8, 2.0))]
    got = engine.stack_mitigations(gpus_t)
    ref = rengine.stack_mitigations(gpus_r)
    for f in api.GpuPowerSmoothing.PARAMS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    assert got.hw == gpus_t[0].hw and got.smooth_tau == 0.0
    stacks = engine.stack_mitigations(
        [api.Stack((api.RackBattery(capacity_j=c, max_discharge_w=1.0,
                                    max_charge_w=1.0),
                    api.TelemetryBackstop(amp_threshold_w=t)))
         for c, t in ((1.0, 2.0), (3.0, 4.0))])
    assert stacks.stages[0].capacity_j.tolist() == [1.0, 3.0]
    assert stacks.stages[1].amp_threshold_w.tolist() == [2.0, 4.0]
    with pytest.raises(ValueError, match="one structure"):
        engine.stack_mitigations([api.GpuPowerSmoothing(),
                                  api.GpuPowerSmoothing(smooth_tau=0.1)])
    with pytest.raises(ValueError, match="empty"):
        engine.stack_mitigations([])


def test_batch_result_scenario_with_disabled_rows():
    """Row i of a batch that mixes disabled and enabled stages equals the
    serial run of row i: no aux and no mitigated chip trace for a
    disabled stage."""
    tl, gpu, bat, _, spec = _objects(api)
    res = engine.simulate_batch([tl] * 3, [128, 256, 512], _cfg(api),
                                device_mitigation=[None, gpu, gpu],
                                rack_mitigation=[bat, None, bat], spec=spec,
                                seeds=[0, 1, 2], device="cpu")
    assert len(res) == 3 and res.length(1) == res.dc_raw.shape[1]
    for i, (d, r) in enumerate(((None, bat), (gpu, None), (gpu, bat))):
        got = res.scenario(i)
        one = stratosim.simulate(tl, [128, 256, 512][i], _cfg(api),
                                 device_mitigation=d, rack_mitigation=r,
                                 spec=spec, seed=i, device="cpu")
        np.testing.assert_array_equal(got.dc_mitigated, one.dc_mitigated)
        assert (got.chip_mitigated is None) == (d is None)
        assert set(got.aux) == set(one.aux)
        assert got.spec_report == one.spec_report
        assert got.bands == one.bands


def test_study_keep_waveforms_and_sim_result():
    t_tl, t_gpu, t_bat, _, t_spec = _objects(api)
    r_tl, r_gpu, r_bat, _, r_spec = _objects(core)
    kw = dict(fleets=[128, 512], seeds=[0, 1], sample_chips=16)
    wl_t = {"a": t_tl, "b": api.synthetic_timeline(0.7, 0.3)}
    wl_r = {"a": r_tl, "b": core.synthetic_timeline(0.7, 0.3)}
    st = api.Study(wl_t, configs={"none": None, "both": (t_gpu, t_bat)},
                   specs=t_spec, wave_cfg=_cfg(api), keep_waveforms=True,
                   device="cpu", **kw)
    sr = core.Study(wl_r, configs={"none": None, "both": (r_gpu, r_bat)},
                    specs=r_spec, wave_cfg=_cfg(core), keep_waveforms=True,
                    **kw)
    got, ref = st.run(), sr.run()
    chunked = st.run(stream=3)
    assert len(got.waveforms) == len(ref.waveforms) == st.n_rows
    for r in range(st.n_rows):
        a, b = got.sim_result(r), ref.sim_result(r)
        np.testing.assert_array_equal(a.t, b.t)
        _close(a.dc_raw, b.dc_raw)
        _close(a.dc_mitigated, b.dc_mitigated, tol=BATTERY_TOL)
        assert a.energy_overhead == pytest.approx(b.energy_overhead,
                                                  rel=RTOL, abs=EO_ATOL)
        c = chunked.sim_result(r)
        np.testing.assert_array_equal(c.dc_mitigated, a.dc_mitigated)
    # the row's waveform is the serial reference's
    w, n, c, s = st.rows()[5]
    one = stratosim.simulate(wl_t[w], n, _cfg(api), device_mitigation=c.device,
                             rack_mitigation=c.rack, seed=s, sample_chips=16,
                             device="cpu")
    np.testing.assert_array_equal(got.sim_result(5).dc_mitigated,
                                  one.dc_mitigated)
    with pytest.raises(ValueError, match="keep_waveforms"):
        api.Study(wl_t, device="cpu").run().sim_result(0)
    with pytest.raises(ValueError, match="keep_waveforms"):
        st.run(stream=2, resume="unused_dir")
