"""``CombinedMitigation`` and ``design_mitigation(method="grid")`` in the
port against the reference.

* ``CombinedMitigation`` (the GPU floor on ``w / n_chips``, re-aggregated,
  then the battery) on aggregate traces, row by row against
  ``apply_jax``: outputs within rel 1e-5 of max |w|, aux within rel 1e-4
  (its parameters stack as float32 in the port, as in the reference's
  engine, where a direct ``apply_jax`` rounds them from float64).
* ``design_mitigation`` on the control plane's 8 s history: the same
  winner, the same feasibility grid, and the serial confirmation's aux
  within rel 1e-4.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core  # noqa: E402
from repro.core.spec import example_specs as jspecs  # noqa: E402
from repro_torch import api, control  # noqa: E402
from repro_torch.convert import from_reference_fields  # noqa: E402
from repro_torch.core.smoothing import apply_mitigation  # noqa: E402
from repro_torch.core.smoothing.base import structure  # noqa: E402

DT = 0.01
N_CHIPS = 64
RTOL = 1e-4


def _aggregate(seed):
    cfg = core.WaveformConfig(dt=DT, steps=6, jitter_s=0.02)
    chip = core.chip_waveform(core.synthetic_timeline(1.5, 0.25,
                                                      moe_notch=True), cfg)
    return np.asarray(core.aggregate(chip, N_CHIPS, cfg, seed=seed),
                      np.float32)


def _combined(mpf, cap, swing):
    gpu = core.GpuPowerSmoothing(mpf_frac=mpf, ramp_up_w_per_s=2000,
                                 ramp_down_w_per_s=2000, stop_delay_s=0.3)
    bat = core.RackBattery(capacity_j=cap, max_discharge_w=swing,
                           max_charge_w=swing, switch_latency_s=0.02)
    return core.CombinedMitigation(gpu, bat, N_CHIPS)


# the reference's battery aux also holds its whole state-of-charge trace;
# kernel C gives the port its minimum and maximum only
NOT_IN_PORT = {"soc_trace"}


def _close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want) - NOT_IN_PORT, path
        for k in got:
            _close(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= RTOL * np.abs(want) + 1e-6), (
        path, got, want)


def test_combined_matches_apply_jax():
    rows = [_aggregate(s) for s in (0, 1, 2)]
    swing = float(rows[0].max() - rows[0].min())
    refs = [_combined(m, c * swing, swing)
            for m, c in ((0.6, 0.5), (0.75, 1.0), (0.9, 2.0))]
    port = [from_reference_fields("CombinedMitigation",
                                  dataclasses.asdict(m)) for m in refs]
    got, aux = apply_mitigation(port, torch.tensor(np.stack(rows)), DT)
    for r, (m, w) in enumerate(zip(refs, rows)):
        out, raux = m.apply_jax(jnp.asarray(w), DT)
        scale = float(np.abs(w).max())
        assert np.abs(got[r].numpy() - np.asarray(out)).max() <= 1e-5 * scale
        row_aux = {k: ({kk: vv[r] for kk, vv in v.items()}
                       if isinstance(v, dict) else v[r])
                   for k, v in aux.items()}
        _close(_numpy(row_aux), _numpy(raux))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def test_combined_structure_is_nested():
    """Rows batch together iff their nested GPU floors and batteries share
    a structure; ``n_chips`` and the stages' parameters are per row."""
    swing = 1e5
    a = from_reference_fields("CombinedMitigation", dataclasses.asdict(
        _combined(0.6, swing, swing)))
    b = dataclasses.replace(a, n_chips=2 * N_CHIPS,
                            gpu=dataclasses.replace(a.gpu, mpf_frac=0.9))
    assert structure(a) == structure(b)
    assert structure(a)[0] == "CombinedMitigation"
    c = dataclasses.replace(a, battery=dataclasses.replace(a.battery,
                                                           smooth_tau=0.5))
    assert structure(c) != structure(a)


def _history(peak_amp_w, t0=14.0, seconds=8.0, dt=0.002):
    w = control.synthesize_ramp(dt=dt, peak_amp_w=peak_amp_w)
    h = w[int(t0 / dt):int((t0 + seconds) / dt)]
    mean = float(h.mean())
    return (mean + 1.25 * (h - mean)).astype(np.float32)


@pytest.mark.parametrize("job_mw, n_chips, peak, name", [
    (500.0, 512, 8e7, "moderate"),        # the battery alone wins
    (5.0, 2_500_000, 2e8, "tight"),       # the GPU floor alone
    (5.0, 512, 2e8, "moderate"),          # the floor and a battery
])
def test_design_mitigation_matches_reference(job_mw, n_chips, peak, name):
    h = _history(peak)
    ref = core.design_mitigation(jspecs(job_mw)[name], h, 0.002, n_chips,
                                 method="grid")
    got = api.design_mitigation(api.example_specs(job_mw)[name], h, 0.002,
                                n_chips, method="grid", device="cpu")
    assert (got is None) == (ref is None)
    if ref is None:
        return
    assert (got["mpf_frac"], got["battery_capacity_j"]) == (
        ref["mpf_frac"], ref["battery_capacity_j"])
    np.testing.assert_array_equal(got["grid_ok"], ref["grid_ok"])
    assert abs(got["energy_overhead"] - ref["energy_overhead"]) <= 1e-6
    assert bool(got["aux"]) == bool(ref["aux"])
    _close(got["aux"], ref["aux"])
    if got["mpf_frac"] and got["battery_capacity_j"]:
        assert set(got["aux"]) == {"gpu", "battery", "energy_overhead"}


def test_design_mitigation_gradient_methods_raise():
    """The gradient methods pass through to ``engine.design``; only
    ``warmstart`` without a predictor raises, as in the reference."""
    h = _history(8e7)[:300]
    spec = api.example_specs(500.0)["moderate"]
    with pytest.raises(ValueError, match="warmstart"):
        api.design_mitigation(spec, h, 0.002, 512, method="warmstart",
                              device="cpu")
    for method in ("gradient", "hybrid"):
        sol = api.design_mitigation(spec, h, 0.002, 512, method=method,
                                    steps=1, device="cpu")
        assert sol is None or sol["method"] == method
