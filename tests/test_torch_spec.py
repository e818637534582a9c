"""The port's spectrum, spec metrics and verdicts, held against the JAX
reference on the same seeded waveforms: metrics within rtol 1e-4, flags
equal wherever the metric is not within that tolerance of its limit."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import spec as jspec  # noqa: E402
import importlib  # noqa: E402
from repro.core import waveform as jwf  # noqa: E402
from repro.core.phases import synthetic_timeline  # noqa: E402
from repro_torch.core import spec as tspec  # noqa: E402
from repro_torch.core import spectrum as tsp  # noqa: E402
from repro_torch.convert import from_reference_fields  # noqa: E402

# ``repro.core`` re-exports a function named ``spectrum`` over the module
jsp = importlib.import_module("repro.core.spectrum")

RTOL = 1e-4
# a spec metric compared with its limit
FLAG_METRIC = {"ramp_up": "max_ramp_up_w_per_s",
               "ramp_down": "max_ramp_down_w_per_s",
               "dynamic_range": "dynamic_range_w",
               "band_energy": "band_energy_fraction",
               "band_amplitude": "band_bin_amplitude_w"}
FLAG_LIMIT = {"ramp_up": "ramp_up_w_per_s",
              "ramp_down": "ramp_down_w_per_s",
              "dynamic_range": "dynamic_range_w",
              "band_energy": "max_energy_fraction",
              "band_amplitude": "max_bin_amplitude_w"}


def _waves(dt=0.01, steps=8, n_chips=(512.0, 2048.0, 256.0)):
    """Raw datacenter waveforms of three workloads (one length), plus a
    seeded noise floor so that no two metrics tie."""
    cfg = jwf.WaveformConfig(dt=dt, steps=steps, jitter_s=0.02)
    rng = np.random.default_rng(0)
    out = []
    for i, (period, moe) in enumerate([(1.0, False), (1.0, True),
                                       (1.0, False)]):
        tl = synthetic_timeline(period, 0.25 + 0.05 * i, moe_notch=moe)
        chip = jwf.chip_waveform_jax(jwf.phase_levels(tl, cfg), dt)
        w = np.asarray(jwf.aggregate_jax(chip, n_chips[i],
                                         jwf.jitter_shifts(cfg, i, 64)))
        out.append(w + rng.normal(0, 1e-3 * w.mean(), w.shape))
    return np.stack(out).astype(np.float32), dt


def _specs(job_mw):
    specs = dict(jspec.example_specs(job_mw))
    specs["amp"] = dataclasses.replace(
        specs["moderate"], name="amp",
        freq=jspec.FrequencyDomainSpec((0.2, 3.0), 0.3,
                                       max_bin_amplitude_w=2e4))
    return specs


def test_critical_band_report_matches():
    w, dt = _waves()
    out = tsp.critical_band_report(torch.as_tensor(w), dt)
    for i in range(len(w)):
        ref = jsp.critical_band_report_jax(jnp.asarray(w[i]), dt)
        for k, v in ref.items():
            np.testing.assert_allclose(float(out[k][i]), float(v), rtol=RTOL,
                                       atol=1e-7, err_msg=k)
    np.testing.assert_allclose(
        tsp.band_amplitude_w(torch.as_tensor(w), dt, 0.2, 3.0).numpy(),
        [float(jsp.band_amplitude_w_jax(jnp.asarray(x), dt, 0.2, 3.0))
         for x in w], rtol=RTOL)


@pytest.mark.parametrize("name", ["lenient", "moderate", "tight", "amp"])
def test_spec_metrics_and_flags_match(name):
    w, dt = _waves()
    jsp_ = _specs(0.1)[name]
    tsp_ = from_reference_fields("UtilitySpec", dataclasses.asdict(jsp_))
    assert tsp_.limits() == pytest.approx(
        {k: float(v) for k, v in jsp_.limits().items()}, rel=0)
    ok, flags, metrics = tsp_.validate(torch.as_tensor(w), dt)
    lim = tsp_.limits()
    for i in range(len(w)):
        ok_j, flags_j, m_j = jsp_.validate_jax(jnp.asarray(w[i]), dt)
        assert set(m_j) == set(metrics)
        for k, v in m_j.items():
            np.testing.assert_allclose(float(metrics[k][i]), float(v),
                                       rtol=RTOL, err_msg=k)
        near = False
        for f, v in flags_j.items():
            mk = FLAG_METRIC[f]
            if mk in m_j and abs(float(m_j[mk]) - lim[FLAG_LIMIT[f]]) <= (
                    RTOL * abs(lim[FLAG_LIMIT[f]])):
                near = True
                continue
            assert bool(flags[f][i]) == bool(v), (f, i)
        if not near:
            assert bool(ok[i]) == bool(ok_j)
        rep = tspec.report_from_arrays(
            ok[i], {k: v[i] for k, v in flags.items()},
            {k: v[i] for k, v in metrics.items()})
        rep_j = jspec.report_from_arrays(ok_j, flags_j, m_j)
        assert rep.violations == rep_j.violations or near


def test_example_specs_and_family_match():
    for name, js in jspec.example_specs(3.5).items():
        ts = tspec.example_specs(3.5)[name]
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
        assert dataclasses.asdict(ts.family()) == dataclasses.asdict(
            js.family())


def test_ramp_of_a_smoothed_trace_follows_the_float64_oracle():
    """The ramp box filter of a smoothed trace: the port's float64 prefix
    sums agree with a float64 numpy oracle to 1e-6; the reference's
    float32 convolution is off by up to its float32 resolution
    (4 ulp of the trace mean per sample step), which on a flat
    megawatt trace is a large share of the ramp itself."""
    dt, n, k = 0.01, 3000, 10
    t = np.arange(n) * dt
    w = (5e6 + 300.0 * np.sin(2 * np.pi * 0.05 * t)).astype(np.float32)
    spec = jspec.example_specs(5.0)["moderate"]
    ts = from_reference_fields("UtilitySpec", dataclasses.asdict(spec))
    _, _, m = ts.validate(torch.as_tensor(w)[None], dt)
    w64 = w.astype(np.float64)
    dp = np.diff(np.convolve(w64, np.ones(k) / k, mode="valid")) / dt
    np.testing.assert_allclose(float(m["max_ramp_up_w_per_s"][0]),
                               dp.max(), rtol=1e-6)
    np.testing.assert_allclose(float(m["max_ramp_down_w_per_s"][0]),
                               -dp.min(), rtol=1e-6)
    _, _, mj = spec.validate_jax(jnp.asarray(w), dt)
    resolution = 4 * np.finfo(np.float32).eps * float(w64.mean()) / dt
    assert abs(float(mj["max_ramp_up_w_per_s"]) - dp.max()) <= resolution
