"""The port's warm start (``core/spectrum.goertzel_bin_amplitudes``, the
host waveform, ``serve/warmstart.py``, ``train/trainer.py`` and
``convert.predictor_from_reference``) against the reference on the CPU,
on the same numpy inputs, at the reference tests' sizes.

Tolerances: ``goertzel_bin_amplitudes``, ``extract_features`` and the
host waveform (float64 numpy copies of the reference's) equal it bit for
bit; the float32 torch mirror of the Goertzel sums within 1e-5 of the jax
mirror, relative to max |.|; ``warmstart_forward`` and the predictor's
seeds within 1e-6 relative (one predictor carried across, two libraries'
float32 matmuls and tanh); ``make_regression_train_step`` after 1 and 20
steps from the same params and batches within 1e-5 of the reference's
params, absolute (they are O(1)); a checkpoint written by one package and
read by the other predicts what its writer predicts within 1e-6
relative, and bit for bit within one package; ``design(method=
"warmstart")`` with the carried predictor picks the same tier, MPF and
capacity as the reference, the predicted battery horizon within 1e-6.
"""
import json

import jax
import numpy as np
import pytest
import torch

import repro.core as core
from repro.core import engine as rengine
from repro.core.spectrum import (goertzel_bin_amplitudes as r_goertzel,
                                 goertzel_bin_amplitudes_jax as r_goertzel_jax)
from repro.serve import warmstart as rws
from repro.train.trainer import make_regression_train_step as r_step
from repro_torch import api
from repro_torch.convert import predictor_from_reference
from repro_torch.core import engine
from repro_torch.core.optim import adam_init
from repro_torch.core.spectrum import (GRID_CRITICAL_HZ,
                                       goertzel_bin_amplitudes,
                                       goertzel_bin_amplitudes_torch)
from repro_torch.core.waveform import aggregate_host, chip_waveform_host
from repro_torch.serve import warmstart as ws
from repro_torch.train import make_regression_train_step

N_CHIPS = 512
MIRROR_RTOL = 1e-5
PREDICT_RTOL = 1e-6
STEP_ATOL = 1e-5


def _problem(spec_name="moderate", period_s=1.0, comm_frac=0.3, dt=0.01,
             steps=3):
    """The reference tests' toy problem: the host waveform of both packages
    (equal bit for bit) and each package's spec."""
    tl_r = core.synthetic_timeline(period_s=period_s, comm_frac=comm_frac)
    cfg_r = core.WaveformConfig(dt=dt, steps=steps, jitter_s=dt)
    w_r = core.aggregate(core.chip_waveform(tl_r, cfg_r), N_CHIPS, cfg_r)
    tl = api.synthetic_timeline(period_s=period_s, comm_frac=comm_frac)
    cfg = api.WaveformConfig(dt=dt, steps=steps, jitter_s=dt)
    w = aggregate_host(chip_waveform_host(tl, cfg), N_CHIPS, cfg)
    job_mw = float(w.mean()) / 1e6
    return (w, w_r, dt, api.example_specs(job_mw)[spec_name],
            core.example_specs(job_mw)[spec_name])


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# -- the spectral fingerprint -----------------------------------------------

def test_goertzel_bit_for_bit_and_pure_tone():
    rng = np.random.default_rng(0)
    x = 1e8 + 1e6 * rng.normal(size=3000)
    assert np.array_equal(goertzel_bin_amplitudes(x, 0.004),
                          r_goertzel(x, 0.004))
    dt, n, amp, f0 = 0.002, 4000, 3e5, 2.0
    tone = 5e8 + amp * np.sin(2 * np.pi * f0 * np.arange(n) * dt)
    amps = goertzel_bin_amplitudes(tone, dt)
    i0 = GRID_CRITICAL_HZ.index(f0)
    assert amps[i0] == pytest.approx(amp, rel=0.02)
    assert np.delete(amps, i0).max() < 0.1 * amp
    assert goertzel_bin_amplitudes(np.zeros(0), dt).shape == (7,)


@pytest.mark.parametrize("seed, n, dt", [(0, 3000, 0.004), (1, 1501, 0.01)])
def test_goertzel_torch_mirror_matches_jax_mirror(seed, n, dt):
    x = (1e8 + 1e6 * np.random.default_rng(seed).normal(size=n)).astype(
        np.float32)
    got = goertzel_bin_amplitudes_torch(torch.as_tensor(x), dt).numpy()
    ref = np.asarray(r_goertzel_jax(x, dt, GRID_CRITICAL_HZ))
    assert got.dtype == np.float32
    assert _rel(got, ref) <= MIRROR_RTOL


def test_host_waveform_and_features_bit_for_bit():
    for name in ("lenient", "moderate", "tight"):
        w, w_r, dt, spec, spec_r = _problem(name)
        assert w.dtype == np.float64 and np.array_equal(w, w_r)
        f = ws.extract_features(spec, w, dt, N_CHIPS)
        f_r = rws.extract_features(spec_r, w_r, dt, N_CHIPS)
        assert f.dtype == np.float32 and np.array_equal(f, f_r)
        assert f.shape == (len(ws.FEATURE_NAMES),) and np.isfinite(f).all()
        swing = float(w.max() - w.min())
        assert float(ws.swings_from_features(f[None])[0]) == pytest.approx(
            swing, rel=1e-3)
    assert ws.FEATURE_NAMES == rws.FEATURE_NAMES


# -- the model, carried across ----------------------------------------------

def _toy_dataset(w, dt, spec, extract=ws.extract_features):
    f = extract(spec, w, dt, N_CHIPS)
    rng = np.random.default_rng(0)
    X = np.tile(f, (48, 1)) + rng.normal(0, 0.01, (48, len(f))).astype(
        np.float32)
    X[0] = f
    swing = float(w.max() - w.min())
    Y = np.tile(np.asarray([0.7, swing * 1.2, 15.0], np.float32), (48, 1))
    return f, X, Y


@pytest.fixture(scope="module")
def trained():
    """The reference's predictor trained on the toy dataset (its test's
    200 epochs), carried to the port."""
    w, w_r, dt, spec, spec_r = _problem()
    f, X, Y = _toy_dataset(w_r, dt, spec_r, rws.extract_features)
    ref, _ = rws.train_warmstart(X, Y, epochs=200, batch_size=24, seed=0)
    return {"w": w, "dt": dt, "spec": spec, "spec_r": spec_r, "f": f,
            "X": X, "ref": ref,
            "port": predictor_from_reference(ref, device="cpu")}


def test_forward_and_predictor_match_reference(trained):
    ref, port = trained["ref"], trained["port"]
    x = np.random.default_rng(3).normal(size=(5, ws.N_FEATURES)).astype(
        np.float32)
    got = ws.warmstart_forward(port.params, torch.as_tensor(x)).numpy()
    want = np.asarray(rws.warmstart_forward(ref.params, x))
    assert _rel(got, want) <= PREDICT_RTOL
    assert _rel(port.predict_normalized(trained["X"]),
                ref.predict_normalized(trained["X"])) <= PREDICT_RTOL
    w, dt = trained["w"], trained["dt"]
    got = port(trained["spec"], w, dt, N_CHIPS)[0]
    want = ref(trained["spec_r"], w, dt, N_CHIPS)[0]
    assert _rel(got, want) <= PREDICT_RTOL
    # the reference's own check: it predicts its training point
    mpf, cap, tau = got
    assert mpf == pytest.approx(0.7, abs=0.08)
    assert cap == pytest.approx(float(w.max() - w.min()) * 1.2, rel=0.15)
    assert tau == pytest.approx(15.0, abs=3.0)


@pytest.mark.parametrize("steps", [1, 20])
def test_regression_step_matches_reference(trained, steps):
    """One and twenty Adam steps from the reference's trained params on
    the same batches (weight decay on, the gradient clipped)."""
    ref = trained["ref"]
    X = trained["X"]
    rng = np.random.default_rng(7)
    Y = rng.normal(size=(len(X), ws.N_TARGETS)).astype(np.float32)
    norm_r = ref.norm
    norm = {k: torch.tensor(np.asarray(v)) for k, v in norm_r.items()}

    def fwd_r(p, x):
        return rws.warmstart_forward(p, (x - norm_r["mean"]) / norm_r["std"])

    def fwd(p, x):
        return ws.warmstart_forward(p, (x - norm["mean"]) / norm["std"])

    kw = dict(lr=3e-3, weight_decay=1e-4, grad_clip=0.5)
    step_r = r_step(fwd_r, **kw)
    step = make_regression_train_step(fwd, device="cpu", **kw)
    from repro.core.optim import adam_init as r_adam_init
    p_r, o_r = ref.params, r_adam_init(ref.params)
    p = predictor_from_reference(ref, device="cpu").params
    o = adam_init(p)
    for i in range(steps):
        sel = rng.permutation(len(X))[:24]
        p_r, o_r, m_r = step_r(p_r, o_r, X[sel], Y[sel])
        p, o, m = step(p, o, X[sel], Y[sel])
        assert float(m["loss"]) == pytest.approx(float(m_r["loss"]),
                                                 rel=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(
            float(m_r["grad_norm"]), rel=1e-4)
    flat_r = jax.tree_util.tree_flatten_with_path(p_r)[0]
    for path, leaf in flat_r:
        keys = [k.key for k in path]
        got = p
        for k in keys:
            got = got[k]
        assert np.abs(got.numpy() - np.asarray(leaf)).max() <= STEP_ATOL, \
            keys


def test_port_training_decreases_loss_and_predicts_training_point():
    w, _, dt, spec, _ = _problem()
    f, X, Y = _toy_dataset(w, dt, spec)
    pred, hist = ws.train_warmstart(X, Y, epochs=200, batch_size=24, seed=0,
                                    device="cpu")
    assert hist["loss"][-1] < 0.01 * hist["loss"][0]
    mpf, cap, tau = pred(spec, w, dt, N_CHIPS, features=f)[0]
    assert mpf == pytest.approx(0.7, abs=0.08)
    assert cap == pytest.approx(float(Y[0, 1]), rel=0.15)
    assert tau == pytest.approx(15.0, abs=3.0)
    assert pred.meta["n_train"] == 48 and pred.meta["feature_names"] == list(
        ws.FEATURE_NAMES)


# -- checkpoints, both ways -------------------------------------------------

def test_checkpoints_cross_read(trained, tmp_path):
    ref, X = trained["ref"], trained["X"]
    ref.save(str(tmp_path / "ref"))
    got = ws.WarmStartPredictor.load(str(tmp_path / "ref"), device="cpu")
    assert got.meta == json.loads(json.dumps(ref.meta))
    assert _rel(got.predict_normalized(X),
                ref.predict_normalized(X)) <= PREDICT_RTOL

    port, _ = ws.train_warmstart(X, np.abs(X[:, :3]) + 0.5, epochs=3,
                                 batch_size=24, seed=1, device="cpu")
    port.save(str(tmp_path / "port"))
    back = rws.WarmStartPredictor.load(str(tmp_path / "port"))
    assert _rel(back.predict_normalized(X),
                port.predict_normalized(X)) <= PREDICT_RTOL
    again = ws.WarmStartPredictor.load(str(tmp_path / "port"), device="cpu")
    np.testing.assert_array_equal(again.predict_normalized(X),
                                  port.predict_normalized(X))
    assert again.meta == json.loads(json.dumps(port.meta))


# -- the design path with the carried predictor -----------------------------

def test_design_warmstart_matches_reference(trained):
    w, dt = trained["w"], trained["dt"]
    ref = rengine.design(trained["spec_r"], w, dt, N_CHIPS,
                         method="warmstart", warmstart=trained["ref"])
    got = engine.design(trained["spec"], w, dt, N_CHIPS, method="warmstart",
                        warmstart=trained["port"], device="cpu")
    assert got["report"].ok and ref["report"].ok
    assert got["aux"]["warmstart_path"] == ref["aux"]["warmstart_path"]
    assert got["mpf_frac"] == ref["mpf_frac"]
    assert got["battery_capacity_j"] == ref["battery_capacity_j"]
    # the predicted horizon itself is one float32 forward of each package
    assert got["target_tau_s"] == pytest.approx(ref["target_tau_s"],
                                                rel=PREDICT_RTOL)
