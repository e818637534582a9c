"""Firefly and its telemetry in the port against the reference.

* ``TelemetrySource.measure_batch`` against ``measure_jax`` row by row,
  over sampling period, latency, noise and the boxcar: bit for bit, but
  the boxcar, which the port sums in float64 (ROADMAP queue C) and is
  held to the float64 oracle and to the reference within 2 float32 ulps.
* ``Firefly.apply_batch`` against ``Firefly.apply_jax`` row by row, with
  the reference's parameters as float32 scalars (as the engine stacks
  them), noise-free and noisy with per-row keys carried over from JAX:
  outputs equal except at most ``FLIPS`` samples a row (a one-ulp
  difference of a noise draw that crosses a 1 W rounding or ballast step,
  a flip of at most one step), aux within rel 1e-5.
* A hypothesis property: ``out <= tdp`` and ``out >= float32(w)`` hold
  exactly (the reference's own version fails at seed 0 on its
  float64-to-float32 cast, ROADMAP queue C).

Run as a script, it prints the samples where each case's output differs
from the reference's and the draws' largest ulp gap.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_firefly.py
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core  # noqa: E402
from repro.core.hardware import DEFAULT_HW  # noqa: E402
from repro_torch.convert import (from_reference_fields,  # noqa: E402
                                 key_from_reference)
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.smoothing import Firefly, apply_mitigation  # noqa: E402

DT = 0.001
ROWS = 3
FLIPS = 1           # samples a row that may take the other side of a step
AUX_RTOL = 1e-5


def _chip_rows(n_rows=ROWS):
    """Chip power rows: the reference's chip waveform of a 1 s dense
    timeline at 1 kHz, each row with its own small per-sample wiggle."""
    cfg = core.WaveformConfig(dt=DT, steps=2)
    chip = np.asarray(core.chip_waveform(core.synthetic_timeline(1.0, 0.3),
                                         cfg), np.float32)
    rng = np.random.default_rng(1)
    return (chip[None] + rng.normal(0, 2.0, (n_rows, chip.size))
            ).astype(np.float32)


def _jax_keys(n_rows=ROWS, root=0):
    return [jax.random.fold_in(jax.random.PRNGKey(root), r)
            for r in range(n_rows)]


def _port_keys(jkeys):
    return key_from_reference(np.stack(
        [np.asarray(jax.random.key_data(k)) for k in jkeys]))


TELEMETRY = {
    "default": {},
    "period_latency": dict(period_s=0.004, latency_s=0.006),
    "noisy": dict(period_s=0.002, latency_s=0.002, noise_w=20.0),
    "boxcar": dict(period_s=0.004, averaged=True, quantization_w=0.0),
    "boxcar_noisy": dict(period_s=0.005, averaged=True, noise_w=5.0),
}


@pytest.mark.parametrize("name", sorted(TELEMETRY))
def test_measure_batch_matches_measure_jax(name):
    kw = TELEMETRY[name]
    ref = core.TelemetrySource(**kw)
    port = from_reference_fields("TelemetrySource", dataclasses.asdict(ref))
    w = _chip_rows()
    jkeys = _jax_keys()
    want = np.stack([np.asarray(ref.measure_jax(jnp.asarray(w[r]), DT,
                                                key=jkeys[r]))
                     for r in range(ROWS)])
    got = port.measure_batch(torch.tensor(w), DT, _port_keys(jkeys)).numpy()
    assert got.dtype == np.float32 and got.shape == w.shape
    if not port.averaged:
        assert np.array_equal(got, want)
        return
    # the boxcar: the port's float64 prefix sums against a float64 oracle
    # and the reference's float32 convolution
    k = int(round(port.period_s / DT))
    if port.noise_w == 0 and port.quantization_w == 0:
        box = np.stack([np.convolve(r.astype(np.float64), np.ones(k) / k)
                        [:w.shape[1]] for r in w])
        idx = np.clip((np.arange(w.shape[1]) // k) * k
                      - int(round(port.latency_s / DT)), 0, w.shape[1] - 1)
        oracle = box[:, idx]
        assert np.abs(got - oracle).max() <= np.spacing(
            np.float32(oracle.max())) / 2
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert (np.abs(got - want) <= 2 * ulp).all()
    else:
        # quantized to 1 W: equal but where the two boxcars round a sample
        # across a half watt
        assert (got != want).sum() <= FLIPS * ROWS
        assert np.abs(got - want).max() <= port.quantization_w


def test_measure_batch_without_keys_draws_the_shared_key():
    ref = core.TelemetrySource(noise_w=10.0)
    port = from_reference_fields("TelemetrySource", dataclasses.asdict(ref))
    w = _chip_rows()
    got = port.measure_batch(torch.tensor(w), DT).numpy()
    for r in range(ROWS):
        want = np.asarray(ref.measure_jax(jnp.asarray(w[r]), DT))
        assert np.array_equal(got[r], want)
    # the same draw on every row: the noise is the row's offset from its
    # noise-free measurement
    clean = from_reference_fields("TelemetrySource", dataclasses.asdict(
        core.TelemetrySource(quantization_w=0.0)))
    noisy = from_reference_fields("TelemetrySource", dataclasses.asdict(
        core.TelemetrySource(noise_w=10.0, quantization_w=0.0)))
    flat = torch.full((2, 500), 400.0)
    d = noisy.measure_batch(flat, DT) - clean.measure_batch(flat, DT)
    assert torch.equal(d[0], d[1]) and d.abs().max() > 0


FIREFLIES = {
    "default": {},
    "ff90": dict(engage_frac=0.90, threshold_frac=0.85),
    "noisy": dict(telemetry=core.TelemetrySource(
        period_s=0.002, latency_s=0.002, noise_w=20.0)),
    "noisy_averaged": dict(engage_frac=0.8, threshold_frac=0.75,
                           telemetry=core.TelemetrySource(
                               period_s=0.004, latency_s=0.004,
                               noise_w=8.0, averaged=True)),
}


def _as_engine_row(ff):
    """The reference's Firefly with its per-row parameters as float32
    scalars, as the engine stacks them for a batch."""
    return dataclasses.replace(
        ff, engage_frac=jnp.float32(ff.engage_frac),
        threshold_frac=jnp.float32(ff.threshold_frac),
        interference=jnp.float32(ff.interference))


@pytest.mark.parametrize("name", sorted(FIREFLIES))
def test_firefly_matches_apply_jax(name):
    ref = core.Firefly(**FIREFLIES[name])
    port = from_reference_fields("Firefly", dataclasses.asdict(ref))
    assert isinstance(port, Firefly)
    w = _chip_rows()
    jkeys = _jax_keys(root=4)
    got, aux = apply_mitigation([port] * ROWS, torch.tensor(w), DT,
                                _port_keys(jkeys))
    got = got.numpy()
    step = ref.engage_frac * ref.hw.chip.tdp_w / ref.ballast_steps
    engaged = 0
    for r in range(ROWS):
        out, raux = _as_engine_row(ref).apply_jax(jnp.asarray(w[r]), DT,
                                                  key=jkeys[r])
        out = np.asarray(out)
        diff = np.abs(got[r] - out)
        assert (diff > 0).sum() <= FLIPS, (name, r, (diff > 0).sum())
        assert diff.max() <= step * 1.0001, (name, r, diff.max())
        engaged += int((got[r] > w[r]).sum())
        for k, v in raux.items():
            v = float(v)
            assert abs(float(aux[k][r]) - v) <= AUX_RTOL * abs(v) + 1e-7, (
                name, k, float(aux[k][r]), v)
    assert engaged > 0, "the ballast never engaged"


def test_firefly_rows_draw_their_own_noise():
    port = from_reference_fields("Firefly", dataclasses.asdict(
        core.Firefly(**FIREFLIES["noisy"])))
    w = torch.tensor(_chip_rows(1)).expand(2, -1).contiguous()
    keys = prng.fold_in(prng.prng_key(0), torch.arange(2))
    a, _ = apply_mitigation([port] * 2, w, DT, keys)
    b, _ = apply_mitigation([port] * 2, w, DT, keys)
    assert torch.equal(a, b)
    assert not torch.equal(a[0], a[1])
    shared, _ = apply_mitigation([port] * 2, w, DT)
    assert torch.equal(shared[0], shared[1])


def test_firefly_relaxed_raises():
    """The relaxed Firefly runs now (it raised before the design path was
    ported): its forward on one row equals the reference's relaxed
    forward (tests/test_torch_relaxed_scans.py holds its gradient)."""
    w = (np.repeat(np.random.default_rng(9).uniform(
        DEFAULT_HW.chip.idle_w, DEFAULT_HW.chip.tdp_w, 10), 40)
         ).astype(np.float32)
    out, _ = apply_mitigation([Firefly(smooth_tau=0.1)],
                              torch.tensor(w[None]), DT)
    ref, _ = core.Firefly(smooth_tau=0.1).apply_jax(jnp.asarray(w), DT)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5 * DEFAULT_HW.chip.tdp_w)


def _wave(seed, n=4000):
    rng = np.random.default_rng(seed)
    levels = rng.uniform(DEFAULT_HW.chip.idle_w, DEFAULT_HW.chip.tdp_w, 8)
    return np.repeat(levels, n // 8)[:n].astype(np.float64)


def test_firefly_never_exceeds_tdp_nor_reduces_power():
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=25, deadline=None)
    @hypothesis.given(st.integers(0, 2 ** 31 - 1),
                      st.sampled_from([0.0, 20.0]))
    def prop(seed, noise_w):
        _check_bounds(seed, noise_w)

    prop()


def _check_bounds(seed, noise_w):
    w = torch.tensor(_wave(seed))
    ff = Firefly(telemetry=from_reference_fields("TelemetrySource", {
        "noise_w": noise_w}))
    out, _ = apply_mitigation([ff], w[None], DT,
                              prng.prng_key(seed)[None])
    tdp = torch.tensor(DEFAULT_HW.chip.tdp_w, dtype=torch.float32)
    assert out.dtype == torch.float32
    assert bool((out <= tdp).all())
    assert bool((out[0] >= w.to(torch.float32)).all())


if __name__ == "__main__":
    # the readings behind ROADMAP queue C: samples where the port's
    # Firefly differs from the reference's, and the draws' ulp gaps
    w = _chip_rows()
    jkeys = _jax_keys(root=4)
    z_ulps = max(int(np.abs(
        prng.normal(_port_keys(jkeys)[r], w.shape[1]).numpy().view(np.int32)
        .astype(np.int64) - np.asarray(jax.random.normal(
            jkeys[r], (w.shape[1],))).view(np.int32).astype(np.int64)).max())
        for r in range(ROWS))
    print(f"normal draws of {ROWS} rows x {w.shape[1]}: at most {z_ulps} "
          "float32 ulps from jax.random.normal")
    for name in sorted(FIREFLIES):
        ref = core.Firefly(**FIREFLIES[name])
        port = from_reference_fields("Firefly", dataclasses.asdict(ref))
        got, _ = apply_mitigation([port] * ROWS, torch.tensor(w), DT,
                                  _port_keys(jkeys))
        flips = sum(int((got[r].numpy() != np.asarray(
            _as_engine_row(ref).apply_jax(jnp.asarray(w[r]), DT,
                                          key=jkeys[r])[0])).sum())
            for r in range(ROWS))
        print(f"{name:16s} samples that differ from apply_jax: {flips} of "
              f"{w.size}")
