"""Kernels J and K's plain versions (the relaxed GPU floor and battery,
``smooth_tau > 0``) and the relaxed backstop and Firefly, held against the
reference on the CPU.

* Forward against ``apply_jax``: within 4e-6 of max |out| (exp, tanh and
  log1p are two libraries' along the chain).
* Gradients with respect to the trace and to every field against
  ``jax.grad`` of the same loss: each within rtol 2e-4 plus 1e-5 of the
  largest (float32 sums over a few hundred steps in two orders).
  ``switch_latency_s`` carries no gradient on either side.
* The finite-difference checks of ``tests/test_design.py`` on the port
  (rel 0.05, or 0.1 where the reference allows it), on 4 s traces.
* ``tau -> 0`` converges to the hard path; ``tau == 0`` runs the hard
  kernels B and C (their plain versions here), never J or K.
* A tie: clips whose two sides are equal split the gradient in halves, as
  JAX's do (``torch.clamp`` would give all of it to one side).
* The backstop's gradient with respect to ``w``, through the monitor's
  worst-bin amplitude too, against ``jax.grad`` of the reference with its
  jnp monitor (unfused and fused), at the gradient tolerances above; the
  worst-bin amplitude's adjoint alone (``monitor_adjoint_plain``) against
  autograd of a float64 torch monitor, with ties and a zero bin.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as core
from repro_torch.core.hardware import DEFAULT_HW
from repro_torch.core.smoothing import (CombinedMitigation, Firefly,
                                        GpuPowerSmoothing, RackBattery,
                                        TelemetryBackstop, apply_mitigation)
from repro_torch.core.smoothing import battery as tbattery
from repro_torch.core.smoothing import gpu_floor as tgpu

DT = 0.002
TDP = DEFAULT_HW.chip.tdp_w
FWD_TOL = 4e-6        # of max |out|
GRAD_RTOL = 2e-4
GRAD_ATOL = 1e-5      # of max |grad|


def chip_square(period=2.0, duty=0.75, secs=4.0, dt=DT):
    lo = DEFAULT_HW.chip.comm_w
    t = np.arange(int(secs / dt)) * dt
    return np.where((t % period) < duty * period, TDP, lo).astype(np.float32)


def noisy(n, scale, seed, noise=0.03):
    rng = np.random.default_rng(seed)
    lv = np.repeat(rng.uniform(0.3, 1.0, n // 20 + 1), 20)[:n]
    return (scale * lv + scale * noise * rng.normal(size=n)).astype(
        np.float32)


def central_diff(f, x, eps):
    return (f(x + eps) - f(x - eps)) / (2.0 * eps)


def _port_apply(cls, fields, w, dt, tau, **static):
    """(out [n], leaf tensors) of the port's mitigation with every field a
    leaf tensor that requires grad."""
    leaves = {k: torch.tensor(float(v), requires_grad=True)
              for k, v in fields.items()}
    mit = cls(smooth_tau=tau, **leaves, **static)
    x = torch.tensor(w[None], requires_grad=True)
    out, _ = apply_mitigation([mit], x, dt)
    return out[0], x, leaves


def _check_against_jax(ref_cls, port_cls, fields, w, dt, tau, weight):
    ref = ref_cls(smooth_tau=tau, **fields)

    def loss(m, x):
        out, _ = m.apply_jax(x, dt)
        return jnp.sum(out * weight)

    ref_out, _ = ref.apply_jax(jnp.asarray(w), dt)
    g_mit, g_x = jax.grad(loss, argnums=(0, 1))(ref, jnp.asarray(w))
    out, x, leaves = _port_apply(port_cls, fields, w, dt, tau)
    ref_out = np.asarray(ref_out)
    np.testing.assert_allclose(out.detach().numpy(), ref_out, rtol=0,
                               atol=FWD_TOL * np.abs(ref_out).max())
    (out * torch.tensor(np.asarray(weight))).sum().backward()
    g_x = np.asarray(g_x)
    np.testing.assert_allclose(x.grad[0].numpy(), g_x, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL * np.abs(g_x).max())
    grads = {k: float(getattr(g_mit, k)) for k in fields}
    scale = max(abs(v) for v in grads.values())
    for k, leaf in leaves.items():
        got = 0.0 if leaf.grad is None else float(leaf.grad)
        assert got == pytest.approx(grads[k], rel=GRAD_RTOL,
                                    abs=GRAD_ATOL * scale), k
    return grads


GPU_FIELDS = dict(mpf_frac=0.7, ramp_up_w_per_s=2000.0,
                  ramp_down_w_per_s=1500.0, stop_delay_s=0.3,
                  activity_threshold_frac=0.4, edp_cap_frac=0.98)


@pytest.mark.parametrize("tau", [0.05, 0.2])
def test_gpu_floor_relaxed_matches_reference_and_jax_grad(tau):
    n, dt = 300, 0.01
    w = noisy(n, TDP, 0)
    weight = jnp.sin(jnp.arange(n) / 7.0)
    grads = _check_against_jax(core.GpuPowerSmoothing, GpuPowerSmoothing,
                               GPU_FIELDS, w, dt, tau, weight)
    # the relaxation gives the hard path's zero-gradient fields a gradient
    assert grads["stop_delay_s"] != 0.0
    assert grads["activity_threshold_frac"] != 0.0


BAT_FIELDS = {
    # capacity binds: the SoC saturates, the tapers engage
    "small": dict(capacity_j=300.0, max_discharge_w=300.0, max_charge_w=250.0,
                  efficiency=0.95, target_tau_s=1.0, initial_soc=0.5,
                  switch_latency_s=0.0),
    # a roomy battery with a three-sample mode-switch latency
    "roomy": dict(capacity_j=5e4, max_discharge_w=400.0, max_charge_w=400.0,
                  efficiency=0.9, target_tau_s=0.5, initial_soc=0.3,
                  switch_latency_s=0.03),
}


def square_load(n, dt, period_s=4.0, seed=1):
    """1 kW with a 300 W square swing of ``period_s``: the battery
    discharges and recharges for half a period at a time."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) * dt
    return (1e3 + 300.0 * np.sign(np.sin(2 * np.pi * t / period_s))
            + rng.normal(0, 2.0, n)).astype(np.float32)


@pytest.mark.parametrize("case", sorted(BAT_FIELDS))
def test_battery_relaxed_matches_reference_and_jax_grad(case):
    n, dt = 300, 0.01
    w = square_load(n, dt, period_s=2.0)
    weight = jnp.cos(jnp.arange(n) / 5.0)
    grads = _check_against_jax(core.RackBattery, RackBattery,
                               BAT_FIELDS[case], w, dt, 0.05, weight)
    assert grads["switch_latency_s"] == 0.0
    if case == "small":
        assert grads["capacity_j"] != 0.0 and grads["efficiency"] != 0.0


def test_relaxed_battery_aux_matches_reference():
    n, dt = 300, 0.01
    w = noisy(n, 1e3, 2)
    f = BAT_FIELDS["small"]
    _, ref = core.RackBattery(smooth_tau=0.05, **f).apply_jax(
        jnp.asarray(w), dt)
    _, got = apply_mitigation([RackBattery(smooth_tau=0.05, **f)],
                              torch.tensor(w[None]), dt)
    np.testing.assert_allclose(got["soc_trace"][0].numpy(),
                               np.asarray(ref["soc_trace"]), rtol=0,
                               atol=FWD_TOL * f["capacity_j"])
    for k in ("soc_min_frac", "soc_max_frac", "energy_overhead",
              "peak_reduction_w"):
        assert float(got[k][0]) == pytest.approx(float(ref[k]), rel=1e-5,
                                                 abs=1e-6), k


def test_relaxed_tie_splits_like_jax():
    """A saturated tanh (tau 0.005) with a one-sample switch latency makes
    the mode flip's clip hit its upper edge exactly (sw == 1) and the hold
    hit 1 exactly: ties in ``clip(-(mode' mode), 0, 1)`` and
    ``max(hold - 1, 0)``.  The plain version's gradient equals jax.grad's
    there, and a ``torch.clamp`` clip would not split the tie."""
    n, dt, tau = 200, 0.01, 0.005
    rng = np.random.default_rng(3)
    w = (1e3 + 300.0 * np.sign(np.sin(np.arange(n) / 3.0))
         + rng.normal(0, 5.0, n)).astype(np.float32)
    f = dict(BAT_FIELDS["roomy"], switch_latency_s=dt)
    # the carries the plain version walks through, recomputed here: count
    # the ties
    alpha = np.float32(dt / max(f["target_tau_s"], dt))
    tgt = np.float32(np.mean(w.astype(np.float64)))
    ps = np.float32(0.5 * (f["max_discharge_w"] + f["max_charge_w"]))
    nms = []
    for p in w:
        tgt = np.float32(tgt + alpha * np.float32(p - tgt))
        nms.append(np.tanh(np.float32(p - tgt) / np.float32(tau * ps)))
    nm = np.asarray(nms, np.float32)
    sw = np.clip(-(nm[1:] * nm[:-1]), 0.0, 1.0)
    assert int((sw == 1.0).sum()) >= 3
    _check_against_jax(core.RackBattery, RackBattery, f, w, dt, tau,
                       jnp.sin(jnp.arange(n) / 4.0))
    # torch.clamp gives a tie's whole gradient to the clipped value
    x = torch.tensor([1.0], requires_grad=True)
    torch.clamp(x, 0.0, 1.0).sum().backward()
    assert float(x.grad) == 1.0
    assert float(jax.grad(lambda v: jnp.clip(v, 0.0, 1.0))(1.0)) == 0.5


# ---------------------------------------------------------------------------
# the finite-difference checks of tests/test_design.py, on the port
# ---------------------------------------------------------------------------

def _loss_of(mit_fn, w, dt, reduce):
    def loss(v):
        out, _ = apply_mitigation([mit_fn(v)], w, dt)
        return reduce(out[0])
    return loss


def _grad_at(mit_fn, w, dt, reduce, v0):
    leaf = torch.tensor(v0, requires_grad=True)
    loss = _loss_of(mit_fn, w, dt, reduce)(leaf)
    loss.backward()
    return float(leaf.grad)


def test_gpu_floor_smooth_gradient_matches_fd():
    w = torch.tensor(chip_square()[None])
    gf = GpuPowerSmoothing(mpf_frac=0.7, ramp_up_w_per_s=2000,
                           ramp_down_w_per_s=2000, stop_delay_s=1.0,
                           smooth_tau=0.05)

    def mit(m):
        return dataclasses.replace(gf, mpf_frac=m)

    def reduce(out):
        return out.to(torch.float64).mean() / TDP

    g = _grad_at(mit, w, DT, reduce, 0.7)
    with torch.no_grad():
        fd = float(central_diff(_loss_of(mit, w, DT, reduce), 0.7, 0.01))
    assert g == pytest.approx(fd, rel=0.05)
    assert g > 0


def test_battery_smooth_gradient_matches_fd():
    w = torch.tensor(chip_square()[None] * 512)
    swing = float(w.max() - w.min())
    bat = RackBattery(capacity_j=0.2 * swing, max_discharge_w=swing,
                      max_charge_w=swing, target_tau_s=10.0, smooth_tau=0.05)
    mean = w.to(torch.float64).mean()

    def mit(c):
        return dataclasses.replace(bat, capacity_j=c * swing)

    def reduce(out):
        o = out.to(torch.float64)
        return torch.mean(torch.square((o - o.mean()) / mean))

    g = _grad_at(mit, w, DT, reduce, 0.2)
    with torch.no_grad():
        fd = float(central_diff(_loss_of(mit, w, DT, reduce), 0.2, 0.02))
    assert g == pytest.approx(fd, rel=0.1)
    assert g < 0


def test_firefly_smooth_gradient_matches_fd():
    w = torch.tensor(chip_square()[None])
    ff = Firefly(smooth_tau=0.05, ballast_steps=256)

    def mit(e):
        return dataclasses.replace(ff, engage_frac=e)

    def reduce(out):
        return out.to(torch.float64).mean() / TDP

    g = _grad_at(mit, w, DT, reduce, 0.85)
    with torch.no_grad():
        fd = float(central_diff(_loss_of(mit, w, DT, reduce), 0.85, 0.02))
    assert g == pytest.approx(fd, rel=0.1)
    assert g > 0


def test_firefly_relaxed_matches_reference_and_jax_grad():
    w = chip_square(secs=2.0)
    ref = core.Firefly(smooth_tau=0.05, ballast_steps=256)

    def loss(e):
        out, _ = dataclasses.replace(ref, engage_frac=e).apply_jax(
            jnp.asarray(w), DT)
        return jnp.mean(out) / TDP

    leaf = torch.tensor(0.85, requires_grad=True)
    out, _ = apply_mitigation(
        [Firefly(smooth_tau=0.05, ballast_steps=256, engage_frac=leaf)],
        torch.tensor(w[None]), DT)
    ref_out, _ = ref.apply_jax(jnp.asarray(w), DT)
    np.testing.assert_allclose(out[0].detach().numpy(), np.asarray(ref_out),
                               rtol=0, atol=FWD_TOL * TDP)
    (out[0].to(torch.float64).mean() / TDP).backward()
    assert float(leaf.grad) == pytest.approx(float(jax.grad(loss)(0.85)),
                                             rel=1e-4)


def test_backstop_off_path_gradient_is_zero_and_finite():
    w = torch.full((1, 4000), 5e8)
    bs = TelemetryBackstop(window_s=2.0, smooth_tau=0.05)

    def mit(t):
        return dataclasses.replace(bs, amp_threshold_w=t)

    def reduce(out):
        return out.to(torch.float64).mean() / 5e8

    g = _grad_at(mit, w, DT, reduce, 1e6)
    assert np.isfinite(g) and abs(g) < 1e-9
    with torch.no_grad():
        assert abs(float(central_diff(_loss_of(mit, w, DT, reduce), 1e6,
                                      1e4))) < 1e-9


def _escalating_trace(n=3000, dt=DT):
    t = np.arange(n) * dt
    return (5e8 + 2.5e6 * np.exp(-t / 4.0)
            * np.sin(2 * np.pi * 1.0 * t)).astype(np.float32)


def test_backstop_relaxed_forward_hard_and_gradients_match_reference():
    """On a trace that escalates: the port's relaxed forward is its hard
    forward bit for bit, and the gradients with respect to the four
    per-row fields match ``jax.grad`` of the reference (jnp monitor)."""
    w = _escalating_trace()
    kw = dict(window_s=2.0, sustain_s=0.5, amp_threshold_w=1e6)
    fields = dict(amp_threshold_w=1e6, alpha1=0.5, shed_frac=0.7,
                  idle_frac=0.2)
    hard, aux_h = apply_mitigation([TelemetryBackstop(**kw)],
                                   torch.tensor(w[None]), DT)
    assert int(aux_h["max_level"][0]) > 0
    out, x, leaves = _port_apply(TelemetryBackstop, fields, w, DT, 0.05,
                                 window_s=2.0, sustain_s=0.5)
    assert torch.equal(out.detach(), hard[0])
    ref = core.TelemetryBackstop(use_pallas=False, fused_scan=False,
                                 window_s=2.0, sustain_s=0.5,
                                 smooth_tau=0.05, **fields)
    weight = np.cos(np.arange(len(w)) / 9.0).astype(np.float32)

    def loss(m):
        o, _ = m.apply_jax(jnp.asarray(w), DT)
        return jnp.sum(o * weight) / 5e8

    g_ref = jax.grad(loss)(ref)
    (out.to(torch.float64) * torch.tensor(weight, dtype=torch.float64)
     ).sum().div(5e8).backward()
    for k in ("amp_threshold_w", "shed_frac", "idle_frac"):
        assert float(leaves[k].grad) == pytest.approx(
            float(getattr(g_ref, k)), rel=1e-3, abs=1e-12), k
    # alpha1's gradient is sum(weight (w - mean)) over the level-1 samples:
    # the port takes the mean in float64 (ROADMAP queue C), 43 W from the
    # reference's float32 mean here, which moves that sum by 0.5%; it is
    # held to the float64 sum of the port's terms at 1e-4 (autograd sums
    # them in float32) and to the reference at 1e-2
    lv = aux_h["levels"][0].numpy() == 1
    mean = np.float32(w.astype(np.float64).mean())
    exact = float(np.sum((weight.astype(np.float64) * (w - mean))[lv])
                  / 5e8)
    assert float(leaves["alpha1"].grad) == pytest.approx(exact, rel=1e-4)
    assert float(leaves["alpha1"].grad) == pytest.approx(
        float(g_ref.alpha1), rel=1e-2)


def backstop_w_gradients(held=False, fused_scan=False):
    """The port's and the reference's gradients of a weighted output with
    respect to ``w``; ``held`` holds the reference's monitor output fixed
    (``stop_gradient`` around its jnp monitor), ``fused_scan`` takes the
    reference's fused jnp mirror instead of its cumsum monitor."""
    import repro.core.smoothing.backstop as rbackstop
    w = _escalating_trace()
    fields = dict(amp_threshold_w=1e6, alpha1=0.5, shed_frac=0.7,
                  idle_frac=0.2)
    weight = jnp.asarray(np.cos(np.arange(len(w)) / 9.0), jnp.float32)
    ref = core.TelemetryBackstop(use_pallas=False, fused_scan=fused_scan,
                                 window_s=2.0, sustain_s=0.5,
                                 smooth_tau=0.05, **fields)
    monitor = rbackstop.sliding_bin_power_jnp
    if held:
        rbackstop.sliding_bin_power_jnp = (
            lambda *a, **k: jax.lax.stop_gradient(monitor(*a, **k)))
    try:
        g_ref = np.asarray(jax.grad(lambda x: jnp.sum(
            ref.apply_jax(x, DT)[0] * weight))(jnp.asarray(w)))
    finally:
        rbackstop.sliding_bin_power_jnp = monitor
    x = torch.tensor(w[None], requires_grad=True)
    out, _ = apply_mitigation(
        [TelemetryBackstop(window_s=2.0, sustain_s=0.5, smooth_tau=0.05,
                           **fields)], x, DT)
    (out[0] * torch.tensor(np.asarray(weight))).sum().backward()
    return x.grad[0].numpy(), g_ref


def test_backstop_w_gradient_through_the_monitor_is_detached():
    """The gradient with respect to ``w`` flows through the monitor's
    worst-bin amplitude on both sides, and the port's equals the
    reference's ``jax.grad`` (its cumsum jnp monitor, no
    ``stop_gradient``).  The name is kept from when the port's was detached
    (kernel A had no backward): with the reference's monitor held fixed the
    two now part."""
    g_port, g_ref = backstop_w_gradients()
    scale = np.abs(g_ref).max()
    np.testing.assert_allclose(g_port, g_ref, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL * scale)
    _, g_held = backstop_w_gradients(held=True)
    assert np.abs(g_port - g_held).max() > 0.01 * scale


def test_backstop_w_gradient_matches_the_fused_reference():
    """As above, against the reference's fused jnp mirror
    (``fused_scan=True``, ``use_pallas=False``)."""
    g_port, g_ref = backstop_w_gradients(fused_scan=True)
    np.testing.assert_allclose(g_port, g_ref, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL * np.abs(g_ref).max())


def _worst_f64(x, freqs, dt, win):
    """The worst-bin amplitude ``[B, n]`` in float64 torch ops, the formula
    of the monitor (centred, windowed DFT, 2 |S| / min(t + 1, win), max over
    bins), for autograd."""
    n = x.shape[-1]
    xc = x - x.mean(-1, keepdim=True)
    j = torch.arange(n, dtype=torch.float64)
    ph = torch.exp(-1j * 2.0 * torch.pi * torch.tensor(freqs, dtype=torch.float64)[:, None]
                   * dt * j[None, :])
    P = torch.cumsum(xc[:, None, :] * ph, -1)
    S = torch.cat([P[..., :win], P[..., win:] - P[..., :-win]], -1)
    amp = 2.0 * S.abs() / torch.clamp(j + 1.0, max=float(win))
    return amp.amax(1), amp.transpose(1, 2)


@pytest.mark.parametrize("case", ["noise", "ties", "zero"])
def test_monitor_adjoint_plain_matches_autograd(case):
    """``monitor_adjoint_plain`` against autograd of ``_worst_f64`` on three
    rows: noise; two bins at one frequency (every sample a tie, split in
    halves as torch's and JAX's max split it); a constant row (|S| = 0
    everywhere: no gradient)."""
    from repro_torch.kernels.goertzel.monitor import monitor_adjoint_plain
    dt, win, n = 0.01, 64, 300
    freqs = {"noise": (0.5, 1.0, 2.0, 9.0), "ties": (1.0, 1.0, 3.0),
             "zero": (1.0, 2.0)}[case]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, n)) * 1e3 + 5e5
    if case == "zero":
        x[:] = 5e5
    x = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    g = torch.tensor(rng.normal(size=(2, n)))
    worst, amps = _worst_f64(x, freqs, dt, win)
    (gw,) = torch.autograd.grad((worst * g).sum(), x)
    xc = (x - x.mean(-1, keepdim=True)).detach()
    got = monitor_adjoint_plain(xc.to(torch.float32), amps.detach().to(
        torch.float32), g.to(torch.float32), freqs, dt, win)
    scale = max(float(gw.abs().max()), 1e-30)
    np.testing.assert_allclose(got.numpy(), gw.numpy(), rtol=0,
                               atol=1e-5 * scale)
    if case == "zero":
        assert not got.any()


def test_monitor_worst_grad_off_path_launches_nothing(monkeypatch):
    """The hard backstop, and the relaxed one on a ``w`` that needs no
    gradient, never build the monitor's graph."""
    from repro_torch.kernels.goertzel import ops
    called = []
    monkeypatch.setattr(
        "repro_torch.core.smoothing.backstop.monitor_worst_grad",
        lambda *a, **k: called.append(1) or ops.monitor_worst_grad(*a, **k))
    w = torch.tensor(_escalating_trace()[None])
    apply_mitigation([TelemetryBackstop(window_s=2.0, sustain_s=0.5)], w, DT)
    apply_mitigation([TelemetryBackstop(window_s=2.0, sustain_s=0.5,
                                        smooth_tau=0.05)], w, DT)
    assert not called
    apply_mitigation([TelemetryBackstop(window_s=2.0, sustain_s=0.5,
                                        smooth_tau=0.05)],
                     w.clone().requires_grad_(True), DT)
    assert called


# ---------------------------------------------------------------------------
# tau -> 0, and tau == 0
# ---------------------------------------------------------------------------

def test_smooth_forward_converges_to_hard_as_tau_to_zero():
    w = torch.tensor(chip_square()[None])
    hard = GpuPowerSmoothing(mpf_frac=0.7, ramp_up_w_per_s=2000,
                             ramp_down_w_per_s=2000, stop_delay_s=1.0)
    out_h, _ = apply_mitigation([hard], w, DT)
    err = []
    for tau in (0.1, 0.01, 1e-4):
        out_s, _ = apply_mitigation(
            [dataclasses.replace(hard, smooth_tau=tau)], w, DT)
        err.append(float((out_s - out_h).abs().max()) / TDP)
    assert err[0] > err[-1]
    assert err[-1] < 1e-3

    wb = w * 512
    swing = float(wb.max() - wb.min())
    hard_bat = RackBattery(capacity_j=0.3 * swing, max_discharge_w=swing,
                           max_charge_w=swing, target_tau_s=10.0)
    out_h, _ = apply_mitigation([hard_bat], wb, DT)
    out_s, _ = apply_mitigation(
        [dataclasses.replace(hard_bat, smooth_tau=1e-4)], wb, DT)
    np.testing.assert_allclose(out_s.numpy(), out_h.numpy(), rtol=1e-4,
                               atol=1e-3 * swing)

    out_h, _ = apply_mitigation([Firefly()], w, DT)
    out_s, _ = apply_mitigation([Firefly(smooth_tau=1e-4)], w, DT)
    np.testing.assert_allclose(out_s.numpy(), out_h.numpy(), atol=1e-2 * TDP)


def test_tau_zero_is_the_hard_path_bitwise(monkeypatch):
    """``smooth_tau = 0`` runs the hard scans (kernels B and C) bit for
    bit, and never reaches J or K."""
    def boom(*_a, **_k):
        raise AssertionError("the relaxed scan ran on a smooth_tau == 0 path")

    monkeypatch.setattr(tgpu, "gpu_floor_relaxed", boom)
    monkeypatch.setattr(tbattery, "battery_relaxed", boom)
    w = torch.tensor(chip_square()[None])
    for hard in (GpuPowerSmoothing(mpf_frac=0.7, stop_delay_s=1.0),
                 RackBattery(capacity_j=1e5, max_discharge_w=1e5,
                             max_charge_w=1e5),
                 Firefly(), TelemetryBackstop(window_s=2.0)):
        out_h, _ = apply_mitigation([hard], w, DT)
        out_0, _ = apply_mitigation(
            [dataclasses.replace(hard, smooth_tau=0.0)], w, DT)
        assert torch.equal(out_h, out_0)
    gpu = GpuPowerSmoothing(mpf_frac=0.7, stop_delay_s=1.0)
    out, _ = apply_mitigation([gpu], w, DT)
    params = torch.stack([torch.tensor(0.7 * TDP),
                          torch.tensor(0.35 * TDP),
                          torch.tensor(np.float32(1000.0) * np.float32(DT)),
                          torch.tensor(np.float32(1000.0) * np.float32(DT)),
                          torch.tensor(np.float32(1.0) / np.float32(DT)),
                          torch.tensor(TDP)])[None].float()
    assert torch.equal(out, tgpu.gpu_floor_scan_plain(w, params))


def test_combined_smooth_gradient_matches_fd():
    n_chips = 64
    w = torch.tensor(chip_square()[None] * n_chips)
    swing = float(w.max() - w.min())
    gpu = GpuPowerSmoothing(mpf_frac=0.7, ramp_up_w_per_s=2000,
                            ramp_down_w_per_s=2000, stop_delay_s=1.0,
                            smooth_tau=0.05)
    bat = RackBattery(capacity_j=0.5 * swing, max_discharge_w=swing,
                      max_charge_w=swing, target_tau_s=10.0, smooth_tau=0.05)

    def mit(m):
        return CombinedMitigation(dataclasses.replace(gpu, mpf_frac=m), bat,
                                  n_chips)

    def reduce(out):
        return out.to(torch.float64).mean() / (TDP * n_chips)

    g = _grad_at(mit, w, DT, reduce, 0.7)
    with torch.no_grad():
        fd = float(central_diff(_loss_of(mit, w, DT, reduce), 0.7, 0.01))
    assert g == pytest.approx(fd, rel=0.05)


if __name__ == "__main__":
    gp, gr = backstop_w_gradients()
    _, gh = backstop_w_gradients(held=True)
    d = np.abs(gp - gr)
    print(f"backstop d/dw on a 6 s escalating trace, port (monitor "
          f"detached) vs reference (jnp monitor): max |diff| {d.max():.4g} "
          f"of max |ref| {np.abs(gr).max():.4g}, median {np.median(d):.4g};"
          f" against the reference with its monitor held: max |diff| "
          f"{np.abs(gp - gh).max():.4g}")
