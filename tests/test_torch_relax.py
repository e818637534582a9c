"""The port's relaxation helpers (``core/smoothing/relax.py``) and its Adam
(``core/optim.py``) against the reference's, on the same numpy-seeded
inputs.

Values are float32 on both sides.  The helpers' exp, tanh and log1p are
two libraries' (XLA's and torch's), a few ulps apart: values within rtol
1e-6 plus 4 ulps of the largest (``smooth_max`` scales a logaddexp by
``tau * scale``, so its error is absolute), gradients against ``jax.grad`` within rtol 1e-5 plus 1e-6 of the
largest (``1 - tanh^2`` of a saturated gate is a difference of nearly
equal numbers).  Adam within rtol 1e-6 (``pow`` and ``sqrt`` of two
libraries), the norms within 2 ulps.  ``ste_ceil`` is the reference's bit for bit forward and the
identity backward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import optim as roptim
from repro.core.smoothing import relax as rrelax
from repro_torch.core import optim
from repro_torch.core.smoothing import relax

EPS = float(np.finfo(np.float32).eps)
RTOL = 2.4e-7     # two float32 ulps
GATE_RTOL = 1e-6
GRAD_RTOL = 1e-5


def _inputs(seed=0, n=64):
    rng = np.random.default_rng(seed)
    a = rng.normal(0.0, 500.0, n).astype(np.float32)
    b = rng.normal(0.0, 500.0, n).astype(np.float32)
    b[:4] = a[:4]                   # ties for smooth_max
    return a, b


@pytest.mark.parametrize("tau", [0.05, 0.5])
def test_gates_match_reference(tau):
    a, b = _inputs()
    scale = 700.0
    pairs = [(relax.sigmoid_gate(torch.tensor(a), tau, scale),
              rrelax.sigmoid_gate(jnp.asarray(a), tau, scale)),
             (relax.soft_sign(torch.tensor(a), tau, scale),
              rrelax.soft_sign(jnp.asarray(a), tau, scale)),
             (relax.smooth_max(torch.tensor(a), torch.tensor(b), tau, scale),
              rrelax.smooth_max(jnp.asarray(a), jnp.asarray(b), tau, scale))]
    for got, ref in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=GATE_RTOL,
                                   atol=4 * EPS * np.abs(ref).max())


@pytest.mark.parametrize("name", ["sigmoid_gate", "soft_sign", "smooth_max"])
def test_gate_gradients_match_jax_grad(name):
    a, b = _inputs(1)
    tau, scale = 0.1, 700.0
    fn_t, fn_r = getattr(relax, name), getattr(rrelax, name)
    if name == "smooth_max":
        ref = jax.grad(lambda x, y: jnp.sum(fn_r(x, y, tau, scale)),
                       argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
        x = torch.tensor(a, requires_grad=True)
        y = torch.tensor(b, requires_grad=True)
        fn_t(x, y, tau, scale).sum().backward()
        got = (x.grad, y.grad)
        # a tie splits the gradient in halves on both sides
        np.testing.assert_array_equal(got[0].numpy()[:4], 0.5)
    else:
        ref = (jax.grad(lambda x: jnp.sum(fn_r(x, tau, scale)))(
            jnp.asarray(a)),)
        x = torch.tensor(a, requires_grad=True)
        fn_t(x, tau, scale).sum().backward()
        got = (x.grad,)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=GRAD_RTOL,
                                   atol=1e-6 * np.abs(r).max())


def test_ste_ceil_forward_and_identity_backward():
    a, _ = _inputs(2)
    x = np.concatenate([a / 100.0, [1.0, 2.0, -1.0, 0.0, 1e-10]]).astype(
        np.float32)
    t = torch.tensor(x, requires_grad=True)
    out = relax.ste_ceil(t)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(rrelax.ste_ceil(jnp.asarray(x))))
    (out * torch.arange(len(x))).sum().backward()
    ref = jax.grad(lambda v: jnp.sum(rrelax.ste_ceil(v)
                                     * jnp.arange(len(x))))(jnp.asarray(x))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(ref))


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"mpf": rng.normal(0, 1, 5).astype(np.float32),
            "cap": rng.normal(0, 3, 5).astype(np.float32)}


def test_global_norm_and_clip_match_reference():
    g = _tree(3)
    ref_n = roptim.global_norm({k: jnp.asarray(v) for k, v in g.items()})
    got_n = optim.global_norm({k: torch.tensor(v) for k, v in g.items()})
    np.testing.assert_allclose(float(got_n), float(ref_n), rtol=RTOL)
    for max_norm in (0.5, 1e3):
        ref, rn = roptim.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
        got, gn = optim.clip_by_global_norm(
            {k: torch.tensor(v) for k, v in g.items()}, max_norm)
        np.testing.assert_allclose(float(gn), float(rn), rtol=RTOL)
        for k in g:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       rtol=RTOL, atol=1e-30)


def test_clip_by_global_norm_is_per_row():
    """With ``batch_dims=1`` each row is clipped over its own leaves, as the
    reference's vmap over starts does: one start's norm never scales
    another's gradient."""
    g = _tree(4)
    got, norms = optim.clip_by_global_norm(
        {k: torch.tensor(v) for k, v in g.items()}, 1.0, batch_dims=1)
    for s in range(5):
        ref, rn = roptim.clip_by_global_norm(
            {k: jnp.asarray(v[s]) for k, v in g.items()}, 1.0)
        np.testing.assert_allclose(float(norms[s]), float(rn), rtol=RTOL)
        for k in g:
            np.testing.assert_allclose(float(got[k][s]), float(ref[k]),
                                       rtol=RTOL, atol=1e-30)


def test_adam_matches_reference_over_steps():
    p, lr = _tree(5), 0.08
    ref_p = {k: jnp.asarray(v) for k, v in p.items()}
    got_p = {k: torch.tensor(v) for k, v in p.items()}
    ref_s, got_s = roptim.adam_init(ref_p), optim.adam_init(got_p)
    for step in range(6):
        g = _tree(10 + step)
        ref_p, ref_s = roptim.adam_update(
            ref_p, {k: jnp.asarray(v) for k, v in g.items()}, ref_s, lr)
        got_p, got_s = optim.adam_update(
            got_p, {k: torch.tensor(v) for k, v in g.items()}, got_s, lr)
        for k in p:
            np.testing.assert_allclose(got_p[k].numpy(),
                                       np.asarray(ref_p[k]), rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(got_s["v"][k].numpy(),
                                       np.asarray(ref_s["v"][k]), rtol=1e-6)
    assert got_s["count"] == int(ref_s["count"]) == 6


def test_adam_leaf_weight_decay_matches_reference():
    rng = np.random.default_rng(6)
    p, g, m, v = (rng.normal(0, 1, 8).astype(np.float32) for _ in range(4))
    v = np.abs(v)
    kw = dict(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    ref = roptim.adam_leaf(*(jnp.asarray(a) for a in (p, g, m, v)),
                           jnp.float32(3.0), **kw)
    got = optim.adam_leaf(*(torch.tensor(a) for a in (p, g, m, v)),
                          torch.tensor(3.0), **kw)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_per_sample_copies_sum_their_gradients_in_float64():
    """The step loops' per-sample parameter copies equal the parameters,
    and their gradients reach the parameters as a float64 sum (the port's
    own: a float32 running sum of 1e8, 1 and -1e8 would lose the 1)."""
    params = torch.tensor([[2.5, -3.0]], requires_grad=True)
    copies = relax.per_sample(params, 3)
    assert len(copies) == 3
    assert all(c.dtype == torch.float32 and torch.equal(c, params)
               for c in copies)
    coef = (1e8, 1.0, -1e8)
    loss = sum(k * c[:, 0] for k, c in zip(coef, copies)).sum()
    (g,) = torch.autograd.grad(loss, params)
    assert g.tolist() == [[1.0, 0.0]]
