"""The port's mixture-of-experts FFN against the reference's on the CPU.

``reduced`` dbrx-132b (4 experts top-2) and deepseek-v2-lite-16b (4
experts top-2 and 2 shared experts), the reference's ``init_moe`` params
carried over by ``convert.params_from_reference``, the same numpy inputs
through ``moe_forward`` and ``moe_forward_ref`` of both packages: in the
reduced config's capacity (8.0, no drops), dropless (the decode's
``Ctx``) and with ``capacity_factor`` 0.5, where every expert drops
tokens.  Outputs within rel 1e-4 of max |reference| in f32 and 2^-5 in
bf16 (the params and the input in bf16, as dbrx serves); the aux within
1e-4 relative in both.  The routing itself (experts and their order) is
equal, ties included: the port's stable sort keeps the lower index, as
``jax.lax.top_k`` does.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import Ctx as JCtx  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.model import Ctx as TCtx  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -5}
AUX_TOL = 1e-4
ARCHS = ["dbrx-132b", "deepseek-v2-lite-16b"]
B, S = 2, 48


def _cfgs(arch, capacity_factor=None):
    jc, tc = (m.reduced(m.get_config(arch)) for m in (jcfgs, tcfgs))
    if capacity_factor is not None:
        jc, tc = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor)) for c in (jc, tc))
    return jc, tc


@functools.lru_cache(maxsize=None)
def _setup(arch, dtype, capacity_factor=None, seed=0):
    jc, tc = _cfgs(arch, capacity_factor)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jc, jnp.dtype(dtype))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(seed).standard_normal(
        (B, S, jc.d_model), dtype=np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jc, tc, jp, tp, jx, tx


def _close(got, ref, tol):
    got = got.float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    gap = np.abs(got - ref).max()
    assert gap <= tol * np.abs(ref).max(), (gap, np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["capacity", "dropless", "drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_reference(arch, mode, dtype):
    cf = 0.5 if mode == "drops" else None
    jc, tc, jp, tp, jx, tx = _setup(arch, dtype, cf)
    dropless = mode == "dropless"
    jctx = JCtx(cfg=jc, dropless=dropless)
    ref, ref_aux = jax.jit(lambda p, x: jmoe.moe_forward(p, x, jc, jctx))(
        jp, jx)
    got, aux = tmoe.moe_forward(tp, tx, tc, TCtx(cfg=tc, dropless=dropless))
    assert got.dtype == tx.dtype and aux.dtype == torch.float32
    _close(got, ref, TOL[dtype])
    assert abs(float(aux) - float(ref_aux)) <= AUX_TOL * abs(float(ref_aux))
    _, _, idx = tmoe.route(tx.reshape(-1, tc.d_model), tp["router"],
                           tc.moe.top_k)
    counts = np.bincount(idx.numpy().ravel(), minlength=tc.moe.n_experts)
    C = tmoe.capacity(tc, B * S, dropless)
    if mode == "drops":
        # every expert is over its capacity: the drops are what is tested
        assert counts.min() > C, (counts, C)
    else:
        assert counts.max() <= C


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_ref_matches_reference(arch, dtype):
    jc, tc, jp, tp, jx, tx = _setup(arch, dtype)
    _close(tmoe.moe_forward_ref(tp, tx, tc),
           jax.jit(lambda p, x: jmoe.moe_forward_ref(p, x, jc))(jp, jx),
           TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_dropless_equals_the_plain_version(arch):
    """moe_forward with no drop is the every-expert-on-every-token sum."""
    _, tc, _, tp, _, tx = _setup(arch, "float32")
    got, _ = tmoe.moe_forward(tp, tx, tc, TCtx(cfg=tc, dropless=True))
    ref = tmoe.moe_forward_ref(tp, tx, tc)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_equals_the_references(arch):
    jc, tc, jp, tp, jx, tx = _setup(arch, "float32")
    xt = np.array(jx).reshape(-1, jc.d_model)
    probs = jax.nn.softmax(jnp.asarray(xt) @ jp["router"], axis=-1)
    jgate, jidx = jax.lax.top_k(probs, jc.moe.top_k)
    _, gate, idx = tmoe.route(torch.from_numpy(xt), tp["router"],
                              tc.moe.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    jgate = jgate / jnp.maximum(jgate.sum(-1, keepdims=True), 1e-9)
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), rtol=1e-5)


def test_router_ties_keep_the_lower_index():
    """Tied probabilities: the reference's top_k keeps the lower expert
    index first, and so does the port.  Experts 1 and 3 share a router
    column, and a zero router ties every expert."""
    jc, tc = _cfgs("dbrx-132b")
    E, d, k = jc.moe.n_experts, jc.d_model, jc.moe.top_k
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, d), dtype=np.float32)
    router = rng.standard_normal((d, E), dtype=np.float32)
    router[:, 3] = router[:, 1]
    for r in (router, np.zeros_like(router)):
        probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(r), axis=-1)
        _, jidx = jax.lax.top_k(probs, k)
        _, _, idx = tmoe.route(torch.from_numpy(x), torch.from_numpy(r), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert (idx.numpy() == np.arange(k)).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_two_runs_are_equal_bit_for_bit(arch):
    _, tc, _, tp, _, tx = _setup(arch, "bfloat16", 0.5)
    a, aux_a = tmoe.moe_forward(tp, tx, tc, TCtx(cfg=tc))
    b, aux_b = tmoe.moe_forward(tp, tx, tc, TCtx(cfg=tc))
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


def test_reduced_moe_and_mla_are_the_references():
    for arch in ARCHS:
        jc, tc = _cfgs(arch)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.moe.capacity_factor == 8.0 and tc.moe.n_shared == 2
    assert tc.mla == tcfgs.MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                                     qk_rope_head_dim=8, v_head_dim=16)
