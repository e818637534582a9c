"""The port's training loss against the reference's on the CPU.

``loss_fn`` and its gradients against ``jax.value_and_grad`` of the
reference's ``loss_fn``, on reduced granite-3-8b, dbrx-132b and
deepseek-v2-lite-16b in f32, each with the chunked cross-entropy off and
on (B 2 x S 32, ``loss_chunk`` 8), and on reduced jamba-v0.1-52b and
rwkv6-3b (the plain selective scan and wkv loops under autograd) with it
off: the loss within 1e-5 relative, the
``ce`` and ``moe_aux`` metrics alike, and each leaf's gradient within
1e-4 of its max |g| (``lm_head`` and every leaf the loss reaches).  The
reference's params go through ``convert.params_from_reference`` (the
recurrent archs' are drawn by the port and handed to the reference).  The
MoE archs follow the routing rule: in f32, no token's experts may differ
between the port and the reference at a margin of 1e-5 or more (each MoE
layer's router input is taken on both sides).  Also ``_ce`` and
``Model.loss``, and the ballast's checksum against the reference's.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.core import ballast_inject as jballast  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.layers import rms_norm as jrms  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.configs import TrainConfig  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import ballast_inject as tballast  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.train.trainer import make_value_and_grad  # noqa: E402

ARCHS = ["granite-3-8b", "dbrx-132b", "deepseek-v2-lite-16b",
         "jamba-v0.1-52b", "rwkv6-3b"]
# the recurrent archs take the whole-sequence CE only: the chunked CE
# follows the backbone, whatever it is, and the others cover it
SSM_ARCHS = ("jamba-v0.1-52b", "rwkv6-3b")
B, S, CHUNK = 2, 32, 8
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # of each leaf's max |g|
NEAR_TIE = 1e-5          # f32: the widest margin a routing flip may have


def _cfgs(arch, chunk):
    return tuple(dataclasses.replace(m.reduced(m.get_config(arch)),
                                     loss_chunk=chunk)
                 for m in (jcfgs, tcfgs))


@functools.lru_cache(maxsize=None)
def _params(arch):
    jc, tc = _cfgs(arch, 0)
    if arch in SSM_ARCHS:
        # drawn by the port (the reference's init of jamba's stacked unit
        # takes seconds to trace) and handed to the reference as numpy
        tp = tmodel.init_params(0, tc, device="cpu")
        return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp), tp
    jp = jax.jit(lambda k: jmodel.init_params(k, jc))(jax.random.PRNGKey(0))
    return jp, params_from_reference(jax.tree.map(np.asarray, jp),
                                     device="cpu")


def _batch():
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, 256, (B, S)).astype(np.int32),
            "labels": rng.integers(0, 256, (B, S)).astype(np.int32)}


def _by_path(tree, path):
    for k in path:
        tree = tree[getattr(k, "key", getattr(k, "idx", None))]
    return tree


@functools.lru_cache(maxsize=None)
def _reference_router_inputs(arch):
    """Each MoE layer's router input in the reference (the loss's
    forward does not depend on the chunk), with the layer's router."""
    jc, _ = _cfgs(arch, 0)
    jp, _ = _params(arch)
    return jax.jit(lambda p, t: _router_inputs(jc, p, t))(
        jp, jnp.asarray(_batch()["tokens"]))


def _router_inputs(jc, jp, tokens):
    ctx = jmodel.Ctx(cfg=jc, positions=jnp.arange(tokens.shape[1]))
    x = jmodel._embed(jp, jc, {"tokens": tokens}, ctx)
    layers = list(zip(jc.prefix, jp["prefix"]))
    for r in range(jc.n_repeats):
        layers += [(spec, jax.tree.map(lambda a: a[r], jp["unit"][i]))
                   for i, spec in enumerate(jc.unit)]
    out = []
    for spec, p in layers:
        if spec.ffn == "moe":
            h, _ = jmodel._apply_mixer(
                spec, p["mix"], jrms(x, p["norm1"], jc.norm_eps), ctx)
            out.append((jrms(x + h, p["norm2"], jc.norm_eps),
                        p["ffn"]["router"]))
        x = jmodel.apply_layer(spec, p, x, ctx)[0]
    return out


@pytest.mark.parametrize("arch,chunk", [
    (a, c) for a in ARCHS for c in (0, CHUNK)
    if c == 0 or a not in SSM_ARCHS])
def test_loss_and_grads_match_jax_value_and_grad(arch, chunk, monkeypatch):
    jc, tc = _cfgs(arch, chunk)
    jp, tp = _params(arch)
    batch = _batch()
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, jc, b), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})

    seen = []
    orig = tmoe.moe_forward

    def record(p, x, cfg, ctx=None):
        seen.append(x.detach().reshape(-1, x.shape[-1]))
        return orig(p, x, cfg, ctx)

    monkeypatch.setattr(tmoe, "moe_forward", record)
    grad_fn = make_value_and_grad(tc, TrainConfig(remat="none"))
    (tl, tm), tg = grad_fn(tp, {k: torch.from_numpy(v)
                                for k, v in batch.items()})

    if tc.moe is not None:
        ref_in = _reference_router_inputs(arch)
        assert len(ref_in) == len(seen) > 0
        k = tc.moe.top_k
        for (jr, router), tx in zip(ref_in, seen):
            probs = np.asarray(jax.nn.softmax(
                jr.reshape(-1, tc.d_model) @ router, axis=-1))
            jidx = np.sort(np.argsort(-probs, 1, kind="stable")[:, :k], 1)
            _, _, tidx = tmoe.route(tx, torch.from_numpy(np.array(router)), k)
            flip = (jidx != np.sort(tidx.numpy(), 1)).any(1)
            top = -np.sort(-probs, 1)
            margin = top[:, k - 1] - top[:, k]
            assert (margin[flip] < NEAR_TIE).all(), margin[flip]
            assert not flip.any(), "a near tie flipped: the gradients differ"

    assert abs(tl.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    for name in ("ce", "moe_aux"):
        ref = float(jm[name])
        assert abs(tm[name].item() - ref) <= LOSS_RTOL * max(abs(ref), 1e-30)
    leaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(leaves) == len(jax.tree.leaves(tp))
    for path, g in leaves:
        g = np.asarray(g)
        got = _by_path(tg, path).numpy()
        assert got.shape == g.shape
        scale = np.abs(g).max()
        assert scale > 0, path
        assert np.abs(got - g).max() <= GRAD_TOL * scale, path


def test_chunked_and_whole_ce_take_the_references_branch():
    """The chunk rule ``chunk and S % chunk == 0 and S > chunk``: S 32 with
    chunk 32 or 12 takes the whole-sequence branch, chunk 8 the chunked
    one; the two branches agree within f32 reassociation."""
    _, tp = _params("granite-3-8b")
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    out = {}
    for chunk in (0, 8, 12, 32):
        _, tc = _cfgs("granite-3-8b", chunk)
        out[chunk] = tmodel.Model(tc).loss(tp, batch)[0]
    assert torch.equal(out[0], out[12]) and torch.equal(out[0], out[32])
    assert abs(out[8].item() - out[0].item()) <= 1e-6 * out[0].item()


def test_ce_matches_the_references():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(3, 5, 17)).astype(np.float32) * 4
    labels = rng.integers(0, 17, (3, 5)).astype(np.int32)
    ref = np.asarray(jmodel._ce(jnp.asarray(logits), jnp.asarray(labels)))
    got = tmodel._ce(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("gflops", [0.01, 0.2])
def test_ballast_checksum_equals_the_references(gflops):
    """``ballast_chain`` is ``max(int(g 1e9 / 2 d^3), 1)`` bf16 products:
    1 at 0.01 GFLOPs, 5 at 0.2; 0.999 rounds to 1 in bf16, so the chain
    multiplies by the identity and the checksum is 658.5625."""
    assert tballast.ballast_iters(gflops) == max(
        int(gflops * 1e9 / (2 * 256 ** 3)), 1)
    ref = float(jballast.ballast_chain(gflops))
    got = tballast.ballast_chain(gflops)
    assert got.dtype == torch.float32 and got.item() == ref == 658.5625
    loss = torch.tensor(3.14159)
    assert torch.equal(tballast.attach_ballast(loss, gflops), loss)
    assert tballast.attach_ballast(loss, 0.0) is loss
