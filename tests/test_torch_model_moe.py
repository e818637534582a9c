"""dbrx-132b and deepseek-v2-lite-16b in the port against the reference on
the CPU.

``reduced`` configs with 2 repeats (deepseek also with its dense prefix
layer) and ``chunk_size`` 32, the reference's params carried over by
``convert.params_from_reference``.  In f32, within rel 1e-4 of max
|reference|: ``forward`` (activations and the MoE aux summed over the
prefix and the unit), ``make_prefill`` of B 2 x S 2048 on both ``sdpa``
routes (the flash route meets the reference's conditions at chunk 32;
the reference runs its chunked route, as in ``tests/test_torch_model.py``)
with its caches, 4 decode steps from the port's own prefill cache;
``ServeEngine.generate`` greedy tokens equal to the reference engine's;
and teacher-forced ``forward`` against token-by-token decode in the port
(as ``tests/test_models_decode.py``).

In bf16 a routed model is not a smooth function of its input: an
activation that moves by one bf16 rounding moves a router probability by
up to a few 1e-3, and a token whose k-th and (k+1)-th probabilities are
that close takes another expert, with an output that differs by much
more than the tolerance (and, through attention, moves later tokens of
its row in later layers).  So bf16 is held layer by layer: each layer of
the port gets the reference's own input to that layer, on both routes;
the tokens whose top-k sets differ from the reference's are set aside
and counted (each must be at a margin under 2^-7, the reach of a bf16
rounding), and every other token is held within 2^-5 of max
|reference|.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.layers import rms_norm as jrms  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.kernels.flash import flash as port_flash  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.layers import rms_norm as trms  # noqa: E402
from repro_torch.serve import ServeEngine, make_serve_step  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -5}
FLIP_MARGIN = 2.0 ** -7     # bf16: the widest margin a flip may have
ARCHS = ["dbrx-132b", "deepseek-v2-lite-16b"]
B, S, N_DECODE = 2, 2048, 4


def _cfg(mod, arch, dtype):
    cfg = mod.reduced(mod.get_config(arch))
    return dataclasses.replace(
        cfg, n_repeats=2, compute_dtype=dtype,
        attention=dataclasses.replace(cfg.attention, chunk_size=32))


def _f32(a):
    if torch.is_tensor(a):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, ref, tol):
    got, ref = _f32(got), _f32(ref)
    gap = np.abs(got - ref).max()
    assert gap <= tol * np.abs(ref).max(), (gap, np.abs(ref).max())


@functools.lru_cache(maxsize=None)
def _params(arch):
    """The reference's params (f32 in both dtypes' configs) and the port's."""
    jc = _cfg(jcfgs, arch, "float32")
    jparams = jax.jit(JModel(jc).init)(jax.random.PRNGKey(0))
    return jparams, params_from_reference(jax.tree.map(np.asarray, jparams),
                                          device="cpu")


def _setup(arch, dtype="float32"):
    jc, tc = _cfg(jcfgs, arch, dtype), _cfg(tcfgs, arch, dtype)
    jparams, tparams = _params(arch)
    tokens = np.random.default_rng(0).integers(
        0, jc.vocab_size, (B, S + N_DECODE)).astype(np.int32)
    return jc, tc, jparams, tparams, tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_are_the_references(arch):
    ref, port = jcfgs.get_config(arch), tcfgs.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    jc, tc, jparams, tparams, _ = _setup(arch)
    jl = jax.tree_util.tree_leaves_with_path(jparams)
    tl = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), tparams))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        assert a.shape == b.shape and np.array_equal(np.asarray(a), b)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_aux_match_reference(arch):
    jc, tc, jparams, tparams, tokens = _setup(arch)
    tok = tokens[:, :64]
    ref, ref_aux = jax.jit(lambda p, t: jmodel.forward(
        p, jc, {"tokens": t}))(jparams, jnp.asarray(tok))
    got, aux = tmodel.forward(tparams, tc, {"tokens": torch.from_numpy(tok)})
    _close(got, ref, TOL["float32"])
    n_moe = sum(s.ffn == "moe" for s in tc.prefix) + tc.n_repeats
    assert n_moe == 2 and float(ref_aux) > 0.5 * n_moe  # E f.p / k ~ 1
    assert abs(float(aux) - float(ref_aux)) <= 1e-4 * float(ref_aux)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_both_routes_and_decode_match_reference(arch):
    jc, tc, jparams, tparams, tokens = _setup(arch)
    tol = TOL["float32"]
    prompt = tokens[:, :S]
    jcache = jmodel.init_cache(jc, B, S + N_DECODE, jnp.float32)
    jlogits, jcache = jax.jit(jmodel.make_prefill(jc))(
        jparams, {"tokens": jnp.asarray(prompt)}, jcache)
    tcache0 = tmodel.init_cache(tc, B, S + N_DECODE, torch.float32, "cpu")
    names = sorted(tcache0["unit"][0])
    assert names == (["ckv", "krope"] if arch.startswith("deepseek")
                     else ["k", "v"])
    prefill = tmodel.make_prefill(tc)
    routes = {}
    for flash in (True, False):
        before = port_flash.FLASH_KERNEL.launches
        routes[flash] = prefill(tparams, {"tokens": torch.from_numpy(prompt)},
                                tcache0, tmodel.Ctx(cfg=tc, flash=flash))
        assert port_flash.FLASH_KERNEL.launches == before  # CPU: plain
    for flash, (logits, cache) in routes.items():
        _close(logits, jlogits, tol)
        for tree, jtree in zip(cache["prefix"] + list(cache["unit"]),
                               jcache["prefix"] + list(jcache["unit"])):
            for name in names:
                _close(tree[name], jtree[name], tol)

    jdecode = jax.jit(jmodel.make_decode_step(jc))
    tdecode = tmodel.make_decode_step(tc)
    tcache = routes[True][1]
    for i in range(N_DECODE):
        tok = tokens[:, S + i:S + i + 1]
        jl, jcache = jdecode(jparams, jnp.asarray(tok), jcache,
                             jnp.asarray(S + i, jnp.int32))
        tl, tcache = tdecode(tparams, torch.from_numpy(tok), tcache, S + i)
        _close(tl, jl, tol)
    for name in names:
        _close(tcache["unit"][0][name], jcache["unit"][0][name], tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_equals_the_references(arch):
    jc, tc, jparams, tparams, _ = _setup(arch)
    prompts = np.random.default_rng(1).integers(
        0, tc.vocab_size, (2, 8)).astype(np.int32)
    ref = JServeEngine(jc, jparams, max_seq=15, batch=2).generate(
        jnp.asarray(prompts), 6)
    out = ServeEngine(tc, tparams, max_seq=15, batch=2,
                      device="cpu").generate(prompts, 6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_is_one_dropless_decode(arch):
    """make_serve_step is the decode step (dropless): its logits equal
    make_decode_step's bit for bit, and its cache carries the token."""
    _, tc, _, tparams, tokens = _setup(arch)
    tok = torch.from_numpy(tokens[:, :1])
    caches = [tmodel.init_cache(tc, B, 4, torch.float32, "cpu")
              for _ in range(2)]
    got, c = make_serve_step(tc)(tparams, tok, caches[0], 0)
    ref, _ = tmodel.make_decode_step(tc)(tparams, tok, caches[1], 0)
    assert got.shape == (B, 1, tc.vocab_size) and torch.equal(got, ref)
    for name, t in c["unit"][0].items():  # [R, B, KV, S, D] or [R, B, S, L]
        ax = 3 if name in ("k", "v") else 2
        assert t.select(ax, 0).any() and not t.select(ax, 1).any()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forced_forward(arch):
    """Token-by-token decode (dropless) from an empty cache reproduces
    the teacher-forced forward (capacity 8.0: no token dropped)."""
    _, tc, _, tparams, tokens = _setup(arch)
    L = 12
    tok = torch.from_numpy(tokens[:, :L])
    x, _ = tmodel.forward(tparams, tc, {"tokens": tok})
    full = x @ tparams["lm_head"]
    cache = tmodel.init_cache(tc, B, L, torch.float32, "cpu")
    decode = tmodel.make_decode_step(tc)
    outs = []
    for i in range(L):
        logits, cache = decode(tparams, tok[:, i:i + 1], cache, i)
        outs.append(logits[:, 0])
    _close(torch.stack(outs, 1), full.detach(), TOL["float32"])


# ---------------------------------------------------------------------------
# bf16, layer by layer
# ---------------------------------------------------------------------------

def _layers(cfg, params, at):
    out = list(zip(cfg.prefix, params["prefix"]))
    for r in range(cfg.n_repeats):
        out += [(spec, at(params["unit"][i], r))
                for i, spec in enumerate(cfg.unit)]
    return out


def _router_input(mod, rms, spec, p, x, ctx, eps):
    """apply_layer's steps up to the FFN's input."""
    h, _ = mod._apply_mixer(spec, p["mix"], rms(x, p["norm1"], eps), ctx)
    return rms(x + h, p["norm2"], eps)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_layers_match_reference_on_its_inputs(arch):
    jc, tc, jparams, tparams, tokens = _setup(arch, "bfloat16")
    tol, eps = TOL["bfloat16"], tc.norm_eps
    S1 = S  # one row of S 2048: the flash route's conditions hold
    tok = tokens[:1, :S1]
    jctx = jmodel.Ctx(cfg=jc, positions=jnp.arange(S1))
    x = jmodel._embed(jparams, jc, {"tokens": jnp.asarray(tok)}, jctx)
    jl = _layers(jc, jparams, lambda t, r: jax.tree.map(lambda a: a[r], t))
    tl = _layers(tc, tparams, tmodel._at)
    k, d = tc.moe.top_k, tc.d_model

    @functools.lru_cache(maxsize=None)
    def jlayer(spec):
        def run(p, x):
            return (_router_input(jmodel, jrms, spec, p, x, jctx, eps),
                    jmodel.apply_layer(spec, p, x, jctx)[0])
        return jax.jit(run)

    flips = 0
    for (spec, jp), (_, tp) in zip(jl, tl):
        jr, jout = jlayer(spec)(jp, x)
        tx = torch.from_numpy(np.array(_f32(x))).to(torch.bfloat16)
        for flash in (True, False):
            tctx = tmodel.Ctx(cfg=tc, positions=torch.arange(S1),
                              flash=flash)
            tout, _, _ = tmodel.apply_layer(spec, tp, tx, tctx)
            keep = np.ones(S1, bool)
            if spec.ffn == "moe":
                tr = _router_input(tmodel, trms, spec, tp, tx, tctx, eps)
                probs = jax.nn.softmax(
                    jr.reshape(-1, d).astype(jnp.float32) @ jp["ffn"]["router"],
                    axis=-1)
                _, jidx = jax.lax.top_k(probs, k)
                _, _, tidx = tmoe.route(tr.reshape(-1, d),
                                        tp["ffn"]["router"], k)
                flipped = (np.sort(np.asarray(jidx), 1)
                           != np.sort(tidx.numpy(), 1)).any(1)
                top = -np.sort(-np.asarray(probs), 1)
                margin = top[:, k - 1] - top[:, k]
                assert (margin[flipped] < FLIP_MARGIN).all(), margin[flipped]
                flips += int(flipped.sum())
                keep = ~flipped
            got, ref = _f32(tout)[0, keep], _f32(jout)[0, keep]
            gap = np.abs(got - ref).max()
            assert gap <= tol * np.abs(_f32(jout)).max(), (spec, flash, gap)
        x = jout
    print(f"{arch}: {flips} token routings differ from the reference's "
          f"(both routes, every MoE layer)")


def test_jamba_still_raises_naming_only_mamba():
    """Mamba was all jamba lacked: now jamba loads, its MoE the
    reference's, and the archs still not ported raise naming only what
    each lacks (the vision cross-attention, the audio stub)."""
    cfg = tcfgs.get_config("jamba-v0.1-52b")
    assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(
        jcfgs.get_config("jamba-v0.1-52b").moe)
    with pytest.raises(NotImplementedError, match=(
            r"^llama-3.2-vision-11b: cross-attention \(vision\) is not "
            r"ported")):
        tcfgs.get_config("llama-3.2-vision-11b")
    with pytest.raises(NotImplementedError, match=(
            r"^musicgen-medium: the audio frontend stub")):
        tcfgs.get_config("musicgen-medium")
