"""jamba-v0.1-52b (Mamba + GQA, MoE) and rwkv6-3b (RWKV-6) in the port
against the reference on the CPU.

The reference's ``reduced`` configs (jamba: one repeat of its 8-layer
unit, 7 Mamba layers and 1 attention, 4 MoE FFNs; rwkv: one RWKV-6
layer, then the same with 3 repeats, so decode writes the stacked
caches' later repeats) in f32, on one set of params drawn by the port
and handed to the reference as numpy.  Within 1e-5 of max |reference|:
``forward``; ``make_prefill`` of B 2 x S 16 given a cache filled with NaN
against the reference's prefill of a zeroed cache (the logits and every
recurrent state; the port's logits equal those of its own zeroed cache
bit for bit: the prefill starts the recurrent states from zero); 4
decode steps from the port's prefill cache against the reference's from
its own; and ``ServeEngine.generate``'s greedy tokens equal to the
reference engine's.  Also ``init_params``'s tree against the
reference's (shapes and dtypes), and ``params_from_reference`` carrying
the new leaves.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

TOL = 1e-5          # f32, of max |reference|
# (arch, repeats)
CASES = [("jamba-v0.1-52b", 1), ("rwkv6-3b", 1), ("rwkv6-3b", 3)]
IDS = ["jamba", "rwkv", "rwkv-x3"]
B, S, N_DECODE = 2, 16, 4
STATE_KEYS = tmodel.STATE_KEYS


def _f32(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, ref, tol=TOL):
    got, ref = _f32(got), _f32(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    gap = np.abs(got - ref).max()
    assert gap <= tol * np.abs(ref).max(), (gap, np.abs(ref).max())


def _cfgs(arch, repeats):
    return tuple(dataclasses.replace(m.reduced(m.get_config(arch)),
                                     n_repeats=repeats)
                 for m in (jcfgs, tcfgs))


@functools.lru_cache(maxsize=None)
def _ref(arch, repeats):
    """The reference's params and outputs: forward, a prefill of a zeroed
    cache and N_DECODE decode steps from it."""
    jc, tc = _cfgs(arch, repeats)
    # drawn by the port (the reference's init of jamba's stacked unit takes
    # seconds to trace) and handed to the reference as numpy
    tp = tmodel.init_params(0, tc, device="cpu")
    jp = jax.tree.map(lambda t: t.numpy(), tp)
    tokens = np.random.default_rng(0).integers(
        0, jc.vocab_size, (B, S + N_DECODE)).astype(np.int32)
    fwd, _ = jax.jit(lambda p, t: jmodel.forward(p, jc, {"tokens": t}))(
        jp, jnp.asarray(tokens[:, :S]))
    cache = jmodel.init_cache(jc, B, S + N_DECODE, jnp.float32)
    logits, cache = jax.jit(jmodel.make_prefill(jc))(
        jp, {"tokens": jnp.asarray(tokens[:, :S])}, cache)
    prefill = (np.asarray(logits), jax.tree.map(np.asarray, cache))
    decode = jax.jit(jmodel.make_decode_step(jc))
    steps = []
    for i in range(N_DECODE):
        lg, cache = decode(jp, jnp.asarray(tokens[:, S + i:S + i + 1]), cache,
                           jnp.asarray(S + i, jnp.int32))
        steps.append(np.asarray(lg))
    return {"jc": jc, "tc": tc, "jp": jp, "tp": tp, "tokens": tokens,
            "forward": np.asarray(fwd), "prefill": prefill, "steps": steps,
            "last_cache": jax.tree.map(np.asarray, cache)}


def _layer_caches(cache):
    return list(cache["prefix"]) + list(cache["unit"])


@pytest.mark.parametrize("arch,repeats", CASES, ids=IDS)
def test_forward_matches_reference(arch, repeats):
    r = _ref(arch, repeats)
    got, aux = tmodel.forward(r["tp"], r["tc"], {
        "tokens": torch.from_numpy(r["tokens"][:, :S])})
    _close(got, r["forward"])
    assert float(aux) >= 0.0


def _nan_cache(tc):
    cache = tmodel.init_cache(tc, B, S + N_DECODE, torch.float32, "cpu")
    for c in _layer_caches(cache):
        for t in c.values():
            t.fill_(float("nan"))
    return cache


@pytest.mark.parametrize("arch,repeats", CASES, ids=IDS)
def test_prefill_of_a_nan_cache_matches_the_references_zeroed_one(
        arch, repeats):
    r = _ref(arch, repeats)
    tc, prompt = r["tc"], torch.from_numpy(r["tokens"][:, :S])
    prefill = tmodel.make_prefill(tc)
    nan_cache = _nan_cache(tc)
    logits, cache = prefill(r["tp"], {"tokens": prompt}, nan_cache)
    jlogits, jcache = r["prefill"]
    _close(logits, jlogits)
    assert all(t.isnan().all() for c in _layer_caches(nan_cache)
               for t in c.values())  # the caller's cache is untouched
    zero = tmodel.init_cache(tc, B, S + N_DECODE, torch.float32, "cpu")
    assert torch.equal(prefill(r["tp"], {"tokens": prompt}, zero)[0], logits)
    names = set()
    for c, jc_ in zip(_layer_caches(cache), _layer_caches(jcache)):
        assert set(c) == set(jc_)
        for k, t in c.items():
            if k in STATE_KEYS:
                names.add(k)
                _close(t, jc_[k])
            else:  # attention: the prompt's positions
                _close(t[..., :S, :], jc_[k][..., :S, :])
    assert names == ({"conv", "ssm"} if arch.startswith("jamba") else
                     {"shift_tm", "wkv", "shift_cm"})


@pytest.mark.parametrize("arch,repeats", CASES, ids=IDS)
def test_decode_matches_reference(arch, repeats):
    r = _ref(arch, repeats)
    tc = r["tc"]
    _, cache = tmodel.make_prefill(tc)(
        r["tp"], {"tokens": torch.from_numpy(r["tokens"][:, :S])},
        _nan_cache(tc))
    decode = tmodel.make_decode_step(tc)
    for i in range(N_DECODE):
        lg, out = decode(r["tp"], torch.from_numpy(
            r["tokens"][:, S + i:S + i + 1]), cache, S + i)
        assert out is cache  # updated in place
        _close(lg, r["steps"][i])
    for c, jc_ in zip(_layer_caches(cache), _layer_caches(r["last_cache"])):
        for k in set(c) & set(STATE_KEYS):
            _close(c[k], jc_[k])


@pytest.mark.parametrize("arch,repeats", CASES, ids=IDS)
def test_generate_greedy_equals_the_references(arch, repeats):
    r = _ref(arch, repeats)
    prompts = np.random.default_rng(1).integers(
        0, r["tc"].vocab_size, (2, 8)).astype(np.int32)
    ref = JServeEngine(r["jc"], r["jp"], max_seq=15, batch=2).generate(
        jnp.asarray(prompts), 6)
    out = ServeEngine(r["tc"], r["tp"], max_seq=15, batch=2,
                      device="cpu").generate(prompts, 6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "rwkv6-3b"])
def test_init_params_draws_the_references_tree(arch):
    """The port's own draw has the reference's leaves: paths, shapes and
    dtypes (Mamba's A_log and D and RWKV's w0, u and group norm in f32),
    at the published widths' dtypes too (param_dtype bf16 or f32)."""
    r = _ref(arch, 1)
    jc = dataclasses.replace(r["jc"], param_dtype=jcfgs.get_config(
        arch).param_dtype)
    tc = dataclasses.replace(r["tc"], param_dtype=jc.param_dtype)
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k, jc),
                            jax.random.PRNGKey(0))
    jl = jax.tree_util.tree_leaves_with_path(shapes)
    tl = jax.tree_util.tree_leaves_with_path(tmodel.init_params(0, tc,
                                                                "cpu"))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert a.shape == tuple(b.shape), path
        assert str(a.dtype) == str(b.dtype).removeprefix("torch."), path


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "rwkv6-3b"])
def test_params_from_reference_carries_the_new_leaves(arch):
    r = _ref(arch, 1)
    jp = r["jp"]
    tp = params_from_reference(jp, device="cpu")
    if arch.startswith("jamba"):
        mix, jmix = tp["unit"][0]["mix"], jp["unit"][0]["mix"]
        assert mix["A_log"].dtype == mix["D"].dtype == torch.float32
        names = ("A_log", "D", "conv_w", "dt_bias", "x_proj")
    else:
        mix, jmix = tp["unit"][0]["mix"], jp["unit"][0]["mix"]
        d, hd = r["tc"].d_model, r["tc"].rwkv.head_dim
        assert mix["wr"].shape == (1, d, d // hd, hd)
        assert mix["wo"].shape == (1, d // hd, hd, d)
        names = ("wr", "wk", "wv", "wg", "wo", "u", "w0")
        assert set(tp["unit"][0]["ffn"]) == {"mu", "wk", "wv", "wr"}
    for n in names:
        assert torch.equal(mix[n], torch.from_numpy(np.array(jmix[n]))), n
