"""RWKV-6's token-mix and channel-mix (``models/rwkv.py``), the per-head
group norm (``models/layers.py``) and kernel M's plain version
(``kernels/scans/wkv6.py``) against the reference on the CPU.

The reference's ``reduced(rwkv6-3b)`` (d 64, 4 heads of 16, decay LoRA
8) in f32, its params from the reference's ``init_rwkv_tm`` and
``init_rwkv_cm`` carried over by ``convert.params_from_reference``:
``rwkv_tm_forward`` and ``rwkv_cm_forward`` with no cache and with a
non-zero cache (the output and the new cache), and ``group_norm_heads``,
within 1e-5 of max |reference|; ``wkv6_plain`` against a float64 loop in
numpy (1e-5 of max |loop|) at head dims 16 and 64, and chunked plain
calls that carry the state equal to one call bit for bit.  The JAX
outputs are made once a module.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.kernels.scans import wkv6 as twkv  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402

TOL = 1e-5          # f32, of max |reference|
B, S = 2, 20


def _close(got, ref, tol=TOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    ref = np.asarray(ref, np.float32)
    gap = np.abs(got - ref).max()
    assert gap <= tol * np.abs(ref).max(), (gap, np.abs(ref).max())


@pytest.fixture(scope="module")
def ref():
    jc = jcfgs.reduced(jcfgs.get_config("rwkv6-3b"))
    tc = tcfgs.reduced(tcfgs.get_config("rwkv6-3b"))
    k1, k2 = jax.random.split(jax.random.PRNGKey(6))
    jp = {"tm": jrwkv.init_rwkv_tm(k1, jc, jnp.float32),
          "cm": jrwkv.init_rwkv_cm(k2, jc, jnp.float32)}
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(6)
    d, hd = jc.d_model, jc.rwkv.head_dim
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    cache = {"shift_tm": rng.normal(size=(B, d)).astype(np.float32),
             "wkv": (rng.normal(size=(B, d // hd, hd, hd)) * 0.5).astype(
                 np.float32),
             "shift_cm": rng.normal(size=(B, d)).astype(np.float32)}
    jctx = jmodel.Ctx(cfg=jc)
    out = {}
    for name, fn in (("tm", jrwkv.rwkv_tm_forward),
                     ("cm", jrwkv.rwkv_cm_forward)):
        keys = ("shift_tm", "wkv") if name == "tm" else ("shift_cm",)
        f = jax.jit(lambda p, x, c, fn=fn: fn(p, x, jctx, cache=c))
        out[name] = (np.asarray(f(jp[name], jnp.asarray(x), None)[0]),
                     jax.tree.map(np.asarray, f(
                         jp[name], jnp.asarray(x),
                         {k: jnp.asarray(cache[k]) for k in keys})))
    return {"jc": jc, "tc": tc, "jp": jp, "tp": tp, "x": x, "cache": cache,
            "out": out}


@pytest.mark.parametrize("name", ["tm", "cm"])
def test_mix_without_a_cache(ref, name):
    fn = trwkv.rwkv_tm_forward if name == "tm" else trwkv.rwkv_cm_forward
    got, c = fn(ref["tp"][name], torch.from_numpy(ref["x"]),
                tmodel.Ctx(cfg=ref["tc"]))
    assert c is None
    _close(got, ref["out"][name][0])


@pytest.mark.parametrize("name", ["tm", "cm"])
def test_mix_with_a_nonzero_cache_updates_it_in_place(ref, name):
    """One cache dict holds all three states; each mix reads and writes
    only its own."""
    fn = trwkv.rwkv_tm_forward if name == "tm" else trwkv.rwkv_cm_forward
    cache = {k: torch.from_numpy(v.copy()) for k, v in ref["cache"].items()}
    got, c = fn(ref["tp"][name], torch.from_numpy(ref["x"]),
                tmodel.Ctx(cfg=ref["tc"]), cache=cache)
    assert c is cache
    jout, jcache = ref["out"][name][1]
    _close(got, jout)
    for k, v in cache.items():
        if k in jcache:
            _close(v, jcache[k])
        else:
            assert torch.equal(v, torch.from_numpy(ref["cache"][k]))


def test_group_norm_heads():
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(B, S, 4, 16)) * 3 + 1).astype(np.float32)
    w = rng.normal(size=(4, 16)).astype(np.float32)
    b = rng.normal(size=(4, 16)).astype(np.float32)
    jy = jlayers.group_norm_heads(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), 64e-5)
    ty = tlayers.group_norm_heads(*map(torch.from_numpy, (x, w, b)), 64e-5)
    _close(ty, jy)
    ty16 = tlayers.group_norm_heads(torch.from_numpy(x).bfloat16(),
                                    *map(torch.from_numpy, (w, b)), 64e-5)
    assert ty16.dtype == torch.bfloat16


def _wkv_operands(rng, hd, T=29, H=3):
    r, k, v = (rng.normal(size=(B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.normal(size=(B, T, H, hd)) - 1.0)).astype(
        np.float32)
    u = (rng.normal(size=(H, hd)) * 0.1).astype(np.float32)
    S0 = (rng.normal(size=(B, H, hd, hd)) * 0.5).astype(np.float32)
    return r, k, v, w, u, S0


def _wkv64(r, k, v, w, u, S0):
    r, k, v, w, u, S = (np.asarray(t, np.float64)
                        for t in (r, k, v, w, u, S0))
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(np.einsum("bhk,bhkv->bhv", r[:, t],
                            S + u[None, :, :, None] * kv))
        S = w[:, t, :, :, None] * S + kv
    return np.stack(ys, 1), S


@pytest.mark.parametrize("hd", [16, 64])
def test_wkv6_plain_against_a_float64_loop(hd):
    ops = _wkv_operands(np.random.default_rng(hd), hd)
    y, S_last = twkv.wkv6_plain(*map(torch.from_numpy, ops))
    y64, S64 = _wkv64(*ops)
    assert y.dtype == S_last.dtype == torch.float32
    _close(y, y64)
    _close(S_last, S64)
    y2, S2 = twkv.wkv6(*map(torch.from_numpy, ops))
    assert torch.equal(y, y2) and torch.equal(S_last, S2)


@pytest.mark.parametrize("cuts", [(1, 28), (5, 13, 21)])
def test_chunked_plain_calls_equal_one_call(cuts):
    r, k, v, w, u, S0 = map(torch.from_numpy, _wkv_operands(
        np.random.default_rng(9), 16))
    y_all, S_all = twkv.wkv6_plain(r, k, v, w, u, S0)
    S, parts, lo = S0, [], 0
    for hi in (*cuts, 29):
        y, S = twkv.wkv6_plain(r[:, lo:hi], k[:, lo:hi], v[:, lo:hi],
                               w[:, lo:hi], u, S)
        parts.append(y)
        lo = hi
    assert torch.equal(torch.cat(parts, 1), y_all) and torch.equal(S, S_all)


def test_init_rwkv_draws_the_references_leaves(ref):
    """The port's own draw: the reference's leaves (names, shapes,
    dtypes), w0 = -6, u at scale 0.1, the group norm at 1 and 0."""
    tc, jp = ref["tc"], ref["jp"]
    gen = torch.Generator().manual_seed(0)
    p = {"tm": trwkv.init_rwkv_tm(gen, tc, torch.bfloat16),
         "cm": trwkv.init_rwkv_cm(gen, tc, torch.bfloat16)}
    f32 = ("w0", "u", "gn_w", "gn_b")
    for part in ("tm", "cm"):
        assert set(p[part]) == set(jp[part])
        for k, t in p[part].items():
            assert tuple(t.shape) == jp[part][k].shape, (part, k)
            want = torch.float32 if part == "tm" and k in f32 else \
                torch.bfloat16
            assert t.dtype == want, (part, k)
    assert (p["tm"]["w0"] == -6.0).all()
    assert 0.05 < p["tm"]["u"].std().item() < 0.15
    assert (p["tm"]["gn_w"] == 1).all() and not p["tm"]["gn_b"].any()
    assert 0 <= p["tm"]["mu"].min() and p["tm"]["mu"].max() <= 1
