"""The port's Multi-head Latent Attention against the reference's on the
CPU.

``reduced`` deepseek-v2-lite-16b (4 heads, latent 32, qk 16 + 8 rope, v
16) with ``chunk_size`` 32, the reference's ``init_mla`` params carried
over by ``convert.params_from_reference``, one sequence of S 2048 (which
meets the reference's flash conditions with chunk 32): the port's
``mla_forward`` on both ``sdpa`` routes (flash: kernel F's plain version
on the CPU, q [1, 2048, 4, 1, 24], Dv 16) and its prefill cache (``ckv``,
``krope``) against the reference's chunked route, then 4 steps of
``mla_decode`` started from the reference's prefill cache (carried over
like the params) against the reference's decode.  f32 within rel 1e-4 of
max |reference|, bf16 within 2^-5.  The reference's flash route runs
Pallas without ``interpret`` and its bf16 decode asks for a BF16 x BF16 =
F32 dot that XLA's CPU backend lacks, so the port's flash route is held
to the reference's chunked route, and its bf16 decode to the reference's
decode with f32 compute.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import Ctx as JCtx  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.kernels.flash import flash as port_flash  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.model import Ctx as TCtx  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -5}
S, N_DECODE = 2048, 4


def _cfg(mod):
    cfg = mod.reduced(mod.get_config("deepseek-v2-lite-16b"))
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, chunk_size=32))


def _close(got, ref, tol):
    got = got.float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    gap = np.abs(got - ref).max()
    assert gap <= tol * np.abs(ref).max(), (gap, np.abs(ref).max())


@functools.lru_cache(maxsize=None)
def _prefilled(dtype):
    jc, tc = _cfg(jcfgs), _cfg(tcfgs)
    dt = jnp.dtype(dtype)
    jp = jattn.init_mla(jax.random.PRNGKey(0), jc, dt)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(0).standard_normal(
        (1, S + N_DECODE, jc.d_model), dtype=np.float32)
    jx = jnp.asarray(x).astype(dt)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jcache = jattn.init_mla_cache(jc, 1, S + N_DECODE, jnp.float32)
    jctx = JCtx(cfg=jc, positions=jnp.arange(S))
    ref, jcache = jax.jit(lambda p, x, c: jattn.mla_forward(
        p, x, jctx, cache=c))(jp, jx[:, :S], jcache)
    routes = {}
    for flash in (True, False):
        cache = tattn.init_mla_cache(tc, 1, S + N_DECODE, torch.float32)
        before = port_flash.FLASH_KERNEL.launches
        out, cache = tattn.mla_forward(
            tp, tx[:, :S], TCtx(cfg=tc, positions=torch.arange(S),
                                flash=flash), cache=cache)
        assert port_flash.FLASH_KERNEL.launches == before  # CPU: plain
        routes[flash] = (out, cache)
    return jc, tc, jp, tp, jx, tx, ref, jcache, routes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flash", [True, False])
def test_mla_forward_matches_reference(dtype, flash):
    *_, ref, jcache, routes = _prefilled(dtype)
    out, cache = routes[flash]
    assert out.dtype == getattr(torch, dtype)
    _close(out, ref, TOL[dtype])
    for name in ("ckv", "krope"):
        _close(cache[name], jcache[name], TOL[dtype])
        assert not cache[name][:, S:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_routes_share_the_latent_cache(dtype):
    """The latent and the rope key come before attention: equal on both
    routes, bit for bit."""
    routes = _prefilled(dtype)[-1]
    for name in ("ckv", "krope"):
        assert torch.equal(routes[True][1][name], routes[False][1][name])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_from_the_references_cache(dtype):
    jc, tc, jp, tp, jx, tx, _, jcache, _ = _prefilled(dtype)
    tcache = params_from_reference(jax.tree.map(np.asarray, jcache),
                                   device="cpu")
    jc32 = dataclasses.replace(jc, compute_dtype="float32")

    @jax.jit
    def jdecode(p, x, c, i):
        ctx = JCtx(cfg=jc32, positions=jnp.full((1,), i))
        return jattn.mla_decode(p, x, c, i, ctx)

    jx32 = jx.astype(jnp.float32)
    for i in range(N_DECODE):
        t = S + i
        ref, jcache = jdecode(jp, jx32[:, t:t + 1], jcache,
                              jnp.asarray(t, jnp.int32))
        got, tcache = tattn.mla_decode(
            tp, tx[:, t:t + 1], tcache, t,
            TCtx(cfg=tc, positions=torch.full((1,), t)))
        assert got.dtype == getattr(torch, dtype)
        _close(got, ref, TOL[dtype])
    for name in ("ckv", "krope"):
        _close(tcache[name], jcache[name], TOL[dtype])
