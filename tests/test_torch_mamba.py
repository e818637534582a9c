"""Mamba's S6 mixer (``models/mamba.py``) and kernel L's plain version
(``kernels/scans/selective_scan.py``) against the reference on the CPU.

The reference's ``reduced(jamba-v0.1-52b)`` Mamba (d 64, d_inner 128,
d_state 8) and the same with jamba's own d_state 16, in f32, its params
from the reference's ``init_mamba`` carried over by
``convert.params_from_reference``: ``mamba_forward`` with no cache and
with a non-zero cache (the output and the new cache), three
``mamba_decode`` steps and ``_causal_conv`` with an initial window, all
within 1e-5 of max |reference|.  ``selective_scan_plain`` is held to a
float64 loop in numpy (1e-5 of max |loop|), and chunked plain calls that
carry the state equal one call bit for bit.  The JAX outputs are made
once a module and d_state.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.kernels.scans import selective_scan as tss  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

TOL = 1e-5          # f32, of max |reference|
B, S, N_DECODE = 2, 24, 3


def _close(got, ref, tol=TOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    ref = np.asarray(ref, np.float32)
    gap = np.abs(got - ref).max()
    assert gap <= tol * np.abs(ref).max(), (gap, np.abs(ref).max())


@pytest.fixture(scope="module", params=[8, 16], ids=["ds8", "ds16"])
def ref(request):
    """The reduced configs at d_state 8 or 16, both packages' params, the
    inputs and the reference's outputs."""
    ds = request.param
    jc, tc = (dataclasses.replace(
        m.reduced(m.get_config("jamba-v0.1-52b")),
        mamba=m.MambaConfig(d_state=ds, d_conv=4, expand=2))
        for m in (jcfgs, tcfgs))
    jp = jmamba.init_mamba(jax.random.PRNGKey(ds), jc, jnp.float32)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(ds)
    di = jc.mamba.expand * jc.d_model
    x = rng.normal(size=(B, S + N_DECODE, jc.d_model)).astype(np.float32)
    cache = {"conv": rng.normal(size=(B, 3, di)).astype(np.float32),
             "ssm": (rng.normal(size=(B, di, ds)) * 0.5).astype(np.float32)}
    jctx = jmodel.Ctx(cfg=jc)
    fwd = jax.jit(lambda p, x, c: jmamba.mamba_forward(p, x, jctx, cache=c))
    out_none, _ = jax.jit(lambda p, x: jmamba.mamba_forward(p, x, jctx))(
        jp, jnp.asarray(x[:, :S]))
    out_c, new_c = fwd(jp, jnp.asarray(x[:, :S]),
                       jax.tree.map(jnp.asarray, cache))
    steps, c = [], new_c
    for i in range(N_DECODE):
        o, c = fwd(jp, jnp.asarray(x[:, S + i:S + i + 1]), c)
        steps.append(np.asarray(o))
    return {"ds": ds, "jc": jc, "tc": tc, "jp": jp, "tp": tp, "x": x,
            "cache": cache, "out_none": np.asarray(out_none),
            "out_c": np.asarray(out_c),
            "new_c": jax.tree.map(np.asarray, new_c), "steps": steps,
            "last_c": jax.tree.map(np.asarray, c)}


def _tcache(cache):
    return {k: torch.from_numpy(v.copy()) for k, v in cache.items()}


def test_forward_without_a_cache(ref):
    out, c = tmamba.mamba_forward(ref["tp"], torch.from_numpy(
        ref["x"][:, :S]), tmodel.Ctx(cfg=ref["tc"]))
    assert c is None and out.dtype == torch.float32
    _close(out, ref["out_none"])


def test_forward_with_a_nonzero_cache_updates_it_in_place(ref):
    cache = _tcache(ref["cache"])
    out, c = tmamba.mamba_forward(ref["tp"], torch.from_numpy(
        ref["x"][:, :S]), tmodel.Ctx(cfg=ref["tc"]), cache=cache)
    assert c is cache and c["ssm"].dtype == torch.float32
    _close(out, ref["out_c"])
    for name in ("conv", "ssm"):
        _close(c[name], ref["new_c"][name])


def test_decode_steps(ref):
    cache = _tcache(ref["new_c"])
    ctx = tmodel.Ctx(cfg=ref["tc"])
    for i in range(N_DECODE):
        out, cache = tmamba.mamba_decode(ref["tp"], torch.from_numpy(
            ref["x"][:, S + i:S + i + 1]), cache, S + i, ctx)
        _close(out, ref["steps"][i])
    for name in ("conv", "ssm"):
        _close(cache[name], ref["last_c"][name])


def test_causal_conv_with_a_window(ref):
    rng = np.random.default_rng(3)
    di = ref["jc"].mamba.expand * ref["jc"].d_model
    x = rng.normal(size=(B, 9, di)).astype(np.float32)
    win = rng.normal(size=(B, 3, di)).astype(np.float32)
    p = ref["jp"]
    for w in (None, win):
        jy, jw = jmamba._causal_conv(jnp.asarray(x), p["conv_w"], p["conv_b"],
                                     None if w is None else jnp.asarray(w))
        ty, tw = tmamba._causal_conv(
            torch.from_numpy(x), ref["tp"]["conv_w"], ref["tp"]["conv_b"],
            None if w is None else torch.from_numpy(w))
        _close(ty, jy)
        assert torch.equal(tw, torch.from_numpy(np.array(jw)))


def _scan_operands(rng, ds, T=37, di=24, dtype=np.float32):
    xi = rng.normal(size=(B, T, di)).astype(dtype)
    dt = rng.uniform(1e-3, 0.5, size=(B, T, di)).astype(np.float32)
    Bc = rng.normal(size=(B, T, ds)).astype(dtype)
    Cc = rng.normal(size=(B, T, ds)).astype(dtype)
    A = -np.tile(np.arange(1, ds + 1, dtype=np.float32), (di, 1))
    h0 = (rng.normal(size=(B, di, ds)) * 0.5).astype(np.float32)
    return xi, dt, Bc, Cc, A, h0


def _scan64(xi, dt, Bc, Cc, A, h0):
    xi, dt, Bc, Cc, A, h = (np.asarray(t, np.float64)
                            for t in (xi, dt, Bc, Cc, A, h0))
    ys = []
    for t in range(xi.shape[1]):
        dA = np.exp(dt[:, t, :, None] * A[None])
        h = dA * h + dt[:, t, :, None] * Bc[:, t, None, :] * xi[:, t, :, None]
        ys.append((h * Cc[:, t, None, :]).sum(-1))
    return np.stack(ys, 1), h


@pytest.mark.parametrize("ds", [8, 16])
def test_selective_scan_plain_against_a_float64_loop(ds):
    ops = _scan_operands(np.random.default_rng(ds), ds)
    ys, h = tss.selective_scan_plain(*map(torch.from_numpy, ops))
    ys64, h64 = _scan64(*ops)
    assert ys.dtype == h.dtype == torch.float32
    _close(ys, ys64)
    _close(h, h64)
    # the wrapper takes the plain version on a CPU tensor, bit for bit
    ys2, h2 = tss.selective_scan(*map(torch.from_numpy, ops))
    assert torch.equal(ys, ys2) and torch.equal(h, h2)


@pytest.mark.parametrize("cuts", [(1000,), (1, 36), (7, 10, 20)])
def test_chunked_plain_calls_equal_one_call(cuts):
    """T 37 split after the given steps (1000: not split), the state
    carried from call to call: ys and h_last equal one call's bit for
    bit."""
    xi, dt, Bc, Cc, A, h0 = map(torch.from_numpy, _scan_operands(
        np.random.default_rng(5), 16))
    whole = tss.selective_scan_plain(xi, dt, Bc, Cc, A, h0)
    h, parts, lo = h0, [], 0
    for hi in (*[c for c in cuts if c < 37], 37):
        y, h = tss.selective_scan_plain(xi[:, lo:hi], dt[:, lo:hi],
                                        Bc[:, lo:hi], Cc[:, lo:hi], A, h)
        parts.append(y)
        lo = hi
    assert torch.equal(torch.cat(parts, 1), whole[0])
    assert torch.equal(h, whole[1])


def test_init_mamba_draws_the_references_distributions(ref):
    """The port's own draw: the reference's leaves (names, shapes, dtypes),
    A_log = log(1..ds) and D = 1 in f32, softplus(dt_bias) in [1e-3, 0.1],
    dt_proj with unit scale, conv_w with 1/sqrt(d_conv)."""
    tc, ds = ref["tc"], ref["ds"]
    gen = torch.Generator().manual_seed(0)
    p = tmamba.init_mamba(gen, tc, torch.float32)
    jp = ref["jp"]
    assert set(p) == set(jp)
    for k, t in p.items():
        assert tuple(t.shape) == jp[k].shape and t.dtype == torch.float32, k
    # log(1..ds): torch's and XLA's logs may part by an ulp
    a_log = np.log(np.arange(1, ds + 1, dtype=np.float64))
    np.testing.assert_allclose(p["A_log"].numpy(), np.tile(a_log, (
        p["A_log"].shape[0], 1)), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jp["A_log"]), p["A_log"].numpy(),
                               rtol=1e-6)
    assert torch.equal(p["D"], torch.ones_like(p["D"]))
    sp = tmamba.softplus(p["dt_bias"])
    assert sp.min() >= 1e-3 * (1 - 1e-5) and sp.max() <= 0.1 * (1 + 1e-5)
    assert 0.8 < p["dt_proj"].std().item() < 1.2
    assert 0.4 < p["conv_w"].std().item() < 0.6
    assert not p["conv_b"].any()


def test_softplus_is_jax_nn_softplus():
    x = np.linspace(-40, 40, 2001, dtype=np.float32)
    got = tmamba.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(x)),
                               rtol=1e-6, atol=1e-30)
