"""Kernel G's plain version (the ballast GEMM burner) and ``ballast_burn``
held against the JAX reference on the same numpy inputs.

(a) ``ballast`` (plain) against ``ballast_pallas(..., interpret=True)`` and
    the reference's ``ballast_ref``, over the reference tests' shapes,
    step counts and types: within 1e-5 in float32 (both are float32
    matmul chains; at b = 0.999 I every product but one is an exact 0)
    and 3e-2 in bfloat16 (the reference test's tolerance, for inputs
    rounded to bfloat16);
(b) a dense b (a random orthogonal matrix times 0.999), where the two
    matmuls sum 128 products in their own orders: within 1e-5 of the
    largest |C|, and against a float64 chain within 1e-5 too;
(c) ``ballast_burn``'s ``n_iter``, FLOP count and checksum against the
    reference's on the reference's own ``_tiles(PRNGKey(0))`` arrays;
(d) the same generator seed gives the same checksum, and without a card
    the entry point raises unless ``device="cpu"`` is asked for;
(e) the kernel's own summation order (both routes: one FFMA a product, k
    ascending) emulated on the CPU against the plain version, and the
    wrapper's choice of route by width, with the limits it raises at.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ballast import ops as jops  # noqa: E402
from repro.kernels.ballast.ballast import ballast_pallas  # noqa: E402
from repro.kernels.ballast.ref import ballast_ref as jref  # noqa: E402
from repro_torch.kernels.ballast import ballast as tb  # noqa: E402
from repro_torch.kernels.ballast import ops as tops  # noqa: E402
from repro_torch.kernels.ballast.ref import ballast_ref  # noqa: E402

TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _operands(m, k, n, dtype, seed=42, dense=False):
    """``a`` ~ N(0, 1)/sqrt(k) and ``b`` = 0.999 I (or 0.999 Q for a random
    orthogonal Q), from numpy, rounded to ``dtype`` once: the JAX arrays
    and the torch tensors hold the same values."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((m, k)) / math.sqrt(k)).astype(np.float32)
    if dense:
        q, _ = np.linalg.qr(rng.standard_normal((k, n)))
        b = (0.999 * q).astype(np.float32)
    else:
        b = (np.eye(k, n) * 0.999).astype(np.float32)
    ja, jb = jnp.asarray(a).astype(dtype), jnp.asarray(b).astype(dtype)
    ta = torch.from_numpy(np.array(ja.astype(jnp.float32))).to(
        TORCH_DTYPE[dtype])
    tb_ = torch.from_numpy(np.array(jb.astype(jnp.float32))).to(
        TORCH_DTYPE[dtype])
    return ja, jb, ta, tb_


@pytest.mark.parametrize("m,k,n", [(256, 128, 128), (512, 256, 256),
                                   (1024, 384, 384)])
@pytest.mark.parametrize("n_iter", [1, 7, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ballast_plain_matches_pallas_and_ref(m, k, n, n_iter, dtype):
    ja, jb, ta, tb_ = _operands(m, k, n, dtype)
    pallas = np.asarray(ballast_pallas(ja, jb, n_iter, interpret=True))
    ref = np.asarray(jref(ja, jb, n_iter))
    got = tb.ballast(ta, tb_, n_iter)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.numpy(), pallas, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol)
    # the port's own oracle is the same chain
    assert torch.equal(ballast_ref(ta, tb_, n_iter), got)


@pytest.mark.parametrize("n_iter", [7, 32])
def test_ballast_dense_multiplier(n_iter):
    ja, jb, ta, tb_ = _operands(256, 128, 128, "float32", seed=3, dense=True)
    pallas = np.asarray(ballast_pallas(ja, jb, n_iter, interpret=True))
    got = tb.ballast(ta, tb_, n_iter).numpy()
    f64 = ballast_ref(ta, tb_, n_iter, dtype=torch.float64).numpy()
    scale = np.abs(f64).max()
    assert np.abs(got - pallas).max() <= 1e-5 * scale
    assert np.abs(got - f64).max() <= 1e-5 * scale
    # the dense chain is not the identity's: every column mixes
    assert np.abs(got - 0.999 ** (2 * n_iter) * ta.numpy()).max() > 0.1 * scale


@pytest.mark.parametrize("a_dtype,b_dtype", [("float32", "bfloat16"),
                                              ("bfloat16", "float32")])
def test_ballast_mixed_types(a_dtype, b_dtype):
    """a and b are widened to float32 each on its own, as the reference's
    ``jnp.dot`` promotes them."""
    ja, _, ta, _ = _operands(256, 128, 128, a_dtype, seed=5, dense=True)
    _, jb, _, tb_ = _operands(256, 128, 128, b_dtype, seed=5, dense=True)
    pallas = np.asarray(ballast_pallas(ja, jb, 7, interpret=True))
    got = tb.ballast(ta, tb_, 7).numpy()
    assert np.abs(got - pallas).max() <= 1e-5 * np.abs(pallas).max()


@pytest.mark.parametrize("bm", [128, 256])
def test_ballast_block_shapes(bm):
    ja, jb, ta, tb_ = _operands(512, 128, 128, "float32", seed=0)
    pallas = np.asarray(ballast_pallas(ja, jb, 4, bm=bm, interpret=True))
    got = tb.ballast(ta, tb_, 4, bm=bm).numpy()
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


def test_ballast_contract_checks():
    a = torch.zeros((384, 128))
    with pytest.raises(ValueError, match="blocks of bm=256"):
        tb.ballast(a, torch.eye(128), 1)
    with pytest.raises(ValueError, match="square"):
        tb.ballast(torch.zeros((256, 128)), torch.zeros((128, 64)), 1)
    with pytest.raises(ValueError, match="no kernel for meta"):
        tb.ballast(torch.zeros((256, 128), device="meta"),
                   torch.zeros((128, 128), device="meta"), 1)


@pytest.mark.parametrize("m,k,n,n_iter", [(1024, 256, 256, 10),
                                          (1024, 256, 256, 1043),
                                          (256, 128, 384, 3)])
def test_ballast_flops_exact(m, k, n, n_iter):
    assert tops.ballast_flops(m, k, n, n_iter) == 2 * m * k * n * n_iter
    assert tops.ballast_flops(m, k, n, n_iter) == jops.ballast_flops(
        m, k, n, n_iter)


@pytest.mark.parametrize("gflops", [0.02, 1.0, 140.0, 1000.0])
def test_ballast_burn_n_iter_matches_reference(monkeypatch, gflops):
    """``n_iter = max(int(gflops 1e9 / (2 m k n)), 1)``: 1, 7, 1043, 7450
    at the defaults, read off the ``n_iter`` the port hands its kernel."""
    seen = []
    monkeypatch.setattr(tops, "ballast",
                        lambda a, b, n_iter: seen.append(n_iter) or a)
    tops.ballast_burn(torch.Generator().manual_seed(0), gflops=gflops,
                      device="cpu")
    want = max(int(gflops * 1e9 / (2.0 * 1024 * 256 * 256)), 1)
    assert seen == [want]
    assert want == {0.02: 1, 1.0: 7, 140.0: 1043, 1000.0: 7450}[gflops]


def test_ballast_burn_checksum_on_the_reference_tiles(monkeypatch):
    """The reference's own ``_tiles(PRNGKey(0))`` arrays fed to the port's
    ``ballast_burn``: its checksum equals the reference's
    ``ballast_burn(PRNGKey(0), interpret=True)`` within 1e-6 of
    sum |C| 1e-9 (float32 sums of 262 144 terms in two orders)."""
    gflops = 1.0                                     # n_iter 7
    ja, jb = jops._tiles(jax.random.PRNGKey(0), 1024, 256, 256, jnp.float32)
    ta = torch.from_numpy(np.array(ja))
    tb_ = torch.from_numpy(np.array(jb))
    monkeypatch.setattr(tops, "_tiles", lambda *args: (ta, tb_))
    got = float(tops.ballast_burn(torch.Generator(), gflops=gflops,
                                  device="cpu"))
    want = float(jops.ballast_burn(jax.random.PRNGKey(0), gflops=gflops,
                                   interpret=True))
    c = tb.ballast(ta, tb_, 7)
    assert abs(got - want) <= 1e-6 * float(c.abs().sum()) * 1e-9
    assert abs(got - float(c.double().sum()) * 1e-9) <= (
        1e-6 * float(c.abs().sum()) * 1e-9)


def test_ballast_burn_same_seed_same_checksum():
    def burn(seed):
        return tops.ballast_burn(torch.Generator().manual_seed(seed),
                                 gflops=0.5, m=256, k=128, n=128,
                                 device="cpu")
    first = burn(7)
    assert first.dim() == 0 and torch.isfinite(first)
    assert torch.equal(first, burn(7))
    assert not torch.equal(first, burn(8))
    a, b = tops._tiles(torch.Generator().manual_seed(7), 256, 128, 128,
                       torch.float32, "cpu")
    assert torch.equal(b, torch.eye(128) * 0.999)
    assert abs(float(a.std()) * math.sqrt(128) - 1.0) < 0.02


def test_ballast_burn_without_a_card_raises_unless_cpu_is_asked(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tops.ballast_burn(torch.Generator(), gflops=0.02)
    assert torch.isfinite(tops.ballast_burn(torch.Generator(), gflops=0.02,
                                            device="cpu"))


def _fma_chain(a, b, n_iter, decay=0.999):
    """Kernel G's summation order on the CPU: every output is
    acc = fma(C[r, k], B[k, j], acc) for k ascending from 0, then
    acc * decay, in float32 (the fused multiply-add emulated in float64:
    the product of two float32s is exact there, and the sum is rounded to
    float64 then float32)."""
    c = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32).astype(np.float64)
    for _ in range(n_iter):
        acc = np.zeros((c.shape[0], b.shape[1]), np.float32)
        for k in range(b.shape[0]):
            acc = (acc.astype(np.float64)
                   + c[:, k:k + 1].astype(np.float64) * b[k:k + 1]
                   ).astype(np.float32)
        c = (acc * np.float32(decay)).astype(np.float32)
    return c


@pytest.mark.parametrize("dense", [False, True])
def test_kernel_summation_order_matches_plain(dense):
    """Both of kernel G's routes sum each output's products in one order,
    one FFMA a product, k ascending; that order, at [64 x 64] . [64 x 64]
    for 32 steps, stays within rel 1e-5 of max |plain| of the plain
    version's matmul chain (which sums in its own order)."""
    _, _, ta, tb_ = _operands(64, 64, 64, "float32", seed=9, dense=dense)
    got = _fma_chain(ta.numpy(), tb_.numpy(), 32)
    plain = tb.ballast_plain(ta, tb_, 32).numpy()
    assert np.abs(got - plain).max() <= 1e-5 * np.abs(plain).max()


def test_ballast_route_by_width_and_the_kernels_limits():
    """The wrapper's routes: "cluster" where b's column slices fit a
    cluster's shared memory, "stream" for every other N the kernel takes,
    N = 1024 included; it raises where the kernel raised before: N past
    1024, or not a multiple of 4."""
    assert tb.ballast_route(256) == "cluster"
    assert {tb.ballast_route(n) for n in tb.CLUSTER_SIZE} == {"cluster"}
    for n in (4, 100, 192, 384, 512, 1020, 1024):
        assert tb.ballast_route(n) == "stream"
    for n in (1028, 2048, 130, 1022):
        with pytest.raises(ValueError, match="N <= 1024 and a multiple of 4"):
            tb.ballast_route(n)
    # on the CPU the wrapper still takes N = 1024 (its plain version)
    a = torch.zeros((256, 1024))
    got = tb.ballast(a, torch.eye(1024) * 0.999, 1)
    assert got.shape == (256, 1024)


@pytest.mark.parametrize("n,route,cluster", [(256, "cluster", 2),
                                             (128, "cluster", 2),
                                             (64, "cluster", 1),
                                             (384, "stream", 0),
                                             (1024, "stream", 0)])
def test_launch_route_hands_the_kernel_its_route(monkeypatch, n, route,
                                                 cluster):
    """``launch_route`` passes the route's cluster size (0 for "stream")
    and the operands' shapes and types to the C entry point."""
    seen = []
    monkeypatch.setattr(tb.BALLAST_KERNEL, "launch",
                        lambda *args: seen.append(args))
    monkeypatch.setattr(tb, "stream_of", lambda t: None)
    a = torch.zeros((96, n), dtype=torch.bfloat16)
    b = torch.zeros((n, n))
    out = tb.launch_route(a, b, 7, 0.999, tb.ballast_route(n))
    assert out.shape == (96, n) and out.dtype == torch.float32
    (args,) = seen
    M, N, n_iter, decay, a_bf16, b_bf16, c = args[3:10]
    assert (M, N, n_iter, a_bf16, b_bf16, c) == (96, n, 7, 1, 0, cluster)
    assert abs(decay - 0.999) < 1e-12
    assert tb.ballast_route(n) == route
    with pytest.raises(ValueError, match="no route"):
        tb.launch_route(a, b, 7, 0.999, "tensor-cores")
