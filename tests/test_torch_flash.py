"""Kernel F's wrapper on the CPU (its plain version) against the
reference's ``flash_sdpa`` run in Pallas interpret mode, at the cases of
``tests/test_kernels.py`` (same q_block 32 and kv_chunk 16): f32 within
1e-5 of max |reference|, bf16 within 2^-8 of it (both round once from
f32).  Both are also held to the float64 dense oracle."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash.ops import flash_sdpa as jax_flash_sdpa  # noqa: E402
from repro_torch.kernels.flash import flash as port_flash  # noqa: E402
from repro_torch.kernels.flash.ops import flash_sdpa  # noqa: E402
from repro_torch.kernels.flash.ref import flash_ref  # noqa: E402

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -8


def _inputs(shape_q, T, Dv, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    B, S, KV, G, D = shape_q
    q = rng.standard_normal(shape_q, dtype=np.float32)
    k = rng.standard_normal((B, T, KV, D), dtype=np.float32)
    v = rng.standard_normal((B, T, KV, Dv), dtype=np.float32)
    return q, k, v


def _both(q, k, v, causal, bf16=False):
    jt = [jnp.asarray(a) for a in (q, k, v)]
    tt = [torch.from_numpy(a) for a in (q, k, v)]
    if bf16:
        jt = [a.astype(jnp.bfloat16) for a in jt]
        tt = [a.to(torch.bfloat16) for a in tt]
    ref = jax_flash_sdpa(*jt, causal=causal, q_block=32, kv_chunk=16,
                         interpret=True)
    got = flash_sdpa(*tt, causal=causal, q_block=32, kv_chunk=16)
    return (np.asarray(ref.astype(jnp.float32)), got.float().numpy(),
            flash_ref(*tt, causal=causal).numpy())


@pytest.mark.parametrize("B,S,KV,G,D", [(1, 64, 2, 2, 16), (2, 128, 1, 4, 8),
                                        (1, 96, 3, 1, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_reference_interpret(B, S, KV, G, D, causal):
    q, k, v = _inputs((B, S, KV, G, D), S, D, B * S)
    ref, got, oracle = _both(q, k, v, causal)
    assert got.shape == ref.shape == (B, S, KV, G, D)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= F32_TOL * scale
    assert np.abs(got - oracle).max() <= F32_TOL * scale


def test_flash_mla_vdim():
    """V head dim != QK head dim (the MLA layout)."""
    q, k, v = _inputs((1, 64, 2, 1, 24), 64, 16, 7)
    ref, got, oracle = _both(q, k, v, True)
    assert got.shape == (1, 64, 2, 1, 16)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= F32_TOL * scale
    assert np.abs(got - oracle).max() <= F32_TOL * scale


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16(causal):
    q, k, v = _inputs((1, 64, 2, 2, 16), 64, 16, 9)
    ref, got, oracle = _both(q, k, v, causal, bf16=True)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= BF16_TOL * scale
    assert np.abs(got - oracle).max() <= 2.0 ** -7 * scale


def test_blocks_clamp_to_the_sequence_and_cpu_launches_nothing():
    """ops.flash_sdpa clamps the blocks to S and T, as the reference's
    ops.py does; the CPU path is the plain version and counts no launch."""
    q, k, v = (torch.from_numpy(a) for a in _inputs((1, 24, 1, 2, 8), 24, 8, 3))
    before = port_flash.FLASH_KERNEL.launches
    got = flash_sdpa(q, k, v)                      # blocks 2048, 1024 -> 24
    plain = port_flash.flash_forward_plain(q, k, v, q_block=24, kv_chunk=24)
    assert torch.equal(got, plain)
    assert port_flash.FLASH_KERNEL.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _inputs((1, 64, 2, 2, 16), 64, 16, 1))
    with pytest.raises(ValueError, match="q blocks"):
        port_flash.flash_forward(q, k, v, q_block=48, kv_chunk=16)
    with pytest.raises(ValueError, match="share one of"):
        port_flash.flash_forward(q, k.double(), v, q_block=32, kv_chunk=16)
    with pytest.raises(ValueError, match=r"k must be"):
        port_flash.flash_forward(q, k[:, :, :1], v, q_block=32, kv_chunk=16)
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="no kernel for meta"):
        port_flash.flash_forward(*meta, q_block=32, kv_chunk=16)
