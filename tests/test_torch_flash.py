"""Kernel F's wrapper on the CPU (its plain version) against the
reference's ``flash_sdpa`` run in Pallas interpret mode, at the cases of
``tests/test_kernels.py`` (same q_block 32 and kv_chunk 16): f32 within
1e-5 of max |reference|, bf16 within 2^-8 of it (both round once from
f32).  Both are also held to the float64 dense oracle."""
import functools

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


# ---------------------------------------------------------------------------
# kernel F's bf16 arithmetic on the tensor cores, emulated on the CPU
# ---------------------------------------------------------------------------

ORACLE_BF16_TOL = 2.0 ** -7
EMULATED_SHAPES = [((1, 64, 2, 2, 16), 16), ((2, 128, 1, 4, 8), 8),
                   ((1, 96, 3, 1, 32), 32), ((1, 256, 2, 1, 192), 128),
                   ((1, 4096, 1, 4, 128), 128)]


def _kernel_bn(Dv):
    """kv positions per tile of the bf16 kernel (``Plan::kBN`` in
    ``csrc/flash_wgmma.cuh``) for the shapes here: 128 up to two 64-column
    chunks of v."""
    return 128 if -(-Dv // 64) <= 2 else 64


def emulate_bf16_kernel(q, k, v, causal, bn, split_p):
    """The bf16 kernel's rounding in torch on the CPU: f32 scores of the
    bf16 q and k, scaled afterwards; per tile of ``bn`` kv positions the
    online softmax in f32; P rounded to bf16 (with ``split_p``, as hi +
    lo, two bf16 terms) before P V with f32 sums, l summing the weights P V
    applies; the output divided by max(l, 1e-30) and rounded to bf16."""
    B, S, KV, G, D = q.shape
    T, Dv = k.shape[1], v.shape[-1]
    qf = q.float().permute(0, 2, 1, 3, 4).reshape(B, KV, S * G, D)
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)
    pos = torch.arange(S * G) // G
    m = torch.full((B, KV, S * G), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, S * G, Dv))
    for t0 in range(0, T, bn):
        s = (qf @ kf[:, :, t0:t0 + bn].transpose(-1, -2)) * D ** -0.5
        if causal:
            col = t0 + torch.arange(s.shape[-1])
            s = torch.where(pos[:, None] >= col[None, :], s,
                            torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        e = torch.exp(s - m_new[..., None])
        p = e.bfloat16().float()
        if split_p:
            p = p + (e - p).bfloat16().float()
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p @ vf[:, :, t0:t0 + bn]
        m = m_new
    o = acc / torch.clamp_min(l, 1e-30)[..., None]
    return o.reshape(B, KV, S, G, Dv).permute(0, 2, 1, 3, 4).to(q.dtype)


@functools.lru_cache(maxsize=None)
def bf16_budget(shape, Dv, split_p, causal=True):
    """The emulated kernel's errors as fractions of phase 11's bf16 gates:
    (against flash_forward_plain / 2^-8, against the float64 oracle /
    2^-7), both of max |plain|."""
    B, S, KV, G, D = shape
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(shape, S, Dv, B * S))
    plain = port_flash.flash_forward_plain(
        q, k, v, q_block=min(2048, S), kv_chunk=min(1024, S),
        causal=causal).float()
    got = emulate_bf16_kernel(q, k, v, causal, _kernel_bn(Dv), split_p).float()
    scale = plain.abs().max().item()
    err = (got - plain).abs().max().item() / scale
    err_oracle = (got.double() - flash_ref(q, k, v, causal=causal)
                  ).abs().max().item() / scale
    return err / BF16_TOL, err_oracle / ORACLE_BF16_TOL


@pytest.mark.parametrize("shape,Dv", EMULATED_SHAPES)
def test_emulated_split_p_within_phase11_gates(shape, Dv):
    """P as hi + lo bf16 terms, the kernel's choice, holds both gates."""
    plain_frac, oracle_frac = bf16_budget(shape, Dv, split_p=True)
    assert plain_frac <= 1.0 and oracle_frac <= 1.0


@pytest.mark.parametrize("shape,Dv", EMULATED_SHAPES)
def test_emulated_bf16_p_against_phase11_gates(shape, Dv):
    """P rounded once to bf16 holds the float64 oracle's gate, and uses at
    least as much of the plain version's gate as hi + lo."""
    plain_frac, oracle_frac = bf16_budget(shape, Dv, split_p=False)
    assert oracle_frac <= 1.0
    assert plain_frac >= bf16_budget(shape, Dv, split_p=True)[0]


def test_bf16_p_alone_breaks_the_plain_gate_so_the_kernel_splits_p():
    """One bf16 P moves the output past 2^-8 of max |plain| at a shape of
    the set (q [1, 96, 3, 1, 32]); this is why P V takes hi and lo."""
    worst = max(bf16_budget(shape, Dv, split_p=False)[0]
                for shape, Dv in EMULATED_SHAPES)
    assert worst > 1.0


@pytest.mark.parametrize("D", [20, 24, 40])
def test_wrapper_takes_a_bf16_head_dim_not_a_multiple_of_16(D):
    """The checks accept it (the CPU runs the plain version), and the
    kernel's operands are zero-padded to a multiple of 8 only where D is 4
    mod 8, on a 16-byte boundary, with q k^T unchanged."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs((1, 32, 2, 2, D), 32, D, D))
    got = port_flash.flash_forward(q, k, v, q_block=32, kv_chunk=16)
    assert torch.equal(got, port_flash.flash_forward_plain(
        q, k, v, q_block=32, kv_chunk=16))
    qk, kk = (port_flash._kernel_operand(t, True) for t in (q, k))
    assert qk.shape[-1] == -(-D // 8) * 8 and qk.data_ptr() % 16 == 0
    assert torch.equal(qk[..., :D], q) and not qk[..., D:].any()
    assert torch.equal(qk.float() @ kk.float().transpose(-1, -2)[..., 0, :, :],
                       q.float() @ k.float().transpose(-1, -2)[..., 0, :, :])


def test_kernel_operand_moves_a_misaligned_bf16_view_and_leaves_f32():
    base = torch.zeros(1 + 64, dtype=torch.bfloat16)
    view = base[1:].view(1, 8, 8)                 # 2 bytes past the start
    moved = port_flash._kernel_operand(view, True)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, view)
    f32 = torch.zeros(2, 3, 20)
    assert port_flash._kernel_operand(f32, False) is f32


if __name__ == "__main__":
    # how much of phase 11's bf16 gates each P V choice uses, per shape
    for shape, Dv in EMULATED_SHAPES:
        for split_p in (False, True):
            a, b = bf16_budget(shape, Dv, split_p)
            print(f"q {list(shape)} Dv {Dv} {'hi+lo P' if split_p else 'bf16 P':8s}"
                  f": {a:.3f} of 2^-8 (vs plain), {b:.3f} of 2^-7 (vs float64)")
