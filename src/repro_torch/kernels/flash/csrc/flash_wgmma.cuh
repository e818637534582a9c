// Kernel F's bf16 instantiation: GQA flash attention on Hopper's tensor
// cores (wgmma), with k and v brought in by the Tensor Memory Accelerator.
//
// Same function as flash_fwd.cu's f32 kernel and the reference's
// flash_pallas (src/repro/kernels/flash/flash.py:64): q [B, S, KV, G, D],
// k [B, T, KV, D], v [B, T, KV, Dv] in bf16 -> o [B, S, KV, G, Dv] in bf16.
// On the TPU the reference's f32 dots run as one bf16 pass with f32 sums;
// here QK^T is a bf16 x bf16 product with f32 accumulators, the scale
// D^-1/2 is applied to the f32 scores (folded with log2(e) for exp2), and
// P V takes P as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), each
// against bf16 v with f32 accumulators: one bf16 P alone moves the output
// by up to 2^-8 of max |plain| at the prefill's shape, the gate itself
// (tests/test_torch_flash.py emulates both choices).  The row sum l adds
// hi + lo, the weights P V applies.
//
// Design.  A block takes 128 consecutive query rows of one (batch, kv
// head), row = position * G + group head as in the reference's
// q.reshape(qb * G, D), and runs three warpgroups: two consumers of 64
// rows each and a producer, which hands its registers to the consumers
// (setmaxnreg: 40 a thread against 232).  The producer's first thread
// keeps a ring of kStages shared-memory stages filled with BN-position
// tiles of k and v, each as 64-column chunks copied by TMA (4-D tensor
// maps built on the host from k's and v's own strides, 128-byte swizzle,
// zero fill past D, Dv and T) and announced on a full mbarrier; each
// consumer warp frees a stage on its empty mbarrier.  The consumers load
// their q rows once with 16-byte loads into the same swizzled layout (a
// TMA box covers whole positions only when G divides 128).  Per tile each
// warpgroup issues S = Q K^T as wgmma m64nBNk16 from shared memory, then
// the online softmax in registers in the accumulator layout (a row's max
// and partial sums stay in the 4 threads of a quad), then O += P V as
// wgmma m64n64k16 with P in registers as the A operand and v's chunks as
// the transposed (MN-major) B operand; the two warpgroups overlap each
// other's softmax and products as they drift.  The mask is one compare
// and select a score, with no branch: pos_q < pos_k scores NEG = -1e30
// with pos = row / G, and so do columns past T (zero-filled k); only a
// tile on the diagonal or at T's edge sets a limit below BN.  (With a
// branch per score on those tiles instead, a causal launch took longer
// than a full one on the H100.)
// A causal block stops after the tile holding its last row's position (a
// later tile is all NEG: alpha = 1, p = 0, no bit changes).  Blocks take
// the (batch, kv heads) in turn, heaviest row block first, so that the
// blocks in flight share one head's k and v in L2.  The epilogue divides
// by max(l, 1e-30), rounds to bf16 and stores from the accumulators: a
// quad writes 16 contiguous bytes of a row per 8 columns.
//
// Bound on this card: operations, 2 (D + Dv) flops per (query row, key)
// pair at 989 TFLOP/s bf16; the lo term of P adds Dv per pair.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash_wgmma {

constexpr int kRows = 128;        // query rows per block
constexpr int kStages = 2;        // k, v ring depth
constexpr int kThreads = 384;     // two consumer warpgroups + the producer's
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// shared memory of a launch: the alignment pad, q (dc 64-column chunks of
// [kRows][128 bytes]), the ring of k (dc chunks) and v (vc chunks) at bn
// positions a stage, and the mbarriers
__host__ __device__ constexpr int smem_bytes(int dc, int vc, int bn) {
  return 1024 + kRows * 128 * dc + kStages * bn * 128 * (dc + vc) +
         16 * kStages;
}

// kv positions a tile: 128 where the accumulators (vc <= 2) and the ring
// fit, else 64
__host__ __device__ constexpr int tile_positions(int dc, int vc) {
  return vc <= 2 && smem_bytes(dc, vc, 128) <= kSmemMax ? 128 : 64;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the barrier's phase of this parity has completed; a copy
// that never lands traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    if (clock64() - t0 > (1ll << 34)) __trap();   // about 10 s
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: 8-row
// groups 1024 bytes apart (SBO); lbo is the distance between 64-column
// chunks of an MN-major operand (unused by a K-major one)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of accumulator registers
// across a wgmma's issue and its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers, B MN-major in
// shared memory (the transposed layout, 16-bit types only)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// VC 64-column chunks of v and BN positions a tile are compiled in (they
// size the accumulators); the DC chunks of q and k are a launch argument
template <int VC, int BN>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __nv_bfloat16* __restrict__ q,
                   __nv_bfloat16* __restrict__ o, int S, int Tn, int KV,
                   int G, int D, int Dv, int causal, float scale_log2,
                   int row_blocks) {
  const int DC = (D + 63) / 64;
  const int q_bytes = kRows * 128 * DC;
  const int stage_bytes = BN * 128 * (DC + VC);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;                  // [DC][kRows][128 B]
  uint8_t* ring = qs + q_bytes;        // [kStages][DC + VC][BN][128 B]
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + kStages * stage_bytes);
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * kStages;

  const int tid = threadIdx.x;
  // one (batch, kv head) after another, so that the blocks in flight share
  // its k and v in L2; its heaviest row blocks first
  const int bh = blockIdx.x / row_blocks;               // b * KV + h
  const int rb = row_blocks - 1 - blockIdx.x % row_blocks;
  const int b = bh / KV, h = bh % KV;
  const long long rows = (long long)S * G;
  const long long row0 = (long long)rb * kRows;
  const long long last_row = (row0 + kRows < rows ? row0 + kRows : rows) - 1;
  int tiles = (Tn + BN - 1) / BN;
  if (causal) {
    const long long need = last_row / G / BN + 1;
    if (need < tiles) tiles = (int)need;
  }

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one if/else for the roles, never rejoined, so that setmaxnreg holds:
  // the producer warpgroup gives its registers to the consumers
  if (tid >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    // the producer: thread 256 issues every copy
    if (tid == 256) {
      for (int j = 0; j < tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty0 + 8 * s, (j / kStages - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, stage_bytes);
        const uint32_t st = smem_u32(ring + s * stage_bytes);
        for (int c = 0; c < DC; ++c)
          tma_load_4d(st + c * BN * 128, &kmap, full, 64 * c, h, j * BN, b);
#pragma unroll
        for (int c = 0; c < VC; ++c)
          tma_load_4d(st + (DC + c) * BN * 128, &vmap, full, 64 * c, h,
                      j * BN, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

    // a consumer warpgroup: rows wg * 64 .. wg * 64 + 63 of the block
    const int wg = tid >> 7, wtid = tid & 127, warp = wtid >> 5;
    const int lane = tid & 31;
    {
      const int units = D >> 3;   // 16-byte units of a q row
      for (int i = wtid; i < 64 * 8 * DC; i += 128) {
        const int r = i / (8 * DC), u = i - r * (8 * DC);
        const long long f = row0 + wg * 64 + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (f < rows && u < units) {
          const long long s = f / G, g = f - s * G;
          val = *reinterpret_cast<const uint4*>(
              q + (((long long)b * S + s) * KV + h) * G * D + g * D + u * 8);
        }
        const int rr = wg * 64 + r;
        *reinterpret_cast<uint4*>(qs + (u >> 3) * (kRows * 128) + rr * 128 +
                                  (((u & 7) ^ (rr & 7)) << 4)) = val;
      }
      // make the generic-proxy stores visible to wgmma, then wait for the
      // warpgroup's 128 threads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
    }

    // this thread's two rows: r_a and r_a + 8 of the warpgroup
    const int r_a = warp * 16 + (lane >> 2);
    const long long f_a = row0 + wg * 64 + r_a, f_b = f_a + 8;
    const long long pos_a = f_a / G, pos_b = f_b / G;
    const long long first_pos = row0 / G;

    float acc[VC][32];
#pragma unroll
    for (int c = 0; c < VC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;
    const uint32_t q_base = smem_u32(qs) + wg * 64 * 128;

    for (int j = 0; j < tiles; ++j) {
      const int st = j % kStages;
      mbar_wait(full0 + 8 * st, (j / kStages) & 1);
      const uint32_t k_base = smem_u32(ring + st * stage_bytes);
      const uint32_t v_base = k_base + DC * BN * 128;

      // S = Q K^T over D in steps of 16 (32 bytes inside a 128-byte row)
      float s[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll 4
      for (int kk = 0; kk < 4 * DC; ++kk) {
        const int c = kk >> 2, kin = kk & 3;
        const uint64_t da = desc_sw128(q_base + c * kRows * 128 + kin * 32, 16);
        const uint64_t db = desc_sw128(k_base + c * BN * 128 + kin * 32, 16);
        if constexpr (BN == 128)
          wgmma_ss_n128(s, da, db, kk > 0);
        else
          wgmma_ss_n64(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);

      // scale (log2 domain), mask, running max.  Element i of the
      // accumulator is column t0 + c0 + e(i) of the tile, e(i) = 8 (i / 4)
      // + i % 2, c0 = 2 (lane % 4); a column past min(pos, T - 1) scores
      // NEG.  Only a tile on the diagonal or at T's edge has such columns;
      // elsewhere the limits stay at BN and the selects change nothing.
      const int t0 = j * BN, c0 = 2 * (lane & 3);
      int lim_a = BN, lim_b = BN;
      if (t0 + BN > Tn || (causal && t0 + BN - 1 > first_pos)) {
        const long long last = (long long)Tn - 1;
        const long long la = causal && pos_a < last ? pos_a : last;
        const long long lb = causal && pos_b < last ? pos_b : last;
        lim_a = (int)(la - t0 - c0 < BN ? la - t0 - c0 : BN);
        lim_b = (int)(lb - t0 - c0 < BN ? lb - t0 - c0 : BN);
      }
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int e = (i >> 2) * 8 + (i & 1);
        const float x = e > ((i & 2) ? lim_b : lim_a) ? kNeg
                                                     : s[i] * scale_log2;
        s[i] = x;
        if (i & 2)
          mx_b = fmaxf(mx_b, x);
        else
          mx_a = fmaxf(mx_a, x);
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      const float alpha_a = exp2f(m_a - mx_a), alpha_b = exp2f(m_b - mx_b);
      m_a = mx_a;
      m_b = mx_b;

      // p = exp2(x - m) as bf16 hi and lo, in the A-fragment order of
      // m64n16k16: a0 (row r, cols c, c+1), a1 (row r+8), a2 (row r, cols
      // c+8, c+9), a3 (row r+8, cols c+8, c+9)
      uint32_t p_hi[BN / 16][4], p_lo[BN / 16][4];
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int i = 8 * kk + 2 * t;
          const float m = (t & 1) ? m_b : m_a;
          const float e0 = exp2f(s[i] - m), e1 = exp2f(s[i + 1] - m);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(e0, e1);
          const float2 hf = __bfloat1622float2(hi);
          const __nv_bfloat162 lo =
              __floats2bfloat162_rn(e0 - hf.x, e1 - hf.y);
          const float2 lf = __bfloat1622float2(lo);
          p_hi[kk][t] = *reinterpret_cast<const uint32_t*>(&hi);
          p_lo[kk][t] = *reinterpret_cast<const uint32_t*>(&lo);
          const float w = (hf.x + lf.x) + (hf.y + lf.y);
          if (t & 1)
            sum_b += w;
          else
            sum_a += w;
        }
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;
#pragma unroll
      for (int c = 0; c < VC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] *= (i & 2) ? alpha_b : alpha_a;

      // O += P V: v chunk c is B [BN x 64], N contiguous; 16 positions are
      // 16 rows of 128 bytes
#pragma unroll
      for (int c = 0; c < VC; ++c) fence_regs(acc[c]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int c = 0; c < VC; ++c) {
          const uint64_t dv =
              desc_sw128(v_base + c * BN * 128 + kk * 16 * 128, BN * 128);
          wgmma_rs_n64(acc[c], p_hi[kk], dv);
          wgmma_rs_n64(acc[c], p_lo[kk], dv);
        }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int c = 0; c < VC; ++c) fence_regs(acc[c]);
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
    }

    // the row sums over the quad, then o = acc / max(l, 1e-30) in bf16
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long f = half ? f_b : f_a;
      if (f >= rows) continue;
      const float den = half ? den_b : den_a;
      const long long s = f / G, g = f - s * G;
      __nv_bfloat16* orow =
          o + (((long long)b * S + s) * KV + h) * G * Dv + g * Dv;
#pragma unroll
      for (int c = 0; c < VC; ++c)
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          const int col = 64 * c + 8 * jb + 2 * (lane & 3);
          const int i = 4 * jb + 2 * half;
          if (col < Dv)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(acc[c][i] / den, acc[c][i + 1] / den);
        }
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime,
// so that the library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [B, T, KV, inner] bf16 tensor as 4-D tiles of 64 x 1 x bn x 1
inline int kv_map(CUtensorMap* map, const void* base, int inner, int KV,
                  int Tn, int B, int bn) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)inner, (cuuint64_t)KV,
                              (cuuint64_t)Tn, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)inner * 2,
                                 (cuuint64_t)KV * inner * 2,
                                 (cuuint64_t)Tn * KV * inner * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)bn, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int VC, int BN>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Tn, int KV, int G, int D, int Dv, int causal, float scale,
           cudaStream_t stream) {
  const int smem = smem_bytes((D + 63) / 64, VC, BN);
  CUtensorMap kmap, vmap;
  int err = kv_map(&kmap, k, D, KV, Tn, B, BN);
  if (!err) err = kv_map(&vmap, v, Dv, KV, Tn, B, BN);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_kernel<VC, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const long long row_blocks = ((long long)S * G + kRows - 1) / kRows;
  const long long blocks = row_blocks * B * KV;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_wgmma_kernel<VC, BN><<<(unsigned)blocks, kThreads, smem, stream>>>(
      kmap, vmap, (const __nv_bfloat16*)q, (__nv_bfloat16*)o, S, Tn, KV, G, D,
      Dv, causal, scale * kLog2e, (int)row_blocks);
  return (int)cudaGetLastError();
}

// D and Dv multiples of 8 up to 256 (16-byte rows for TMA and q's loads)
inline int dispatch(const void* q, const void* k, const void* v, void* o,
                    int B, int S, int Tn, int KV, int G, int D, int Dv,
                    int causal, float scale, cudaStream_t stream) {
  if (D % 8 || Dv % 8 || D > 256 || Dv > 256) return (int)cudaErrorInvalidValue;
  const int dc = (D + 63) / 64, vc = (Dv + 63) / 64;
  const bool wide = tile_positions(dc, vc) == 128;
  switch (vc * 2 + wide) {
    case 3: return launch<1, 128>(q, k, v, o, B, S, Tn, KV, G, D, Dv, causal, scale, stream);
    case 4: return launch<2, 64>(q, k, v, o, B, S, Tn, KV, G, D, Dv, causal, scale, stream);
    case 5: return launch<2, 128>(q, k, v, o, B, S, Tn, KV, G, D, Dv, causal, scale, stream);
    case 6: return launch<3, 64>(q, k, v, o, B, S, Tn, KV, G, D, Dv, causal, scale, stream);
    case 8: return launch<4, 64>(q, k, v, o, B, S, Tn, KV, G, D, Dv, causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace flash_wgmma
