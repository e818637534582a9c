// Flash-attention forward: kernel F of the port, in two instantiations.
//
// Replaces the reference's Pallas kernel flash_pallas
// (src/repro/kernels/flash/flash.py:64, body _flash_kernel at :26).  Same
// operands and output: q [B, S, KV, G, D], k [B, T, KV, D], v [B, T, KV, Dv]
// (bf16 or f32, row-major, contiguous) -> o [B, S, KV, G, Dv] in q's dtype.
// A causal launch masks pos_q < pos_k with a score of NEG = -1e30
// (positions from 0 on both sides), and each query row keeps the online
// softmax's running max m, sum l and accumulator acc,
//   m' = max(m, max_t s),  alpha = exp(m - m'),  e = exp(s - m'),
//   l' = l alpha + sum_t e,  acc' = acc alpha + e V,
// and writes acc / max(l, 1e-30).
//
// bf16 runs on the tensor cores: wgmma with TMA copies of k and v, in
// flash_wgmma.cuh (its own note says how).  f32 runs the kernel below on the
// CUDA cores, which keeps the reference's f32 arithmetic exactly as the
// plain version does it (TF32 on the tensor cores would not hold 1e-5).
//
// The f32 kernel.  q is widened to f32 and scaled by D^-1/2 before QK^T,
// and products and sums are f32 FMAs.  A query "row" is one (position,
// group head) pair: the G heads that share a kv head are G consecutive
// rows, as the reference's q.reshape(qb * G, D).  One block of 256 threads
// takes 64 consecutive rows of one (batch, kv head) and walks k, v in tiles
// of 32 positions; the q tile (pre-scaled) stays in shared memory for the
// whole walk, and each k, v tile is staged there.  Thread (ty, tx) of a
// 16 x 16 grid owns rows 4ty..4ty+3: it computes their scores against kv
// columns tx and tx+16 of the tile, so a row's max and sum are a reduction
// over the 16 lanes of one half warp (shuffles), and it keeps the same
// rows' accumulators for output columns 4tx + 64j + (0..3), read from v as
// float4.  The scores e go through shared memory between the two products.
// A causal launch stops after the tile that holds its last row's position:
// a tile beyond it is all masked, and in the reference's masked pass over
// it alpha = exp(0) = 1 and e = 0, so skipping it changes no bit.  Blocks
// run the heaviest (last) row blocks of each head first.  Columns past T
// (a T that is not a multiple of 32) score -inf and weigh 0.
//
// Bound on this card: operations, 2 (D + Dv) per (query row, key) pair at
// 67 TFLOP/s f32 on the CUDA cores.  Per 4 columns of D a thread reads
// 4 + 2 float4 from shared memory for 32 FMAs, and per 4 kv positions
// 4 + 4 NJ float4 for 64 NJ FMAs (NJ = Dv / 64): shared-memory bandwidth
// sets the pace before the FMA units do.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_wgmma.cuh"

namespace {

constexpr int kRows = 64;       // query rows per block
constexpr int kTile = 32;       // kv positions per tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kPS = kTile + 4;  // row stride of the score tile
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// shared floats for head dims D, Dv (NJ = ceil(Dv / 64))
__host__ __device__ inline int smem_floats(int D, int NJ) {
  return kRows * D + kTile * (D + 4) + kTile * 64 * NJ + kRows * kPS;
}

template <int NJ>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S, int Tn,
                 int KV, int G, int D, int Dv, int causal, float scale,
                 int row_blocks) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][D]
  float* ks = qs + kRows * D;                   // [kTile][D + 4]
  float* vs = ks + kTile * (D + 4);             // [kTile][64 NJ]
  float* ps = vs + kTile * 64 * NJ;             // [kRows][kPS]
  const int DP = D + 4, DVP = 64 * NJ;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x / row_blocks;  // b * KV + h
  const int rb = row_blocks - 1 - blockIdx.x % row_blocks;
  const int b = bh / KV, h = bh % KV;
  const long long rows = (long long)S * G;
  const long long row0 = (long long)rb * kRows;
  const long long head_stride = (long long)KV * D;  // between positions in k
  const long long vhead_stride = (long long)KV * Dv;
  const float* kb = k + (long long)b * Tn * head_stride + (long long)h * D;
  const float* vb = v + (long long)b * Tn * vhead_stride + (long long)h * Dv;

  // the q tile, widened and scaled (the reference's q2 = q * scale)
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const long long f = row0 + r;
    float x = 0.f;
    if (f < rows) {
      const long long s = f / G, g = f - s * G;
      x = q[(((long long)b * S + s) * KV + h) * G * D + g * D + d] * scale;
    }
    qs[i] = x;
  }

  long long pos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) pos[i] = (row0 + ty * 4 + i) / G;
  const long long last_row = (row0 + kRows < rows ? row0 + kRows : rows) - 1;
  int tiles = (Tn + kTile - 1) / kTile;
  if (causal) {
    const long long need = last_row / G / kTile + 1;
    if (need < tiles) tiles = (int)need;
  }

  float m[4], l[4], acc[4][NJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  for (int tile = 0; tile < tiles; ++tile) {
    const int t0 = tile * kTile;
    __syncthreads();  // the last tile's k, v and scores are consumed
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int t = i / D, d = i - t * D;
      ks[t * DP + d] =
          t0 + t < Tn ? kb[(long long)(t0 + t) * head_stride + d] : 0.f;
    }
    for (int i = tid; i < kTile * DVP; i += kThreads) {
      const int t = i / DVP, c = i - t * DVP;
      vs[i] = (t0 + t < Tn && c < Dv)
                  ? vb[(long long)(t0 + t) * vhead_stride + c]
                  : 0.f;
    }
    __syncthreads();

    // scores of rows 4ty..4ty+3 against columns tx and tx + 16
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    for (int d = 0; d < D; d += 4) {
      const float4 k0 = *reinterpret_cast<const float4*>(&ks[tx * DP + d]);
      const float4 k1 =
          *reinterpret_cast<const float4*>(&ks[(tx + 16) * DP + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(&qs[(ty * 4 + i) * D + d]);
        s[i][0] = fmaf(a.x, k0.x, s[i][0]);
        s[i][0] = fmaf(a.y, k0.y, s[i][0]);
        s[i][0] = fmaf(a.z, k0.z, s[i][0]);
        s[i][0] = fmaf(a.w, k0.w, s[i][0]);
        s[i][1] = fmaf(a.x, k1.x, s[i][1]);
        s[i][1] = fmaf(a.y, k1.y, s[i][1]);
        s[i][1] = fmaf(a.z, k1.z, s[i][1]);
        s[i][1] = fmaf(a.w, k1.w, s[i][1]);
      }
    }

    // mask, then the online softmax step of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = t0 + tx + 16 * c;
        if (col >= Tn)
          s[i][c] = __int_as_float((int)0xff800000u);  // -inf
        else if (causal && pos[i] < col)
          s[i][c] = kNeg;
      }
      const float m_new = fmaxf(m[i], half_warp_max(fmaxf(s[i][0], s[i][1])));
      const float alpha = expf(m[i] - m_new);
      const float e0 = expf(s[i][0] - m_new), e1 = expf(s[i][1] - m_new);
      l[i] = l[i] * alpha + half_warp_sum(e0 + e1);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= alpha;
      ps[(ty * 4 + i) * kPS + tx] = e0;
      ps[(ty * 4 + i) * kPS + tx + 16] = e1;
    }
    __syncthreads();

    // acc += e V over the tile's positions
    for (int t = 0; t < kTile; t += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(&ps[(ty * 4 + i) * kPS + t]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 w = *reinterpret_cast<const float4*>(
              &vs[(t + u) * DVP + 64 * j + 4 * tx]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pu = u == 0 ? p[i].x : u == 1 ? p[i].y
                           : u == 2 ? p[i].z : p[i].w;
            acc[i][j][0] = fmaf(pu, w.x, acc[i][j][0]);
            acc[i][j][1] = fmaf(pu, w.y, acc[i][j][1]);
            acc[i][j][2] = fmaf(pu, w.z, acc[i][j][2]);
            acc[i][j][3] = fmaf(pu, w.w, acc[i][j][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long f = row0 + ty * 4 + i;
    if (f >= rows) continue;
    const long long s = f / G, g = f - s * G;
    float* orow = o + (((long long)b * S + s) * KV + h) * G * Dv + g * Dv;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 64 * j + 4 * tx + e;
        if (c < Dv) orow[c] = acc[i][j][e] / denom;
      }
  }
}

template <int NJ>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int Tn, int KV, int G, int D, int Dv, int causal,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)smem_floats(D, NJ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long row_blocks = ((long long)S * G + kRows - 1) / kRows;
  const long long blocks = row_blocks * B * KV;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_fwd_kernel<NJ><<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, S, Tn, KV,
      G, D, Dv,
      causal, scale, (int)row_blocks);
  return (int)cudaGetLastError();
}

int dispatch_f32(const void* q, const void* k, const void* v, void* o, int B,
             int S, int Tn, int KV, int G, int D, int Dv, int causal,
             float scale, cudaStream_t stream) {
  switch ((Dv + 63) / 64) {
    case 1: return launch<1>(q, k, v, o, B, S, Tn, KV, G, D, Dv, causal, scale, stream);
    case 2: return launch<2>(q, k, v, o, B, S, Tn, KV, G, D, Dv, causal, scale, stream);
    case 3: return launch<3>(q, k, v, o, B, S, Tn, KV, G, D, Dv, causal, scale, stream);
    case 4: return launch<4>(q, k, v, o, B, S, Tn, KV, G, D, Dv, causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o as above; is_bf16 selects bf16 (1) or f32 (0) for all four.
// f32 takes D and Dv that are multiples of 4 up to 256, bf16 multiples of
// 8 (the wrapper pads a bf16 D or Dv of 4 mod 8 with a zero column).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, int B, int S, int T, int KV, int G,
                                int D, int Dv, int causal, float scale,
                                int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KV <= 0 || G <= 0 || D <= 0 ||
      D % 4 || D > 256 || Dv <= 0 || Dv % 4 || Dv > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? flash_wgmma::dispatch(q, k, v, o, B, S, T, KV, G, D, Dv,
                                         causal, scale, st)
                 : dispatch_f32(q, k, v, o, B, S, T, KV, G, D, Dv, causal,
                                scale, st);
}

// the dynamic shared memory a launch at head dims D, Dv requests (bf16
// after the wrapper's padding to multiples of 8); 0 for a D or Dv the
// kernel refuses
extern "C" int flash_fwd_smem_bytes(int D, int Dv, int is_bf16) {
  if (D <= 0 || D > 256 || Dv <= 0 || Dv > 256) return 0;
  if (!is_bf16) return (int)(sizeof(float) * smem_floats(D, (Dv + 63) / 64));
  const int dc = (D + 63) / 64, vc = (Dv + 63) / 64;
  return flash_wgmma::smem_bytes(dc, vc, flash_wgmma::tile_positions(dc, vc));
}
