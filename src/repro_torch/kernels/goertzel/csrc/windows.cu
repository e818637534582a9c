// Goertzel resonators on disjoint windows: kernel H of the port.
//
// Replaces the reference's Pallas kernel goertzel_pallas
// (src/repro/kernels/goertzel/goertzel.py:87, body _goertzel_kernel at :67).
// For window w of windows [W, win] f32 and coefficient coef[k] =
// 2 cos(2 pi f_k dt):
//   s0 = x[t] + coef_k s1 - s2,  t = 0 .. win-1, from s1 = s2 = 0,
//   out[w, k] = 2/win sqrt(max(s1 s1 + s2 s2 - coef_k s1 s2, 0)),
// rounded as the reference runs as XLA compiles it, which contracts each
// product-and-sum into one FMA: s0 = fma(coef_k, s1, x) - s2 and power =
// fma(-(coef_k s1), s2, fma(s1, s1, s2 s2)) (JAX's goertzel_pallas in
// interpret mode equals this bit for bit on the CPU).  Each step is
// written with explicit intrinsics (__fmaf_rn, __fsub_rn, __fmul_rn), so
// nvcc's own contraction cannot change a bit, and the plain version
// (fma32 in windows.py) takes the same steps.
//
// Design.  One block per group of block_w windows, one thread per
// (window, bin).  The block stages its windows in shared memory a tile of
// samples at a time, loaded along the samples (coalesced, 16 bytes a
// thread where the rows allow it, by at least kLoadThreads threads so
// that many loads are in flight); each thread then runs its resonator
// over the tile, reading its window's row (rows are padded by one float,
// so the few windows a warp touches sit in other banks).  The recurrence
// is sequential in t: each step waits on the previous one's FMA and
// subtraction.
//
// Bound on this card: bytes, W win 4 read and W K 4 written, about 0.7 us
// for the 600 s 1 kHz trace (150 windows of 4000).  The kernel does not
// reach it: it is latency-bound by the win-step dependent chain, and W K
// threads (about a thousand) occupy a few SMs.  A parallel form of the
// recurrence (a scan of 2x2 transfer matrices over the window) would lift
// that; it would not give the reference's rounding order.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

// samples staged per tile and window, at most: keeps the tile within
// 32 KB of shared memory for any block_w
constexpr int kTileFloats = 8192;
constexpr int kMaxTile = 512;
constexpr int kLoadThreads = 256;

__global__ void windows_kernel(const float* __restrict__ windows,
                               const float* __restrict__ coef,
                               float* __restrict__ out, int win, int K,
                               int block_w, int tile, bool vec) {
  extern __shared__ float xs[];  // [block_w][tile + 1]
  const int stride = tile + 1;
  const long long w0 = (long long)blockIdx.x * block_w;
  const int i = threadIdx.x;
  const bool active = i < block_w * K;
  const int wl = active ? i / K : 0;
  const int k = active ? i % K : 0;
  const float c = coef[k];
  float s1 = 0.f, s2 = 0.f;
  for (int t0 = 0; t0 < win; t0 += tile) {
    const int len = min(tile, win - t0);
    __syncthreads();  // the previous tile's readers are done
    if (vec) {  // rows 16-byte aligned and len a multiple of 4
      const int q = len / 4;
      for (int idx = i; idx < block_w * q; idx += blockDim.x) {
        const int r = idx / q, t = idx % q * 4;
        const float4 v = *reinterpret_cast<const float4*>(
            windows + (w0 + r) * win + t0 + t);
        float* dst = xs + r * stride + t;
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      }
    } else {
      for (int idx = i; idx < block_w * len; idx += blockDim.x) {
        const int r = idx / len, t = idx % len;
        xs[r * stride + t] = windows[(w0 + r) * win + t0 + t];
      }
    }
    __syncthreads();
    if (active) {
      const float* row = xs + wl * stride;
      for (int t = 0; t < len; ++t) {
        const float s0 = __fsub_rn(__fmaf_rn(c, s1, row[t]), s2);
        s2 = s1;
        s1 = s0;
      }
    }
  }
  if (active) {
    const float power = __fmaf_rn(-__fmul_rn(c, s1), s2,
                                  __fmaf_rn(s1, s1, __fmul_rn(s2, s2)));
    out[(w0 + wl) * K + k] =
        __fmul_rn((float)(2.0 / (double)win), sqrtf(fmaxf(power, 0.f)));
  }
}

}  // namespace

extern "C" int windows_launch(const void* windows, const void* coef,
                              void* out, int W, int win, int K, int block_w,
                              void* stream) {
  if (W <= 0 || win <= 0 || K <= 0 || block_w <= 0 || W % block_w ||
      block_w * K > 1024)
    return (int)cudaErrorInvalidValue;
  int tile = kTileFloats / block_w;
  if (tile > kMaxTile) tile = kMaxTile;
  if (tile < 1) tile = 1;
  int threads = (block_w * K + 31) / 32 * 32;
  if (threads < kLoadThreads) threads = kLoadThreads;
  const size_t smem = (size_t)block_w * (tile + 1) * sizeof(float);
  const bool vec = win % 4 == 0 && tile % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(windows) % 16 == 0;
  windows_kernel<<<W / block_w, threads, smem, (cudaStream_t)stream>>>(
      (const float*)windows, (const float*)coef, (float*)out, win, K,
      block_w, tile, vec);
  return (int)cudaGetLastError();
}
