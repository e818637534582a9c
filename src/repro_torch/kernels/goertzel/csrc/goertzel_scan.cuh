// Shared by the sliding-Goertzel kernels (monitor.cu, kernel A, and
// sliding_walk.cuh, kernels E and I): the modulated prefix-sum step and
// the block scan that they build their per-bin prefix tables with, and
// the amplitude with its warm-up scale.  The kernels must produce the
// same prefixes and amplitudes from the same samples, bit for bit, so
// they take them from this one source.
//
// The scan is a Hillis-Steele tree over lanes and then over warps: a
// thread's exclusive offset sums the partial sums of the threads before it
// and nothing after, so a prefix at offset j depends on samples <= j alone
// and the zero tail of a partial segment cannot change a bit of it.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// one step of a bin's modulated prefix sum: re += x cos, im += x (-sin)
__device__ __forceinline__ void accum(float x, float c, float s, float& re,
                                      float& im) {
  re = __fmaf_rn(x, c, re);
  im = __fmaf_rn(x, -s, im);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 shfl_up4(float4 v, int d) {
  return make_float4(__shfl_up_sync(kFull, v.x, d),
                     __shfl_up_sync(kFull, v.y, d),
                     __shfl_up_sync(kFull, v.z, d),
                     __shfl_up_sync(kFull, v.w, d));
}

// Block-wide exclusive prefix sum of one float4 per thread.
__device__ float4 block_exclusive_scan(float4 v, float4* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 inc = v;
  for (int d = 1; d < 32; d <<= 1) {
    const float4 up = shfl_up4(inc, d);
    if (lane >= d) inc = add4(inc, up);
  }
  float4 exc = shfl_up4(inc, 1);
  if (lane == 0) exc = zero;
  __syncthreads();  // the previous call's readers are done with warp_tot
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    float4 t = lane < kWarps ? warp_tot[lane] : zero;
    for (int d = 1; d < kWarps; d <<= 1) {
      const float4 up = shfl_up4(t, d);
      if (lane >= d) t = add4(t, up);
    }
    float4 te = shfl_up4(t, 1);
    if (lane == 0) te = zero;
    if (lane < kWarps) warp_tot[lane] = te;
  }
  __syncthreads();
  return add4(warp_tot[warp], exc);
}

// The amplitude of one sample from its prefixes (pr, pi), the previous
// segment's (qr, qi) and total (Tr, Ti), and the bin's rotation:
//   2/win |pr + j pi + e^{j w win} (T - q)| * scale.
// Each rounding step is written out, so no kernel's compilation can fuse
// it another way (left to the compiler, the same expression was fused two
// ways in two kernels).  A scale of exactly 1 (kernel I) changes no bit.
__device__ __forceinline__ float amplitude(float pr, float pi, float qr,
                                           float qi, float Tr, float Ti,
                                           float rr, float ri, float scale,
                                           float two_over_win) {
  const float dr = __fsub_rn(Tr, qr), di = __fsub_rn(Ti, qi);
  const float mr = __fmaf_rn(-ri, di, __fmaf_rn(rr, dr, pr));
  const float mi = __fmaf_rn(ri, dr, __fmaf_rn(rr, di, pi));
  const float m2 = __fmaf_rn(mr, mr, __fmul_rn(mi, mi));
  return __fmul_rn(__fmul_rn(two_over_win, __fsqrt_rn(m2)), scale);
}

// The warm-up scale win / min(idx + 1, win) at global index idx; past the
// warm-up it is win / win, exactly 1, so a run with no sample in the
// warm-up (kWarm false) skips the division.
template <bool kWarm>
__device__ __forceinline__ float warmup_scale(long long idx, int win) {
  return kWarm && idx + 1 < win ? __fdiv_rn((float)win, (float)(idx + 1))
                                : 1.0f;
}

}  // namespace
