// Per-bin sliding-Goertzel amplitudes in the v1 (bin-minor) layout: kernel
// I of the port.
//
// Replaces the reference's Pallas kernel sliding_goertzel_pallas
// (src/repro/kernels/goertzel/goertzel.py:137, body _sliding_kernel at
// :106).  Operands: xseg [S, win] f32 (the centred, zero-padded trace in
// window-sized segments), cosp/sinp [win, K] f32 (cos/sin of w_k p) and
// rot [2, K] f32 ([cos; sin] of w_k win).  Output [S, win, K] f32: for
// segment s, offset j and bin k
//   2/win |P_s[j] + e^{j w_k win} (P_{s-1}[win-1] - P_{s-1}[j])|,
// with P_s the modulated prefix sums of segment s restarted at its start
// and P_{-1} = 0.  No warm-up scale: the caller applies it, as the
// reference's benchmark wrapper does.
//
// Design: kernel E's (sliding.cu), with no state in or out.  One block per
// segment; the previous segment's prefix table depends only on the
// previous segment's input, so each block recomputes it and blocks need no
// order (the TPU kernel carries it in scratch across a sequential grid
// instead).  Per bin, each thread's partial sums over a contiguous run of
// samples, the block scan of goertzel_scan.cuh (shared with kernels A and
// E), and a second pass that produces the prefixes: the same steps as E,
// so with the warm-up scale applied after, I equals E bit for bit on the
// same segments.
//
// Layout.  A thread walks its run one bin at a time, so it reads the
// tables along the samples.  In the [win, K] layout those reads are K
// floats apart and fill L1 with the other bins' entries; a first small
// kernel therefore copies the tables to [K, win] rows (a scratch buffer
// the wrapper allocates, 8 win K bytes), and the main kernel reads rows.
// The amplitudes are stored as E stores them, one bin at a time, K floats
// apart across a run; L2 merges them before they reach memory.  At
// [150 x 4000, K 7] on an H100 (tools/sliding_v1_layouts.py) this takes
// 0.178 ms with the copy; reading the [win, K] tables takes 0.213 ms, and
// staging a segment's [win, K] amplitudes in shared memory to store them
// coalesced 0.202 ms (its 112 KB take L1's room), 0.362 ms with both.
//
// Bound on this card: bytes (4 per sample read, 4K written), about 20 f32
// operations per sample and bin against them, 5 per byte, under the f32
// ridge of about 20.  Recomputing the previous segment doubles the
// arithmetic and the reads of x, which hit in L2.
#include <cuda_runtime.h>

#include "goertzel_scan.cuh"

namespace {

// [win, K] tables -> [2, K, win] rows: cos then sin
__global__ void transpose_tables(const float* __restrict__ cosp,
                                 const float* __restrict__ sinp,
                                 float* __restrict__ rows, int win, int K) {
  const long long n = (long long)K * win;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < 2 * n; i += (long long)gridDim.x * blockDim.x) {
    const long long t = i % n;
    const int k = (int)(t / win), j = (int)(t % win);
    rows[i] = (i < n ? cosp : sinp)[(long long)j * K + k];
  }
}

__global__ void __launch_bounds__(kThreads) sliding_v1_kernel(
    const float* __restrict__ xseg, const float* __restrict__ rows,
    const float* __restrict__ rot, float* __restrict__ out, int win,
    int K) {
  __shared__ float4 warp_tot[kWarps];
  __shared__ float2 prev_total;

  const int s = blockIdx.x;
  const long long seg_off = (long long)s * win;
  const float* xc = xseg + seg_off;
  const float* xp = s > 0 ? xc - win : nullptr;
  float* aout = out + seg_off * K;
  const int chunk = (win + kThreads - 1) / kThreads;
  const int lo = min((int)threadIdx.x * chunk, win);
  const int hi = min(lo + chunk, win);
  const float two_over_win = (float)(2.0 / (double)win);

  for (int k = 0; k < K; ++k) {
    const float* c = rows + (long long)k * win;
    const float* sn = rows + ((long long)K + k) * win;
    // pass 1: this thread's partial sums over its run, for the segment
    // (x, y) and the previous one (z, w)
    float4 part = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = lo; j < hi; ++j) {
      accum(xc[j], c[j], sn[j], part.x, part.y);
      if (xp) accum(xp[j], c[j], sn[j], part.z, part.w);
    }
    const float4 off = block_exclusive_scan(part, warp_tot);
    // the previous segment's prefix at win-1, by the thread that owns that
    // sample with the same recurrence as pass 2
    if (lo <= win - 1 && win - 1 < hi) {
      float tr = 0.f, ti = 0.f;
      if (xp) {
        tr = off.z;
        ti = off.w;
        for (int j = lo; j < hi; ++j) accum(xp[j], c[j], sn[j], tr, ti);
      }
      prev_total = make_float2(tr, ti);
    }
    __syncthreads();
    const float Tr = prev_total.x, Ti = prev_total.y;
    const float rr = rot[k], ri = rot[K + k];
    float pr = off.x, pi = off.y, qr = off.z, qi = off.w;
    // pass 2: prefixes and amplitudes
    for (int j = lo; j < hi; ++j) {
      accum(xc[j], c[j], sn[j], pr, pi);
      if (xp) {
        accum(xp[j], c[j], sn[j], qr, qi);
      } else {
        qr = 0.f;
        qi = 0.f;
      }
      const float dr = Tr - qr, di = Ti - qi;
      const float mr = pr + rr * dr - ri * di;
      const float mi = pi + rr * di + ri * dr;
      aout[(long long)j * K + k] = two_over_win * sqrtf(mr * mr + mi * mi);
    }
    // the next bin's scan starts with a barrier, so prev_total is not
    // overwritten while it is read
  }
}

}  // namespace

extern "C" int sliding_v1_launch(const void* xseg, const void* cosp,
                                 const void* sinp, const void* rot,
                                 void* rows, void* out, int S, int win, int K,
                                 void* stream) {
  if (S <= 0 || win <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = 2LL * K * win;
  const int tb = (int)((n + kThreads - 1) / kThreads < 1024
                           ? (n + kThreads - 1) / kThreads : 1024);
  transpose_tables<<<tb, kThreads, 0, st>>>(
      (const float*)cosp, (const float*)sinp, (float*)rows, win, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sliding_v1_kernel<<<S, kThreads, 0, st>>>(
      (const float*)xseg, (const float*)rows, (const float*)rot,
      (float*)out, win, K);
  return (int)cudaGetLastError();
}
