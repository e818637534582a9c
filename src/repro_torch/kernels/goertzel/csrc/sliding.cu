// Per-bin sliding-Goertzel amplitudes: kernel E of the port.
//
// Replaces the reference's Pallas kernel sliding_goertzel_v2_pallas
// (src/repro/kernels/goertzel/goertzel.py:250, body _sliding_kernel_v2 at
// :220 with _bin_amps_lane_major and _global_idx_scale).  Same operands and
// outputs, batched over rows: for row b, segment s, offset j and bin k the
// amplitude that kernel A (monitor.cu) computes before its reduction,
//   2/win |P_s[j] + e^{j w_k win} (P_{s-1}[win-1] - P_{s-1}[j])|
//         * win / min(idx + 1, win),   idx = (seg0 + s) win + j  (int64),
// with P_{-1} the state streamed in (re0/im0), and the last segment's
// prefix tables as the state out (nre/nim).
//
// Layout.  The amplitudes are written [B, S, win, K], bins minor, so the
// wrapper's reshape to [B, n, K] (the reference's stacked [n, K] output and
// what every caller indexes by sample) is a view, not a copy.
//
// Design: kernel A's.  One block per (row, segment).  The previous
// segment's prefix table depends only on the previous segment's input, so
// each block recomputes it (the first segment of a call reads re0/im0
// instead) and blocks need no order.  Each thread owns a contiguous run of
// samples; per bin, a sequential pass gives its partial sums of x*cos and
// x*(-sin) over its run, for the segment and the one before (one float4),
// a block scan of those gives its offsets, and a second sequential pass
// produces the prefixes and the amplitudes.  The previous segment's total
// is taken by the thread that owns sample win-1 with the same recurrence
// that the previous segment's own block uses for its prefix at win-1, and
// its prefix at j likewise, so a call that streams re0/im0 in equals the
// offline launch bit for bit.  The prefix step and the block scan come from
// goertzel_scan.cuh, shared with kernel A: the prefix at j depends on
// samples <= j alone, so the zero tail of a partial segment (the online
// carry path) cannot change a bit of it.
//
// Bound on this card: bytes.  Per sample it reads 4 bytes and writes 4K
// (one f32 per bin), against about 20 f32 operations per bin: 5 operations
// per byte, under the card's float32 ridge of about 20.  The recomputed
// previous segment doubles the arithmetic and the reads of x, which hit in
// L2, not the bytes that must cross device memory; the phase tables
// ([K, win], shared by every block) stay in L2.  The bin-minor stores are
// strided by K within a warp; L2 merges them before they reach memory.
#include <cstdint>
#include <cuda_runtime.h>

#include "goertzel_scan.cuh"

namespace {

__global__ void __launch_bounds__(kThreads) sliding_kernel(
    const float* __restrict__ xseg, const float* __restrict__ cosp,
    const float* __restrict__ sinp, const float* __restrict__ rot,
    const long long* __restrict__ seg0, const float* __restrict__ re0,
    const float* __restrict__ im0, float* __restrict__ amps,
    float* __restrict__ nre, float* __restrict__ nim, int S, int win,
    int K) {
  __shared__ float4 warp_tot[kWarps];
  __shared__ float2 prev_total;

  const long long blk = blockIdx.x;
  const int b = (int)(blk / S), s = (int)(blk % S);
  const long long seg_off = ((long long)b * S + s) * win;
  const float* xc = xseg + seg_off;
  const float* xp = s > 0 ? xc - win : nullptr;
  const float* r0 = re0 + (long long)b * K * win;
  const float* i0 = im0 + (long long)b * K * win;
  float* aout = amps + seg_off * K;
  const int chunk = (win + kThreads - 1) / kThreads;
  const int lo = min((int)threadIdx.x * chunk, win);
  const int hi = min(lo + chunk, win);
  const long long base = (seg0[b] + s) * (long long)win;
  const float two_over_win = (float)(2.0 / (double)win);
  const bool last = s == S - 1;

  for (int k = 0; k < K; ++k) {
    const float* c = cosp + (long long)k * win;
    const float* sn = sinp + (long long)k * win;
    // pass 1: this thread's partial sums over its run, for the segment
    // (x, y) and the previous one (z, w)
    float4 part = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = lo; j < hi; ++j) {
      accum(xc[j], c[j], sn[j], part.x, part.y);
      if (xp) accum(xp[j], c[j], sn[j], part.z, part.w);
    }
    const float4 off = block_exclusive_scan(part, warp_tot);
    // the previous segment's prefix at win-1, computed by the thread that
    // owns that sample with the same recurrence as pass 2
    if (lo <= win - 1 && win - 1 < hi) {
      float tr, ti;
      if (xp) {
        tr = off.z;
        ti = off.w;
        for (int j = lo; j < hi; ++j) accum(xp[j], c[j], sn[j], tr, ti);
      } else {
        tr = r0[(long long)k * win + win - 1];
        ti = i0[(long long)k * win + win - 1];
      }
      prev_total = make_float2(tr, ti);
    }
    __syncthreads();
    const float Tr = prev_total.x, Ti = prev_total.y;
    const float rr = rot[2 * k], ri = rot[2 * k + 1];
    float pr = off.x, pi = off.y, qr = off.z, qi = off.w;
    // pass 2: prefixes, amplitudes, state out
    for (int j = lo; j < hi; ++j) {
      accum(xc[j], c[j], sn[j], pr, pi);
      if (xp) {
        accum(xp[j], c[j], sn[j], qr, qi);
      } else {
        qr = r0[(long long)k * win + j];
        qi = i0[(long long)k * win + j];
      }
      const float dr = Tr - qr, di = Ti - qi;
      const float mr = pr + rr * dr - ri * di;
      const float mi = pi + rr * di + ri * dr;
      const long long idx = base + j;
      const float scale =
          (float)win / (float)(idx + 1 < win ? idx + 1 : (long long)win);
      aout[(long long)j * K + k] =
          two_over_win * sqrtf(mr * mr + mi * mi) * scale;
      if (last) {
        nre[((long long)b * K + k) * win + j] = pr;
        nim[((long long)b * K + k) * win + j] = pi;
      }
    }
    // the next bin's scan starts with a barrier, so prev_total is not
    // overwritten while it is read
  }
}

}  // namespace

extern "C" int sliding_launch(const void* xseg, const void* cosp,
                              const void* sinp, const void* rot,
                              const void* seg0, const void* re0,
                              const void* im0, void* amps, void* nre,
                              void* nim, int B, int S, int win, int K,
                              void* stream) {
  const long long blocks = (long long)B * S;
  if (blocks <= 0 || blocks > 0x7fffffffLL || win <= 0 || K <= 0)
    return (int)cudaErrorInvalidValue;
  sliding_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)xseg, (const float*)cosp, (const float*)sinp,
      (const float*)rot, (const long long*)seg0, (const float*)re0,
      (const float*)im0, (float*)amps, (float*)nre, (float*)nim, S, win, K);
  return (int)cudaGetLastError();
}
