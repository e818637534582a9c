// Fused sliding-Goertzel monitor: kernel A of the port.
//
// Replaces the reference's Pallas kernel sliding_monitor_pallas
// (src/repro/kernels/goertzel/goertzel.py:340, body _monitor_kernel at :299
// with _bin_amps_lane_major and _global_idx_scale).  Same operands and
// outputs, batched over rows: per-bin sliding-window DFT amplitudes from
// per-segment modulated prefix sums plus the previous segment's rotated
// suffix, the warm-up scale, the per-sample worst bin, its escalation class
// (2 hit, 1 band, 0 clear; live = win-1 <= idx < n), per-segment per-bin
// live peaks, and the prefix state in (re0/im0) and out (nre/nim).
//
// Design.  The TPU grid walks a row's segments in order only to keep the
// previous segment's prefix table in VMEM.  That table depends only on the
// previous segment's input, so here one block per (row, segment)
// recomputes it: a block-wide prefix sum, per bin, of x*cos and x*(-sin)
// over both its own segment and the one before (the first segment of a
// call reads re0/im0 instead).  Blocks then need no order and the card is
// filled by rows x segments blocks.  Each thread owns a contiguous run of
// samples: a sequential pass gives its partial sums, a block scan of those
// gives its offsets, and a second sequential pass produces the prefixes,
// amplitudes, the running per-sample worst (kept in the output buffer) and
// the thread's live peak.  A segment's own prefix at offset b and its
// recomputed "previous" prefix in the next block come from the same
// arithmetic on the same values, so chunked calls that pass the state on
// equal one call.  Sample indices are int64: exact at any trace length.
//
// Bound on this card: bytes.  Per sample it reads 4 bytes and writes 5
// (worst f32, class int8), against about 20 f32 operations per bin; at
// K = 4 bins that is under the card's float32 ridge of about 20 operations
// per byte.  The recomputed previous segment doubles the arithmetic and
// reads, not the bytes that must cross device memory (they hit in L2), and
// the phase tables ([K, win], shared by every block) stay in L2.
#include <cstdint>
#include <cuda_runtime.h>

#include "goertzel_scan.cuh"

namespace {

__global__ void __launch_bounds__(kThreads) monitor_kernel(
    const float* __restrict__ xseg, const float* __restrict__ cosp,
    const float* __restrict__ sinp, const float* __restrict__ rot,
    const float* __restrict__ thr, const float* __restrict__ rel,
    const long long* __restrict__ n_live,
    const long long* __restrict__ seg0, const float* __restrict__ re0,
    const float* __restrict__ im0, float* __restrict__ worst,
    int8_t* __restrict__ cls, float* __restrict__ peaks,
    float* __restrict__ nre, float* __restrict__ nim, int S, int win,
    int K) {
  __shared__ float4 warp_tot[kWarps];
  __shared__ float2 prev_total;
  __shared__ float warp_peak[kWarps];

  const long long blk = blockIdx.x;
  const int b = (int)(blk / S), s = (int)(blk % S);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long seg_off = ((long long)b * S + s) * win;
  const float* xc = xseg + seg_off;
  const float* xp = s > 0 ? xc - win : nullptr;
  const float* r0 = re0 + (long long)b * K * win;
  const float* i0 = im0 + (long long)b * K * win;
  float* wout = worst + seg_off;
  const int chunk = (win + kThreads - 1) / kThreads;
  const int lo = min((int)threadIdx.x * chunk, win);
  const int hi = min(lo + chunk, win);
  const long long base = (seg0[b] + s) * (long long)win;
  const long long nb = n_live[b];
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
    float pk = 0.f;
    // pass 2: prefixes, amplitudes, running worst, live peak, state out
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
      const float amp = two_over_win * sqrtf(mr * mr + mi * mi) * scale;
      if (idx >= win - 1 && idx < nb) pk = fmaxf(pk, amp);
      wout[j] = k == 0 ? amp : fmaxf(wout[j], amp);
      if (last) {
        nre[((long long)b * K + k) * win + j] = pr;
        nim[((long long)b * K + k) * win + j] = pi;
      }
    }
    for (int d = 16; d > 0; d >>= 1)
      pk = fmaxf(pk, __shfl_xor_sync(kFull, pk, d));
    if (lane == 0) warp_peak[warp] = pk;
    __syncthreads();
    if (threadIdx.x == 0) {
      float m = 0.f;
      for (int w = 0; w < kWarps; ++w) m = fmaxf(m, warp_peak[w]);
      peaks[((long long)b * S + s) * K + k] = m;
    }
    // the next bin's scan starts with a barrier, so prev_total and
    // warp_peak are not overwritten while they are read
  }

  const float t_hit = thr[b], t_rel = rel[b];
  int8_t* cout = cls + seg_off;
  for (int j = lo; j < hi; ++j) {
    const long long idx = base + j;
    const bool live = idx >= win - 1 && idx < nb;
    const float w = wout[j];
    const bool hit = (w > t_hit) && live;
    const bool clear = !((w > t_rel) && live);
    cout[j] = (int8_t)(2 * (int)hit + (int)(!hit && !clear));
  }
}

}  // namespace

extern "C" int monitor_launch(const void* xseg, const void* cosp,
                              const void* sinp, const void* rot,
                              const void* thr, const void* rel,
                              const void* n_live, const void* seg0,
                              const void* re0, const void* im0, void* worst,
                              void* cls, void* peaks, void* nre, void* nim,
                              int B, int S, int win, int K, void* stream) {
  const long long blocks = (long long)B * S;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  monitor_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)xseg, (const float*)cosp, (const float*)sinp,
      (const float*)rot, (const float*)thr, (const float*)rel,
      (const long long*)n_live, (const long long*)seg0, (const float*)re0,
      (const float*)im0, (float*)worst, (int8_t*)cls, (float*)peaks,
      (float*)nre, (float*)nim, S, win, K);
  return (int)cudaGetLastError();
}
