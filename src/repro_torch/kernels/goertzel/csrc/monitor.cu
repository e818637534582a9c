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
// The arithmetic.  A segment's prefix table P_s (per bin, the running sums
// of x*cos and x*(-sin) from the segment's start) depends only on that
// segment's samples.  Each of a block's 256 threads owns a contiguous run
// of chunk = ceil(win/256) samples: a sequential pass gives its partial
// sums, block_exclusive_scan (goertzel_scan.cuh, shared with kernels E and
// I) gives its offsets, and a second sequential pass produces the prefixes
// and from them, with P_{s-1} (re0/im0 for a call's first segment), the
// amplitudes and the thread's live peak.  That decomposition, and so every
// bit of every prefix and amplitude, is a function of win alone: it is
// kernel E's, so the worst over bins equals the amax of E's amplitudes,
// and a one-segment launch of the online path equals the offline [B, S,
// win] launch.  The amplitude's rounding steps (amplitude(), with the
// warm-up scale) are written once, in goertzel_scan.cuh, for kernels A, E
// and I.  Sample indices are int64: exact at any trace length.
//
// Bound on this card: bytes.  Per sample it must read 4 bytes and write 5
// (worst f32, class int8), against about 21 f32 operations per bin; at
// K = 4 bins that is under the card's float32 ridge of about 20 operations
// per byte.  Far from that bound the time goes where data lives and what
// waits on what: runs of chunk samples a lane read from device memory
// touch a cache line per lane and load, each pass of each bin reads a
// sample again, a worst kept in device memory crosses it once per bin, and
// K bins taken in turn leave a one-segment launch on one SM.
//
// Design.
//  * Bins in parallel over a thread-block cluster: C = min(K, 8) blocks on
//    C SMs, block rank c taking bins c, c + C, ... (one bin when K <= 8).
//    A control tick's one-segment launch occupies K SMs instead of one.
//  * Staged, coalesced, bank-free.  Rows of samples and tables are copied
//    into shared memory by cp.async, 16 bytes a lane with neighbouring
//    lanes on neighbouring addresses (4 bytes where win, the run or a base
//    is not 16-byte aligned).  Thread t's run sits in row t of a [256, Q]
//    tile, Q >= chunk and Q = 4 (mod 8): the passes read it 16 bytes at a
//    time, and the 8 lanes of each quarter warp then hit 8 distinct groups
//    of 4 banks.  The tiles and copies are goertzel_tiles.cuh's, shared
//    with kernels E and I (sliding_walk.cuh).
//  * The worst stays on chip.  The amplitudes of a block's bin stay in its
//    shared memory; after a cluster barrier each block reduces 1/C of the
//    segment's samples over the C blocks' tiles through distributed shared
//    memory (fmaxf of non-negative floats is exact in any order, so the
//    result does not depend on which block finished first) and writes
//    worst and cls there once, coalesced.
//  * The usual case (K <= 8 and chunk <= 36, so six tiles fit: 216 KB at
//    win 8000, one block per SM) walks a group of consecutive segments of
//    a row per cluster.  The bin's cos/sin tiles are staged once; the next
//    segment is copied in while this one is computed; and the previous
//    segment's prefix table stays in shared memory, overwritten in place
//    by this segment's, instead of being recomputed from the previous
//    segment's samples.  The kept table is bit for bit the recomputed one
//    (the same operations on the same samples), so a group that starts
//    past a call's first segment first computes its predecessor's table
//    the same way.  The group size balances waves of
//    resident clusters (cudaOccupancyMaxActiveClusters) against that
//    start.  Each block writes its bin's peaks, and in a call's last
//    segment its bin's nre/nim from the kept table.
//  * Any other geometry runs one (row, segment) per cluster with the
//    previous segment's table recomputed from its samples, per bin and,
//    where a run does not fit shared memory at once, per round of J
//    columns of every run, each round reduced over the cluster in turn;
//    the prefix sums run over the same samples in the same order, so the
//    bits do not change.
#include <cooperative_groups.h>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "goertzel_scan.cuh"
#include "goertzel_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kFields = 5;      // general path, per thread and bin: pr, pi,
                                // qr, qi, peak

__host__ inline size_t general_bytes(int J, int nbins) {
  return tiles_bytes(J) + sizeof(float) * (size_t)nbins *
                              (kFields * kThreads + 2);
}

struct Operands {
  const float *xseg, *cosp, *sinp, *rot, *thr, *rel;
  const long long *n_live, *seg0;
  const float *re0, *im0;
  float* worst;
  int8_t* cls;
  float *peaks, *nre, *nim;
  int S, K;
};

__device__ __forceinline__ int8_t classify(float w, long long idx, int win,
                                           long long nb, float t_hit,
                                           float t_rel) {
  const bool live = idx >= win - 1 && idx < nb;
  const bool hit = (w > t_hit) && live;
  const bool clear = !((w > t_rel) && live);
  return (int8_t)(2 * (int)hit + (int)(!hit && !clear));
}

// a block's maximum of v (every thread's), valid in thread 0
__device__ __forceinline__ float block_max(float v, float* warp_peak) {
  for (int d = 16; d > 0; d >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, d));
  if ((threadIdx.x & 31) == 0) warp_peak[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, warp_peak[w]);
  __syncthreads();
  return m;
}

// The worst over the cluster's C amplitude tiles (amp[t * Q + j] in every
// block) and its class, for columns [c0, c0 + jr) of every run of one
// segment (worst/cls at its first sample): block `rank` takes 1/C of them.
// The caller puts a cluster barrier before and after.
__device__ void reduce_worst(const cg::cluster_group& cluster,
                             float* amp, const Geometry& g, int C, int rank,
                             int c0, int jr, float* worst, int8_t* cls,
                             long long base, long long nb, float t_hit,
                             float t_rel) {
  const int E = kThreads * jr;
  if (g.vec && jr == g.chunk) {
    // one round: sample e of the segment, four at a time
    const int E4 = E >> 2;
    const int u_lo = (int)((long long)E4 * rank / C);
    const int u_hi = (int)((long long)E4 * (rank + 1) / C);
#pragma unroll 2
    for (int u = u_lo + threadIdx.x; u < u_hi; u += kThreads) {
      const int gi = u << 2;
      if (gi >= g.win) continue;
      const int t = gi / g.chunk;
      float* cell = amp + t * g.Q + (gi - t * g.chunk);
      float4 w = ld4(cluster.map_shared_rank(cell, 0));
      for (int c = 1; c < C; ++c) {
        const float4 v = ld4(cluster.map_shared_rank(cell, c));
        w = make_float4(fmaxf(w.x, v.x), fmaxf(w.y, v.y), fmaxf(w.z, v.z),
                        fmaxf(w.w, v.w));
      }
      st4(worst + gi, w);
      unsigned packed = 0;
      for (int e = 0; e < 4; ++e)
        packed |= (unsigned)(uint8_t)classify(at(w, e), base + gi + e, g.win,
                                              nb, t_hit, t_rel)
                  << (8 * e);
      *reinterpret_cast<unsigned*>(cls + gi) = packed;
    }
    return;
  }
  const int e_lo = (int)((long long)E * rank / C);
  const int e_hi = (int)((long long)E * (rank + 1) / C);
  for (int e = e_lo + threadIdx.x; e < e_hi; e += kThreads) {
    const int t = e / jr, j = e - t * jr;
    const int gi = t * g.chunk + c0 + j;
    if (gi >= g.win) continue;
    float* cell = amp + t * g.Q + j;
    float w = *cluster.map_shared_rank(cell, 0);
    for (int c = 1; c < C; ++c)
      w = fmaxf(w, *cluster.map_shared_rank(cell, c));
    worst[gi] = w;
    cls[gi] = classify(w, base + gi, g.win, nb, t_hit, t_rel);
  }
}

// The usual case: one bin a block (rank k), a group of consecutive
// segments of row b a cluster.  Tiles: two segment buffers (a segment's
// samples, then its amplitudes), the previous segment's prefix table (re,
// im), the bin's cos and sin.
__device__ void walk_group(const Operands& op, const Geometry& g,
                           float* smem, float4* warp_tot, float* warp_peak) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), k = (int)cluster.block_rank();
  const long long pair = blockIdx.x / C;
  const int b = (int)(pair / g.groups), grp = (int)(pair % g.groups);
  const int sa = grp * g.group, sb = min(op.S, sa + g.group);
  const int tid = threadIdx.x, win = g.win, Q = g.Q, chunk = g.chunk;
  const int tq = kThreads * Q;
  // the segment buffers: s's at smem + (s & 1) * tq
  float *p0 = smem + 2 * tq, *p1 = smem + 3 * tq;
  float *cs = smem + 4 * tq, *ss = smem + 5 * tq;
  float *p0r = p0 + tid * Q, *p1r = p1 + tid * Q;
  const float *cr = cs + tid * Q, *sr = ss + tid * Q;
  const int lo = min(tid * chunk, win);
  const int run = min(lo + chunk, win) - lo;
  const int t_o = (win - 1) / chunk, j_o = win - 1 - t_o * chunk;
  const float two_over_win = (float)(2.0 / (double)win);
  const long long nb = op.n_live[b];
  const float t_hit = op.thr[b], t_rel = op.rel[b];
  const float rr = op.rot[2 * k], ri = op.rot[2 * k + 1];
  const long long row_off = (long long)b * op.S * win;
  const long long state_off = ((long long)b * op.K + k) * win;

  // a group past the call's first segment starts from its predecessor's
  // table, computed the way that segment's own pass computes it
  const int s0 = sa > 0 ? sa - 1 : sa;
  stage(cs, op.cosp + (long long)k * win, g, 0, chunk);
  stage(ss, op.sinp + (long long)k * win, g, 0, chunk);
  if (sa == 0) {
    stage(p0, op.re0 + state_off, g, 0, chunk);
    stage(p1, op.im0 + state_off, g, 0, chunk);
  }
  stage(smem + (s0 & 1) * tq, op.xseg + row_off + (long long)s0 * win, g,
        0, chunk);
  commit();
  for (int s = s0; s < sb; ++s) {
    float* xcur = smem + (s & 1) * tq;
    float* xr = xcur + tid * Q;
    // the next segment's samples come in while this one is computed
    if (s + 1 < sb)
      stage(smem + ((s + 1) & 1) * tq,
            op.xseg + row_off + (long long)(s + 1) * win, g, 0, chunk);
    commit();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const bool emit = s >= sa;

    // pass 1: this thread's partial sums over its run, in quads of
    // samples (the last one guarded)
    float2 part = make_float2(0.f, 0.f);
    auto quad1 = [&](int j, auto full) {
      const float4 xv = ld4(xr + j), cv = ld4(cr + j), sv = ld4(sr + j);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (decltype(full)::value || j + e < run)
          accum(at(xv, e), at(cv, e), at(sv, e), part.x, part.y);
    };
    int j1 = 0;
    for (; j1 + 4 <= run; j1 += 4) quad1(j1, std::true_type{});
    if (j1 < run) quad1(j1, std::false_type{});
    // the previous table's total, read before the scan's barriers
    const float Tr = p0[t_o * Q + j_o], Ti = p1[t_o * Q + j_o];
    const float4 off = block_exclusive_scan(
        make_float4(part.x, part.y, 0.f, 0.f), warp_tot);

    // pass 2: prefixes (kept, over the previous table), amplitudes (over
    // the samples), the live peak (live: offsets [live_lo, live_hi) of the
    // run, win - 1 <= idx < n)
    float pk = 0.f;
    const long long idx0 = (op.seg0[b] + s) * (long long)win + lo;
    const int live_lo = (int)max(0LL, min((long long)run, win - 1 - idx0));
    const int live_hi = (int)max(0LL, min((long long)run, nb - idx0));
    // (a priming iteration computes amplitudes from an unset table and
    // keeps none of them)
    float pr = off.x, pi = off.y;
    auto quad2 = [&](int j, auto warm, auto full) {
      const float4 xv = ld4(xr + j), cv = ld4(cr + j), sv = ld4(sr + j);
      const float4 qv = ld4(p0r + j), iv = ld4(p1r + j);
      float4 av = xv, prv = qv, piv = iv;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (decltype(full)::value || j + e < run) {
          accum(at(xv, e), at(cv, e), at(sv, e), pr, pi);
          const float amp = amplitude(
              pr, pi, at(qv, e), at(iv, e), Tr, Ti, rr, ri,
              warmup_scale<decltype(warm)::value>(idx0 + j + e, win),
              two_over_win);
          const bool live = j + e >= live_lo && j + e < live_hi;
          pk = live ? fmaxf(pk, amp) : pk;
          at(av, e) = amp;
          at(prv, e) = pr;
          at(piv, e) = pi;
        }
      }
      if (emit) st4(xr + j, av);
      st4(p0r + j, prv);
      st4(p1r + j, piv);
    };
    auto pass2 = [&](auto warm) {
      int j = 0;
      for (; j + 4 <= run; j += 4) quad2(j, warm, std::true_type{});
      if (j < run) quad2(j, warm, std::false_type{});
    };
    if (idx0 + 1 < win)
      pass2(std::true_type{});
    else
      pass2(std::false_type{});
    if (!emit) {
      __syncthreads();  // the tables are read, and this buffer refilled
      continue;
    }
    // its barriers also order every thread's pass 2 before what follows
    const float peak = block_max(pk, warp_peak);
    if (tid == 0) op.peaks[((long long)b * op.S + s) * op.K + k] = peak;
    if (s == op.S - 1) {
      unstage(op.nre + state_off, p0, g, 0, chunk);
      unstage(op.nim + state_off, p1, g, 0, chunk);
    }
    cluster.sync();
    const long long seg_off = row_off + (long long)s * win;
    reduce_worst(cluster, xcur, g, C, k, 0, chunk,
                 op.worst + seg_off, op.cls + seg_off,
                 (op.seg0[b] + s) * (long long)win, nb, t_hit, t_rel);
    cluster.sync();  // no tile is rewritten, or block left, while read
  }
}

// Any other geometry: one (row, segment) a cluster, bins rank, rank + C,
// ... a block, the previous segment's table recomputed from its samples,
// in rounds of J columns of every run.  Tiles: the segment, the previous
// segment (or re0), im0, cos, sin, the block's running worst over its
// bins; then per thread and bin the fields carried across rounds, and per
// bin the previous table's total.
__device__ void one_segment(const Operands& op, const Geometry& g,
                            float* smem, float4* warp_tot,
                            float* warp_peak) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const long long pair = blockIdx.x / C;
  const int S = op.S, K = op.K;
  const int b = (int)(pair / S), s = (int)(pair % S);
  const int tid = threadIdx.x;
  const int win = g.win, Q = g.Q, tq = kThreads * Q;
  const int nbins = (K - rank + C - 1) / C;  // bins rank, rank + C, ...
  const bool has_prev = s > 0, last = s == S - 1;
  float *xs = smem, *ps0 = smem + tq, *ps1 = smem + 2 * tq;
  float *cs = smem + 3 * tq, *ss = smem + 4 * tq, *ws = smem + 5 * tq;
  float* state = smem + kTiles * tq;  // [bin][field][t]
  float2* totals = reinterpret_cast<float2*>(state + nbins * kFields *
                                             kThreads);
  auto field = [&](int i, int f) -> float& {
    return state[(i * kFields + f) * kThreads + tid];
  };

  const long long seg_off = ((long long)b * S + s) * win;
  const float* xc = op.xseg + seg_off;
  const float* xp = has_prev ? xc - win : nullptr;
  const int lo = min(tid * g.chunk, win);
  const int run = min(lo + g.chunk, win) - lo;
  const long long base = (op.seg0[b] + s) * (long long)win;
  const long long nb = op.n_live[b];
  const float two_over_win = (float)(2.0 / (double)win);

  auto bin_of = [&](int i) { return rank + i * C; };
  auto stage_samples = [&](int c0, int jr) {
    stage(xs, xc, g, c0, jr);
    if (has_prev) stage(ps0, xp, g, c0, jr);
  };
  auto stage_bin = [&](int k, int c0, int jr) {
    stage(cs, op.cosp + (long long)k * win, g, c0, jr);
    stage(ss, op.sinp + (long long)k * win, g, c0, jr);
    if (!has_prev) {
      stage(ps0, op.re0 + ((long long)b * K + k) * win, g, c0, jr);
      stage(ps1, op.im0 + ((long long)b * K + k) * win, g, c0, jr);
    }
  };
  const float *xr = xs + tid * Q, *p0r = ps0 + tid * Q, *p1r = ps1 + tid * Q;
  float *cr = cs + tid * Q, *sr = ss + tid * Q, *wr = ws + tid * Q;

  // pass 1: this thread's partial sums over its run, per bin, for the
  // segment (x, y) and the previous one (z, w)
  for (int r = 0; r < g.rounds; ++r) {
    const int c0 = r * g.J, jr = min(g.J, g.chunk - c0);
    const int len = max(0, min(run - c0, jr));
    stage_samples(c0, jr);
    for (int i = 0; i < nbins; ++i) {
      stage_bin(bin_of(i), c0, jr);
      staged();
      float4 part = r == 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                           : make_float4(field(i, 0), field(i, 1),
                                         field(i, 2), field(i, 3));
      for (int j = 0; j < len; j += 4) {
        const float4 xv = ld4(xr + j), cv = ld4(cr + j), sv = ld4(sr + j);
        const float4 pv = has_prev ? ld4(p0r + j) : xv;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j + e < len) {
            accum(at(xv, e), at(cv, e), at(sv, e), part.x, part.y);
            if (has_prev) accum(at(pv, e), at(cv, e), at(sv, e), part.z,
                                part.w);
          }
        }
      }
      field(i, 0) = part.x, field(i, 1) = part.y;
      field(i, 2) = part.z, field(i, 3) = part.w;
      __syncthreads();  // the tiles are restaged next
    }
  }

  // the scan, per bin; then the previous segment's prefix at win-1,
  // computed by the thread that owns that sample with the same recurrence
  // as pass 2
  for (int i = 0; i < nbins; ++i) {
    const int k = bin_of(i);
    const float4 off = block_exclusive_scan(
        make_float4(field(i, 0), field(i, 1), field(i, 2), field(i, 3)),
        warp_tot);
    field(i, 0) = off.x, field(i, 1) = off.y;
    field(i, 2) = off.z, field(i, 3) = off.w;
    field(i, 4) = 0.f;
    if (lo <= win - 1 && win - 1 < lo + run) {
      float tr, ti;
      if (has_prev) {
        tr = off.z;
        ti = off.w;
        const float* c = op.cosp + (long long)k * win;
        const float* sn = op.sinp + (long long)k * win;
        for (int j = lo; j < lo + run; ++j) accum(xp[j], c[j], sn[j], tr,
                                                  ti);
      } else {
        tr = op.re0[((long long)b * K + k) * win + win - 1];
        ti = op.im0[((long long)b * K + k) * win + win - 1];
      }
      totals[i] = make_float2(tr, ti);
    }
  }
  __syncthreads();

  // pass 2: prefixes, amplitudes, the block's running worst over its bins,
  // live peaks, the state out; then the cluster's worst and class for the
  // round's samples
  const float t_hit = op.thr[b], t_rel = op.rel[b];
  for (int r = 0; r < g.rounds; ++r) {
    const int c0 = r * g.J, jr = min(g.J, g.chunk - c0);
    const int len = max(0, min(run - c0, jr));
    stage_samples(c0, jr);
    for (int i = 0; i < nbins; ++i) {
      const int k = bin_of(i);
      stage_bin(k, c0, jr);
      staged();
      const float Tr = totals[i].x, Ti = totals[i].y;
      const float rr = op.rot[2 * k], ri = op.rot[2 * k + 1];
      float pr = field(i, 0), pi = field(i, 1), qr = field(i, 2),
            qi = field(i, 3), pk = field(i, 4);
      for (int j = 0; j < len; j += 4) {
        const float4 xv = ld4(xr + j), cv = ld4(cr + j), sv = ld4(sr + j);
        const float4 pv = ld4(p0r + j);
        const float4 iv = has_prev ? pv : ld4(p1r + j);
        float4 wv = i == 0 ? xv : ld4(wr + j);
        float4 prv = xv, piv = xv;
        const long long idx0 = base + lo + c0 + j;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j + e < len) {
            accum(at(xv, e), at(cv, e), at(sv, e), pr, pi);
            if (has_prev) {
              accum(at(pv, e), at(cv, e), at(sv, e), qr, qi);
            } else {
              qr = at(pv, e);
              qi = at(iv, e);
            }
            const long long idx = idx0 + e;
            const float amp = amplitude(pr, pi, qr, qi, Tr, Ti, rr, ri,
                                        warmup_scale<true>(idx, win),
                                        two_over_win);
            if (idx >= win - 1 && idx < nb) pk = fmaxf(pk, amp);
            at(wv, e) = i == 0 ? amp : fmaxf(at(wv, e), amp);
            at(prv, e) = pr;
            at(piv, e) = pi;
          }
        }
        st4(wr + j, wv);
        if (last) {  // this sample's cos/sin are read: keep its prefix there
          st4(cr + j, prv);
          st4(sr + j, piv);
        }
      }
      field(i, 0) = pr, field(i, 1) = pi, field(i, 2) = qr, field(i, 3) = qi;
      field(i, 4) = pk;
      if (last) {
        __syncthreads();
        unstage(op.nre + ((long long)b * K + k) * win, cs, g, c0, jr);
        unstage(op.nim + ((long long)b * K + k) * win, ss, g, c0, jr);
      }
      __syncthreads();  // the tiles are restaged next
    }
    cluster.sync();
    reduce_worst(cluster, ws, g, C, rank, c0, jr, op.worst + seg_off,
                 op.cls + seg_off, base, nb, t_hit, t_rel);
    cluster.sync();  // no tile is rewritten, or block left, while read
  }

  // each bin's live peak over the segment
  for (int i = 0; i < nbins; ++i) {
    const float peak = block_max(field(i, 4), warp_peak);
    if (tid == 0) op.peaks[((long long)b * S + s) * K + bin_of(i)] = peak;
  }
}

__global__ void __launch_bounds__(kThreads)
    monitor_kernel(const Operands op, const Geometry g) {
  __shared__ float4 warp_tot[kWarps];
  __shared__ float warp_peak[kWarps];
  extern __shared__ __align__(16) float smem[];
  if (g.resident)
    walk_group(op, g, smem, warp_tot, warp_peak);
  else
    one_segment(op, g, smem, warp_tot, warp_peak);
}

// segments a cluster walks in the usual case: fewest waves of `active`
// resident clusters, each cluster's work its segments plus one for a
// group that starts past segment 0
int group_size(int B, int S, int active) {
  int best = S;
  long long best_cost = -1;
  for (int m = 1; m <= S; ++m) {
    const long long clusters = (long long)B * ((S + m - 1) / m);
    const long long waves = (clusters + active - 1) / active;
    const long long cost = waves * (m + (m < S ? 1 : 0));
    if (best_cost < 0 || cost < best_cost) best = m, best_cost = cost;
  }
  return best;
}

}  // namespace

extern "C" int monitor_launch(const void* xseg, const void* cosp,
                              const void* sinp, const void* rot,
                              const void* thr, const void* rel,
                              const void* n_live, const void* seg0,
                              const void* re0, const void* im0, void* worst,
                              void* cls, void* peaks, void* nre, void* nim,
                              int B, int S, int win, int K, void* stream) {
  if (B <= 0 || S <= 0 || win <= 0 || K <= 0)
    return (int)cudaErrorInvalidValue;
  const int C = K < kMaxCluster ? K : kMaxCluster;
  const int nbins = (K + C - 1) / C;
  static int optin = 0;   // the card's shared memory a block may opt into
  static size_t opted = 0;
  if (optin == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
  }
  const size_t room = (size_t)optin - 1024;  // the static shared memory
  Geometry g;
  g.win = win;
  g.chunk = (win + kThreads - 1) / kThreads;
  int J = (g.chunk + 3) & ~3;
  g.resident = nbins == 1 && tiles_bytes(J) <= room;
  size_t smem;
  if (g.resident) {
    smem = tiles_bytes(J);
  } else {
    // one round if the whole run fits, else the widest rounds that do
    while (J > 4 && general_bytes(J, nbins) > room) J -= 4;
    smem = general_bytes(J, nbins);
    if (smem > room) return (int)cudaErrorInvalidValue;
  }
  g.J = J;
  g.Q = row_stride(J);
  g.rounds = (g.chunk + J - 1) / J;
  g.vec = g.chunk % 4 == 0 && win % 4 == 0 && aligned(xseg, 16) &&
          aligned(cosp, 16) && aligned(sinp, 16) && aligned(re0, 16) &&
          aligned(im0, 16) && aligned(nre, 16) && aligned(nim, 16) &&
          aligned(worst, 16) && aligned(cls, 4);
  cudaError_t err = cudaSuccess;
  if (smem > opted) {
    err = cudaFuncSetAttribute(monitor_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }

  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  g.group = 1;
  g.groups = S;
  if (g.resident && S > 1) {
    static int active_for[kMaxCluster + 1] = {};  // by cluster size
    static size_t active_smem[kMaxCluster + 1] = {};
    if (active_smem[C] != smem) {
      cfg.gridDim = dim3(C, 1, 1);
      err = cudaOccupancyMaxActiveClusters(&active_for[C], monitor_kernel,
                                           &cfg);
      if (err != cudaSuccess) return (int)err;
      if (active_for[C] <= 0) return (int)cudaErrorInvalidConfiguration;
      active_smem[C] = smem;
    }
    g.group = group_size(B, S, active_for[C]);
    g.groups = (S + g.group - 1) / g.group;
  }
  const long long blocks = (long long)B * g.groups * C;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  const Operands op = {(const float*)xseg, (const float*)cosp,
                       (const float*)sinp, (const float*)rot,
                       (const float*)thr, (const float*)rel,
                       (const long long*)n_live, (const long long*)seg0,
                       (const float*)re0, (const float*)im0, (float*)worst,
                       (int8_t*)cls, (float*)peaks, (float*)nre, (float*)nim,
                       S, K};
  err = cudaLaunchKernelEx(&cfg, monitor_kernel, op, g);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
