// Per-bin sliding-Goertzel amplitudes on a thread-block cluster: the body
// of kernel E (sliding.cu) and kernel I (sliding_v1.cu).
//
// For row b, segment s, offset j and bin k, the amplitude that kernel A
// (monitor.cu) computes before its reduction to a worst bin:
//   2/win |P_s[j] + e^{j w_k win} (P_{s-1}[win-1] - P_{s-1}[j])| * scale,
// P_s the modulated prefix sums of segment s from its start, P_{-1} the
// state streamed in.  Kernel E: scale = win / min(idx + 1, win) at idx =
// (seg0 + s) win + j (int64), the state in from re0/im0 and out to nre/nim
// (the last segment's prefix tables), tables [K, win], rot [K, 2].  Kernel
// I (kV1): scale 1 (the caller applies the warm-up scale), zero state in
// and none out, one row, tables [win, K], rot [2, K].  Both store
// [B, S, win, K], bins minor.
//
// The arithmetic is kernel A's, so every bit is: each of a block's 256
// threads owns a run of chunk = ceil(win/256) samples; a sequential pass
// gives its partial sums (accum), block_exclusive_scan its offsets
// (goertzel_scan.cuh), and a second pass the prefixes and, with P_{s-1},
// the amplitudes (amplitude(), the same source as A's).  Every prefix and
// amplitude is a function of win alone, so A's worst is the amax of E's
// amplitudes bit for bit, a one-segment launch of the online path equals
// the offline launch, and I times the warm-up scale equals E.
//
// Bound on this card: bytes.  Per sample it must read 4 bytes and write
// 4K (one f32 per bin), against about 20 f32 operations per bin: 5 per
// byte, under the card's float32 ridge of about 20.  The design is A's
// (goertzel_tiles.cuh gives the tiles):
//  * Bins in parallel over a cluster of C = min(K, 8) blocks, block rank c
//    taking bins c, c + C, ....  A one-segment launch occupies K SMs.
//  * Segments and tables staged by cp.async into bank-free [256, Q] tiles.
//  * The usual case (resident: K <= 8 and chunk <= 36) walks a group of
//    consecutive segments of a row per cluster: the bin's tables are
//    staged once a group (kernel I copies the bin's column of its [win, K]
//    tables straight into the tiles, 4 bytes a copy), the next segment is
//    copied in while this one is computed, and the previous segment's
//    prefix table stays in shared memory, overwritten in place.  A group
//    past a call's first segment first computes its predecessor's table
//    the same way (the same operations on the same samples).
//  * Any other geometry runs one (row, segment) a cluster with the previous
//    segment's table recomputed from its samples, in rounds of J columns
//    of every run where a run does not fit.
//  * The stores: each block keeps its bins' amplitude tiles in shared
//    memory.  After a cluster barrier, block c reads every block's tiles
//    through distributed shared memory for one slice of the segment's
//    samples (of a round's: positions [4 floor(E4 c / C), 4 floor(E4 (c +
//    1) / C)), E4 = ceil(E / 4)), each warp interleaving up to 32
//    consecutive samples into [sample, bin] order in its own staging
//    area, and writes them out as one contiguous run, 16 bytes a lane
//    where its address allows.  With one bin a block, a warp loads eight
//    such units before it stages the first, so the remote loads' latency
//    is paid once a batch.  A second cluster barrier, relaxed (it orders
//    no memory), follows before any tile is rewritten or a block exits.
//    The state out (E) stays bins-major: each block writes its bins' kept
//    tables in the call's last segment.
#pragma once

#include <cooperative_groups.h>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "goertzel_scan.cuh"
#include "goertzel_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kStoreRun = 32;  // samples a warp interleaves and stores
constexpr int kBatch = 8;      // units whose loads a warp keeps in flight
constexpr int kWalkFields = 4; // general path, per thread and bin: pr, pi,
                               // qr, qi
constexpr size_t kStaticRoom = 1024;  // kept for static shared memory

// floats of a block's staging area for the interleaved stores
__host__ __device__ inline int store_floats(int K) {
  return kWarps * kStoreRun * K;
}

// dynamic shared memory a block: the usual case's six tiles, or the general
// path's five and one amplitude tile a bin with the fields carried across
// rounds and the previous tables' totals; then the staging area
__host__ inline size_t walk_bytes(bool resident, int J, int nbins, int K) {
  const size_t tq = (size_t)kThreads * row_stride(J);
  const size_t tiles = resident ? kTiles * tq : (5 + nbins) * tq;
  const size_t fields =
      resident ? 0 : (size_t)nbins * (kWalkFields * kThreads + 2);
  return sizeof(float) * (tiles + store_floats(K) + fields);
}

struct SlideOps {
  const float *xseg, *cosp, *sinp, *rot;
  const long long* seg0;    // kernel E only
  const float *re0, *im0;   // kernel E only
  float *amps, *nre, *nim;  // nre, nim: kernel E only
  int S, K;
};

// Columns [c0, c0 + jr) of every thread's run of a strided row (sample gi
// at src[gi * stride]) into rows of a tile, 4 bytes a copy.
__device__ __forceinline__ void stage_strided(float* dst, const float* src,
                                              int stride, const Geometry& g,
                                              int c0, int jr) {
  for (int u = threadIdx.x; u < kThreads * jr; u += kThreads) {
    const int t = u / jr, j = u - t * jr;
    const int gi = t * g.chunk + c0 + j;
    if (gi < g.win)
      cp_async4(dst + t * g.Q + j, src + (long long)gi * stride);
  }
}

// bin k's cos and sin tables, columns [c0, c0 + jr) of every run
template <bool kV1>
__device__ __forceinline__ void stage_tables(float* cs, float* ss,
                                             const SlideOps& op, int k,
                                             const Geometry& g, int c0,
                                             int jr) {
  if (kV1) {
    stage_strided(cs, op.cosp + k, op.K, g, c0, jr);
    stage_strided(ss, op.sinp + k, op.K, g, c0, jr);
  } else {
    stage(cs, op.cosp + (long long)k * g.win, g, c0, jr);
    stage(ss, op.sinp + (long long)k * g.win, g, c0, jr);
  }
}

template <bool kV1>
__device__ __forceinline__ float2 rotation(const SlideOps& op, int k) {
  return kV1 ? make_float2(op.rot[k], op.rot[op.K + k])
             : make_float2(op.rot[2 * k], op.rot[2 * k + 1]);
}

// The cluster barrier after the stores, before any tile is rewritten or a
// block exits.  It orders no memory (relaxed): every remote load before it
// has returned its value, which the stores consumed, and the global
// stores need no order; a release here would wait for them.
__device__ __forceinline__ void cluster_sync_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// A warp's m staged floats to dst, one contiguous run: 16 bytes a lane
// where dst and m allow, else 4.
__device__ __forceinline__ void store_run(float* dst, const float* st, int m,
                                          int lane) {
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && (m & 3) == 0) {
    for (int q = lane; q < (m >> 2); q += 32)
      st4(dst + 4 * q, ld4(st + 4 * q));
  } else {
    for (int q = lane; q < m; q += 32) dst[q] = st[q];
  }
}

// The interleaved stores of one round's samples.  Positions e in [0, E):
// e = t * jr + j is column c0 + j of thread t's run, sample t * chunk + c0
// + j (in one round, jr = chunk and the position is the sample, E = win);
// bin k's amplitude sits at amp[(k / C) * tq + t * Q + j] in block k % C.
// Block `rank` takes positions [4 floor(E4 rank / C), 4 floor(E4 (rank +
// 1) / C)); its warps take turns on units of up to kStoreRun consecutive
// positions that are consecutive samples, interleave each unit into
// [sample, bin] order in their staging area and store it at out[sample * K
// + k], one contiguous run (sliding.store_slices states the same slices,
// for the CPU tests).  The caller puts a cluster barrier before and
// after.
__device__ void store_round(const cg::cluster_group& cluster,
                            const float* amp, int tq, const Geometry& g,
                            int C, int rank, int K, int c0, int jr,
                            float* out, float* stage_area) {
  const bool whole = jr == g.chunk;  // one round
  const int E = whole ? g.win : kThreads * jr;
  const int E4 = (E + 3) >> 2;
  const int e_lo = 4 * (int)((long long)E4 * rank / C);
  const int e_hi = min(E, 4 * (int)((long long)E4 * (rank + 1) / C));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* st = stage_area + warp * kStoreRun * K;
  if (whole && K <= kMaxCluster) {
    // one bin a block (bin k in block k), the slice's units in turn a warp:
    // a batch of units' loads in flight before any is staged and stored
    const int units = (e_hi - e_lo + kStoreRun - 1) / kStoreRun;
    for (int u0 = warp; u0 < units; u0 += kWarps * kBatch) {
      float v[kBatch][kMaxCluster];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int e = e_lo + (u0 + i * kWarps) * kStoreRun + lane;
        if (e < e_hi) {
          const int t = e / g.chunk;
          const float* cell = amp + t * g.Q + (e - t * g.chunk);
#pragma unroll
          for (int k = 0; k < kMaxCluster; ++k)
            if (k < K) v[i][k] = *cluster.map_shared_rank(cell, k);
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int e0 = e_lo + (u0 + i * kWarps) * kStoreRun;
        if (e0 >= e_hi) break;  // the same for the whole warp
        const int n = min(kStoreRun, e_hi - e0);
        if (lane < n) {
#pragma unroll
          for (int k = 0; k < kMaxCluster; ++k)
            if (k < K) st[lane * K + k] = v[i][k];
        }
        __syncwarp();
        store_run(out + (long long)e0 * K, st, n * K, lane);
        __syncwarp();  // the staging area is rewritten next
      }
    }
    return;
  }
  const int span = whole ? E : jr;  // consecutive positions, consecutive
                                    // samples
  int unit = 0;
  for (int p = e_lo / span; p * span < e_hi; ++p) {
    const int a = max(e_lo, p * span), z = min(e_hi, (p + 1) * span);
    for (int e0 = a; e0 < z; e0 += kStoreRun, ++unit) {
      if (unit % kWarps != warp) continue;
      const int e = e0 + lane;
      int gi = g.win, off = 0;
      if (e < z) {
        const int t = e / jr, j = e - t * jr;
        gi = t * g.chunk + c0 + j;
        off = t * g.Q + j;
      }
      const bool valid = gi < g.win;
      if (valid) {
        // bin k0 + i: tile `slot`, block `src`; loads first, then stores
        int slot = 0, src = 0;
        for (int k0 = 0; k0 < K; k0 += kMaxCluster) {
          float v[kMaxCluster];
#pragma unroll
          for (int i = 0; i < kMaxCluster; ++i) {
            if (k0 + i < K) {
              v[i] = *cluster.map_shared_rank(amp + slot * tq + off, src);
              if (++src == C) src = 0, ++slot;
            }
          }
#pragma unroll
          for (int i = 0; i < kMaxCluster; ++i)
            if (k0 + i < K) st[lane * K + k0 + i] = v[i];
        }
      }
      __syncwarp();
      // the valid lanes are a prefix: samples grow with positions
      store_run(out + (long long)__shfl_sync(kFull, gi, 0) * K, st,
                __popc(__ballot_sync(kFull, valid)) * K, lane);
      __syncwarp();  // the staging area is rewritten next
    }
  }
}

// The usual case: one bin a block (rank k), a group of consecutive
// segments of row b a cluster.  Tiles: two segment buffers (a segment's
// samples, then its amplitudes), the previous segment's prefix table (re,
// im), the bin's cos and sin; then the staging area.
template <bool kV1>
__device__ void walk_group(const SlideOps& op, const Geometry& g, float* smem,
                           float4* warp_tot) {
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
  float* stage_area = smem + kTiles * tq;
  float *p0r = p0 + tid * Q, *p1r = p1 + tid * Q;
  const float *cr = cs + tid * Q, *sr = ss + tid * Q;
  const int lo = min(tid * chunk, win);
  const int run = min(lo + chunk, win) - lo;
  const int t_o = (win - 1) / chunk, j_o = win - 1 - t_o * chunk;
  const float two_over_win = (float)(2.0 / (double)win);
  const float2 rot = rotation<kV1>(op, k);
  const long long seg0 = kV1 ? 0 : op.seg0[b];
  const long long row_off = (long long)b * op.S * win;
  const long long state_off = ((long long)b * op.K + k) * win;

  // a group past the call's first segment starts from its predecessor's
  // table, computed the way that segment's own pass computes it
  const int s0 = sa > 0 ? sa - 1 : sa;
  stage_tables<kV1>(cs, ss, op, k, g, 0, chunk);
  if (sa == 0) {
    if (kV1) {
      for (int u = tid; u < tq; u += kThreads) p0[u] = p1[u] = 0.f;
    } else {
      stage(p0, op.re0 + state_off, g, 0, chunk);
      stage(p1, op.im0 + state_off, g, 0, chunk);
    }
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
    // the samples; a priming iteration computes them from an unset table
    // and keeps none)
    const long long idx0 = (seg0 + s) * (long long)win + lo;
    float pr = off.x, pi = off.y;
    auto quad2 = [&](int j, auto warm, auto full) {
      const float4 xv = ld4(xr + j), cv = ld4(cr + j), sv = ld4(sr + j);
      const float4 qv = ld4(p0r + j), iv = ld4(p1r + j);
      float4 av = xv, prv = qv, piv = iv;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (decltype(full)::value || j + e < run) {
          accum(at(xv, e), at(cv, e), at(sv, e), pr, pi);
          at(av, e) = amplitude(
              pr, pi, at(qv, e), at(iv, e), Tr, Ti, rot.x, rot.y,
              warmup_scale<decltype(warm)::value>(idx0 + j + e, win),
              two_over_win);
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
    if (!kV1 && idx0 + 1 < win)
      pass2(std::true_type{});
    else
      pass2(std::false_type{});
    if (!emit) {
      __syncthreads();  // the tables are read, and this buffer refilled
      continue;
    }
    cluster.sync();  // every block's amplitudes and tables are written
    if (!kV1 && s == op.S - 1) {
      unstage(op.nre + state_off, p0, g, 0, chunk);
      unstage(op.nim + state_off, p1, g, 0, chunk);
    }
    store_round(cluster, xcur, tq, g, C, k, op.K, 0, chunk,
                op.amps + (row_off + (long long)s * win) * op.K, stage_area);
    cluster_sync_relaxed();  // no tile rewritten, no block left, while read
  }
}

// Any other geometry: one (row, segment) a cluster, bins rank, rank + C,
// ... a block, the previous segment's table recomputed from its samples,
// in rounds of J columns of every run.  Tiles: the segment, the previous
// segment (or re0), im0, cos, sin, one amplitude tile a bin; then the
// staging area, per thread and bin the fields carried across rounds, and
// per bin the previous table's total.
template <bool kV1>
__device__ void one_segment(const SlideOps& op, const Geometry& g,
                            float* smem, float4* warp_tot) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const long long pair = blockIdx.x / C;
  const int S = op.S, K = op.K;
  const int b = (int)(pair / S), s = (int)(pair % S);
  const int tid = threadIdx.x;
  const int win = g.win, Q = g.Q, tq = kThreads * Q;
  const int nbins = (K - rank + C - 1) / C;  // bins rank, rank + C, ...
  const bool has_prev = s > 0, last = !kV1 && s == S - 1;
  float *xs = smem, *ps0 = smem + tq, *ps1 = smem + 2 * tq;
  float *cs = smem + 3 * tq, *ss = smem + 4 * tq, *as = smem + 5 * tq;
  const int tiles = 5 + (K + C - 1) / C;  // every block lays out the same
  float* stage_area = smem + tiles * tq;
  float* state = stage_area + store_floats(K);  // [bin][field][t]
  float2* totals = reinterpret_cast<float2*>(state + nbins * kWalkFields *
                                             kThreads);
  auto field = [&](int i, int f) -> float& {
    return state[(i * kWalkFields + f) * kThreads + tid];
  };

  const long long seg_off = ((long long)b * S + s) * win;
  const float* xc = op.xseg + seg_off;
  const float* xp = has_prev ? xc - win : nullptr;
  const int lo = min(tid * g.chunk, win);
  const int run = min(lo + g.chunk, win) - lo;
  const long long base = ((kV1 ? 0 : op.seg0[b]) + s) * (long long)win;
  const float two_over_win = (float)(2.0 / (double)win);

  auto bin_of = [&](int i) { return rank + i * C; };
  auto stage_samples = [&](int c0, int jr) {
    stage(xs, xc, g, c0, jr);
    if (has_prev) stage(ps0, xp, g, c0, jr);
  };
  auto stage_bin = [&](int k, int c0, int jr) {
    stage_tables<kV1>(cs, ss, op, k, g, c0, jr);
    if (!kV1 && !has_prev) {
      stage(ps0, op.re0 + ((long long)b * K + k) * win, g, c0, jr);
      stage(ps1, op.im0 + ((long long)b * K + k) * win, g, c0, jr);
    }
  };
  const float *xr = xs + tid * Q, *p0r = ps0 + tid * Q, *p1r = ps1 + tid * Q;
  float *cr = cs + tid * Q, *sr = ss + tid * Q;

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
    if (lo <= win - 1 && win - 1 < lo + run) {
      float tr = 0.f, ti = 0.f;
      if (has_prev) {
        tr = off.z;
        ti = off.w;
        for (int j = lo; j < lo + run; ++j) {
          const float c = kV1 ? op.cosp[(long long)j * K + k]
                              : op.cosp[(long long)k * win + j];
          const float sn = kV1 ? op.sinp[(long long)j * K + k]
                               : op.sinp[(long long)k * win + j];
          accum(xp[j], c, sn, tr, ti);
        }
      } else if (!kV1) {
        tr = op.re0[((long long)b * K + k) * win + win - 1];
        ti = op.im0[((long long)b * K + k) * win + win - 1];
      }
      totals[i] = make_float2(tr, ti);
    }
  }
  __syncthreads();

  // pass 2: prefixes, amplitudes into each bin's tile, the state out; then
  // the round's interleaved stores
  for (int r = 0; r < g.rounds; ++r) {
    const int c0 = r * g.J, jr = min(g.J, g.chunk - c0);
    const int len = max(0, min(run - c0, jr));
    stage_samples(c0, jr);
    for (int i = 0; i < nbins; ++i) {
      const int k = bin_of(i);
      stage_bin(k, c0, jr);
      staged();
      const float Tr = totals[i].x, Ti = totals[i].y;
      const float2 rot = rotation<kV1>(op, k);
      float* ar = as + i * tq + tid * Q;
      float pr = field(i, 0), pi = field(i, 1), qr = field(i, 2),
            qi = field(i, 3);
      for (int j = 0; j < len; j += 4) {
        const float4 xv = ld4(xr + j), cv = ld4(cr + j), sv = ld4(sr + j);
        const float4 pv = ld4(p0r + j);
        const float4 iv = has_prev ? pv : ld4(p1r + j);
        float4 av = xv, prv = xv, piv = xv;
        const long long idx0 = base + lo + c0 + j;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j + e < len) {
            accum(at(xv, e), at(cv, e), at(sv, e), pr, pi);
            if (has_prev) {
              accum(at(pv, e), at(cv, e), at(sv, e), qr, qi);
            } else if (!kV1) {
              qr = at(pv, e);
              qi = at(iv, e);
            }
            at(av, e) = amplitude(pr, pi, qr, qi, Tr, Ti, rot.x, rot.y,
                                  warmup_scale<!kV1>(idx0 + e, win),
                                  two_over_win);
            at(prv, e) = pr;
            at(piv, e) = pi;
          }
        }
        st4(ar + j, av);
        if (last) {  // this sample's cos/sin are read: keep its prefix there
          st4(cr + j, prv);
          st4(sr + j, piv);
        }
      }
      field(i, 0) = pr, field(i, 1) = pi, field(i, 2) = qr, field(i, 3) = qi;
      if (last) {
        __syncthreads();
        unstage(op.nre + ((long long)b * K + k) * win, cs, g, c0, jr);
        unstage(op.nim + ((long long)b * K + k) * win, ss, g, c0, jr);
      }
      __syncthreads();  // the tiles are restaged next
    }
    cluster.sync();
    store_round(cluster, as, tq, g, C, rank, K, c0, jr,
                op.amps + seg_off * K, stage_area);
    cluster_sync_relaxed();  // no tile rewritten, no block left, while read
  }
}

template <bool kV1>
__global__ void __launch_bounds__(kThreads)
    sliding_walk(const SlideOps op, const Geometry g) {
  __shared__ float4 warp_tot[kWarps];
  extern __shared__ __align__(16) float smem[];
  if (g.resident)
    walk_group<kV1>(op, g, smem, warp_tot);
  else
    one_segment<kV1>(op, g, smem, warp_tot);
}

// the card's shared memory a block may opt into
inline size_t smem_optin() {
  static int optin = 0;
  if (optin == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
  }
  return (size_t)optin;
}

// opt the kernel into smem bytes of dynamic shared memory, once a size
template <bool kV1>
cudaError_t opt_in(size_t smem) {
  static size_t opted = 0;
  if (smem + kStaticRoom > smem_optin()) return cudaErrorInvalidValue;
  if (smem <= opted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      sliding_walk<kV1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess) opted = smem;
  return err;
}

inline cudaLaunchConfig_t walk_config(cudaLaunchAttribute* attr, int C,
                                      size_t smem, unsigned blocks,
                                      void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of min(K, 8) blocks at smem bytes a block that the card holds at
// once, or a negative CUDA error.
template <bool kV1>
int active_clusters(int K, long long smem) {
  if (K <= 0 || smem <= 0) return -(int)cudaErrorInvalidValue;
  const int C = K < kMaxCluster ? K : kMaxCluster;
  cudaError_t err = opt_in<kV1>((size_t)smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = walk_config(attr, C, (size_t)smem, C, nullptr);
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, sliding_walk<kV1>, &cfg);
  return err != cudaSuccess ? -(int)err : active;
}

// Launch on the geometry the wrapper chose (sliding.sliding_route and
// segment_groups): resident or not, J run columns a round, group segments
// a cluster.  The shared memory follows from them; a geometry the kernel
// does not take is refused, never run.
template <bool kV1>
int launch_walk(const SlideOps& op, int B, int win, int resident, int J,
                int group, bool vec, void* stream) {
  const int S = op.S, K = op.K;
  if (B <= 0 || S <= 0 || win <= 0 || K <= 0 || J < 4 || J % 4)
    return (int)cudaErrorInvalidValue;
  const int C = K < kMaxCluster ? K : kMaxCluster;
  const int nbins = (K + C - 1) / C;
  Geometry g;
  g.win = win;
  g.chunk = (win + kThreads - 1) / kThreads;
  g.resident = resident != 0;
  if (g.resident ? nbins != 1 || J != ((g.chunk + 3) & ~3)
                 : J > ((g.chunk + 3) & ~3) || group != 1)
    return (int)cudaErrorInvalidValue;
  if (group < 1 || group > S) return (int)cudaErrorInvalidValue;
  g.J = J;
  g.Q = row_stride(J);
  g.rounds = (g.chunk + J - 1) / J;
  g.vec = vec && g.chunk % 4 == 0 && win % 4 == 0;
  g.group = group;
  g.groups = (S + group - 1) / group;
  const size_t smem = walk_bytes(g.resident, J, nbins, K);
  cudaError_t err = opt_in<kV1>(smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * g.groups * C;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      walk_config(attr, C, smem, (unsigned)blocks, stream);
  err = cudaLaunchKernelEx(&cfg, sliding_walk<kV1>, op, g);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
