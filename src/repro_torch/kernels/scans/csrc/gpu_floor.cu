// GB200-style device power smoothing, hard semantics: kernel B of the port.
//
// Replaces the reference's per-sample lax.scan of GpuPowerSmoothing.apply_jax
// (src/repro/core/smoothing/gpu_floor.py:85): an idle counter, the minimum
// power floor held for stop_delay after activity stops, the EDP cap and the
// ramp-rate clip against the previous output.
//
// Per sample i of a row, with params {mpf, thresh, ru, rd, stop_n, cap}:
//   idle_i = x_i > thresh ? 0 : idle_{i-1} + 1     (f32, idle_{-1} = 0)
//   t_i    = min(max(x_i, idle_i <= stop_n ? mpf : 0), cap)
//   o_i    = min(max(t_i, o_{i-1} - rd), o_{i-1} + ru)   (o_{-1} = x_0)
//
// Bound on this card: the serial chain of o, three dependent f32
// operations a sample; the 8 bytes a sample moves are far below it.  So
// the design takes everything else off the chain and cuts the chain
// itself into pieces that run side by side.
//
//  * One warp a row, rows spread over the SMs (a block holds
//    ceil(rows / SMs) warps, at most kMaxWarps).  The warp's lanes copy
//    the row in tiles of kLanes x kSeg samples into a ring of kStages
//    shared-memory slots with cp.async, kStages - 1 tiles ahead; 16 bytes
//    a lane where the row starts on a 16-byte boundary, else 4.  Lane k
//    owns segment k of a tile (kSeg samples at a stride of kSeg + 4
//    words, so the lanes' 16-byte reads and writes are bank-free) and
//    holds it in registers: its samples, then its targets, and the last
//    output of each group of 4 it has written.
//  * The target is off the chain.  In f32, idle + 1 counts exact integers
//    and sticks at 2^24 (2^24 + 1 rounds to 2^24), so idle_i =
//    min(i - last_active(i), 2^24) with last_active -1 before the first
//    active sample: a warp max-scan of each segment's last active index,
//    carried from tile to tile, gives every lane its counter, then its
//    targets, in parallel.
//  * The chain runs in segments with an exact merge test.  o_i depends
//    only on o_{i-1} and t_i, so two walks that hold the same o bit for bit
//    agree from there on.  Each lane walks its segment speculatively from
//    o = its first target, writing its outputs to a staging tile.  Then,
//    in rounds, a lane whose start changed walks again from its
//    predecessor's end (lane 0 from the tile's true start) until its o
//    equals, bit for bit (__float_as_uint, so -0 and +0 are two states),
//    the output it holds at a tested step (every 16th, and its last):
//    from there its outputs stand.  A lane that walks its whole segment
//    without meeting them has a new end, and its successor walks again in
//    the next round.  Rounds end when no lane's end changes, so the result
//    is exact whatever the data.  Usually the speculative walk meets the
//    true one within a few steps (the ramp clip lets go once o reaches its
//    target), and a tile costs kSeg steps plus the longest merge, rounded
//    up to a tested step.  In the worst case (no walk ever meets another,
//    as when the ramps never let o reach its target) a tile costs kLanes
//    rounds: the serial walk of the tile plus one segment.
//  * The outputs of a tile are stored by the warp, coalesced, from the
//    staging tile.
//
// The f32 operations are those of the reference step, with no fused
// multiply-add (built with -fmad=false), and the counter and target are
// exact, so the kernel equals gpu_floor_scan_plain bit for bit.
//
// params[r] = {mpf, thresh, ru, rd, stop_n, cap}, all f32.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kSeg = 64;                  // samples a lane walks in a tile
constexpr int kStride = kSeg + 4;         // a segment's words in shared memory
constexpr int kTile = kLanes * kSeg;      // samples a tile
constexpr int kTileWords = kLanes * kStride;
constexpr int kStages = 4;                // ring slots: 3 tiles in flight
constexpr int kMaxWarps = 4;              // rows a block
constexpr int kIdleStuck = 1 << 24;       // where the f32 counter stops
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  float mpf, thresh, ru, rd, stop_n, cap;
  __device__ void load(const float* p) {
    mpf = p[0], thresh = p[1], ru = p[2], rd = p[3], stop_n = p[4];
    cap = p[5];
  }
  __device__ __forceinline__ float target(float v, int idle) const {
    const float floor_w = ((float)idle <= stop_n) ? mpf : 0.0f;
    return fminf(fmaxf(v, floor_w), cap);
  }
  __device__ __forceinline__ float step(float o, float t) const {
    return fminf(fmaxf(t, o - rd), o + ru);
  }
};

// a tile position's word in the slot: segment p / kSeg at stride kStride
__device__ __forceinline__ int word(int p) {
  return (p / kSeg) * kStride + p % kSeg;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// every lane: copy tile t of the row (if it exists) into its slot, and
// close one cp.async group either way, so that group t is tile t
__device__ __forceinline__ void load_tile(float* ring, const float* x,
                                          long long n, long long t, int lane,
                                          bool vec) {
  if (t * kTile < n) {
    float* slot = ring + (int)(t % kStages) * kTileWords;
    const float* src = x + t * kTile;
    const int len = (int)min((long long)kTile, n - t * kTile);
    if (vec) {
      for (int p = 4 * lane; p < len; p += 4 * kLanes) {
        if (p + 4 <= len) {
          cp_async16(slot + word(p), src + p);
        } else {
          for (int q = p; q < len; ++q) cp_async4(slot + word(q), src + q);
        }
      }
    } else {
      for (int p = lane; p < len; p += kLanes) cp_async4(slot + word(p), src + p);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the warp stores the staged outputs of a tile of len samples, coalesced
__device__ __forceinline__ void store_tile(float* dst, const float* stage,
                                           int len, int lane, bool vec) {
  if (vec) {
#pragma unroll 4
    for (int p = 4 * lane; p < len; p += 4 * kLanes) {
      if (p + 4 <= len) {
        *reinterpret_cast<float4*>(dst + p) =
            *reinterpret_cast<const float4*>(stage + word(p));
      } else {
        for (int q = p; q < len; ++q) dst[q] = stage[word(q)];
      }
    }
  } else {
    for (int p = lane; p < len; p += kLanes) dst[p] = stage[word(p)];
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 walk4(const Params& P, float o,
                                        const float4& t) {
  float4 v;
  v.x = P.step(o, t.x);
  v.y = P.step(v.x, t.y);
  v.z = P.step(v.y, t.z);
  v.w = P.step(v.z, t.w);
  return v;
}

// A lane's segment of a tile, held in registers: its targets t and the
// last output of each group of 4 it has written (the one a walk meets).
// Every index is a constant once the loops are unrolled, so nothing here
// is read from memory on the chain; outputs go to the staging tile.  A
// branch inside a walk costs about as much as a step of the chain, so a
// full tile's walks have none but the meet test, every kMeetGroups groups
// (and at the lane's last); only the ragged last tile tests its groups.
constexpr int kMeetGroups = 4;

struct Segment {
  float t[kSeg];
  float last[kSeg / 4];

  // the speculative walk from the first target; returns its end
  template <bool kRagged>
  __device__ __forceinline__ float walk(const Params& P, float* os,
                                        int groups) {
    float o = t[0];
#pragma unroll
    for (int g = 0; g < kSeg / 4; ++g) {
      if (kRagged && g >= groups) break;
      const float4 v = walk4(P, o, make_float4(t[4 * g], t[4 * g + 1],
                                               t[4 * g + 2], t[4 * g + 3]));
      *reinterpret_cast<float4*>(os + 4 * g) = v;
      last[g] = v.w;
      o = v.w;
    }
    return o;
  }

  // a round's walk from o, writing each output over the one held, until
  // a tested group's last output equals the one held there bit for bit:
  // from the first step where the two walks agree every output is the one
  // held, so a test at a later group sees them agree, and the outputs
  // written before it are this walk's.  Returns whether it met them; o is
  // the walk's last output.
  template <bool kRagged>
  __device__ __forceinline__ bool meet(const Params& P, float* os,
                                       int groups, float& o) {
#pragma unroll
    for (int g = 0; g < kSeg / 4; ++g) {
      if (kRagged && g >= groups) break;
      const float4 v = walk4(P, o, make_float4(t[4 * g], t[4 * g + 1],
                                               t[4 * g + 2], t[4 * g + 3]));
      *reinterpret_cast<float4*>(os + 4 * g) = v;
      o = v.w;
      const unsigned held = __float_as_uint(last[g]);
      last[g] = v.w;
      const bool test = g % kMeetGroups == kMeetGroups - 1 ||
                        (kRagged && g == groups - 1);
      if (test && __float_as_uint(v.w) == held) return true;
    }
    return false;
  }
};

__global__ void __launch_bounds__(kMaxWarps * 32)
gpu_floor_kernel(const float* __restrict__ w, const float* __restrict__ params,
                 float* __restrict__ out, int rows, long long n) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= rows) return;
  float* ring = smem + warp * (kStages + 1) * kTileWords;
  float* stage = ring + kStages * kTileWords;
  const float* x = w + (long long)r * n;
  float* y = out + (long long)r * n;
  Params P;
  P.load(params + 6 * r);
  const bool vin = aligned16(x), vout = aligned16(y);
  const long long tiles = (n + kTile - 1) / kTile;
  float carry_o = x[0];       // o_{-1}
  long long carry_last = -1;  // the last active index before the tile
  Segment S;
  for (int t = 0; t < kStages - 1; ++t) load_tile(ring, x, n, t, lane, vin);
  for (long long t = 0; t < tiles; ++t) {
    // the slot of tile t - 1 was stored last iteration: refill it
    load_tile(ring, x, n, t + kStages - 1, lane, vin);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    __syncwarp();
    const long long base = t * kTile;
    const int len = (int)min((long long)kTile, n - base);
    const int seg_len = min(max(len - lane * kSeg, 0), kSeg);
    const int groups = (seg_len + 3) / 4;
    const float* xs = ring + (int)(t % kStages) * kTileWords + lane * kStride;
    float* os = stage + lane * kStride;
    // the segment into registers; past the row (a ragged last tile) the
    // samples are zeros and stale words, whose outputs are never stored
    // and which only empty segments follow
#pragma unroll
    for (int g = 0; g < kSeg / 4; ++g) {
      const float4 v = ld4(xs + 4 * g);
      const int p = 4 * g;
      S.t[p] = p < seg_len ? v.x : 0.0f;
      S.t[p + 1] = p + 1 < seg_len ? v.y : 0.0f;
      S.t[p + 2] = p + 2 < seg_len ? v.z : 0.0f;
      S.t[p + 3] = p + 3 < seg_len ? v.w : 0.0f;
    }

    // the last active sample before each segment: a warp max-scan
    int last = -1;  // in the tile
#pragma unroll
    for (int i = 0; i < kSeg; ++i)
      last = S.t[i] > P.thresh ? lane * kSeg + i : last;
    int incl = last;
#pragma unroll
    for (int d = 1; d < kLanes; d <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl = max(incl, up);
    }
    int excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = -1;
    const long long before = excl >= 0 ? base + excl : carry_last;
    const int incl_all = __shfl_sync(kFull, incl, kLanes - 1);
    if (incl_all >= 0) carry_last = base + incl_all;

    // the targets: idle = min(p - last, 2^24), last the latest active
    // position <= p in the tile's coordinates (no further back than
    // 2^24 + 1); then the speculative walk from the first
    last = (int)max(before - base, -(long long)kIdleStuck - 1);
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      const int p = lane * kSeg + i;
      last = S.t[i] > P.thresh ? p : last;
      S.t[i] = P.target(S.t[i], min(p - last, kIdleStuck));
    }
    const bool ragged = len < kTile;
    // this lane's end as it stands
    float e = ragged ? S.walk<true>(P, os, groups)
                     : S.walk<false>(P, os, groups);

    // rounds: walk again from the predecessor's end until the outputs
    // meet; a lane that does not meet them has a new end
    bool redo = seg_len > 0;
    for (;;) {
      float s = __shfl_up_sync(kFull, e, 1);
      if (lane == 0) s = carry_o;
      bool changed = false;
      if (redo) {
        float o2 = s;
        if (!(ragged ? S.meet<true>(P, os, groups, o2)
                     : S.meet<false>(P, os, groups, o2))) {
          e = o2;
          changed = true;
        }
      }
      const unsigned ch = __ballot_sync(kFull, changed);
      if ((ch & ~(1u << (kLanes - 1))) == 0) break;
      redo = lane > 0 && ((ch >> (lane - 1)) & 1u) && seg_len > 0;
    }
    carry_o = __shfl_sync(kFull, e, kLanes - 1);
    __syncwarp();
    store_tile(y + base, stage, len, lane, vout);
    __syncwarp();
  }
}

// the chain alone: lane 0 computes the targets of the first min(n, kTile)
// samples of row 0 (cut to a multiple of 4) into shared memory, then walks
// o over them `reps` times (each pass from the last one's end) as the
// kernel's walks do, four steps a group with the loads a group ahead and
// each output written to shared memory, and writes the SM clock cycles the
// passes took and a sum that keeps the work
__global__ void gpu_floor_cycles_kernel(const float* __restrict__ w,
                                        const float* __restrict__ params,
                                        long long n, int reps,
                                        long long* __restrict__ cycles,
                                        float* __restrict__ sink) {
  __shared__ __align__(16) float ts[kTile + 4];
  __shared__ __align__(16) float os[kTile];
  const int len = (n < kTile ? (int)n : kTile) & ~3;
  for (int i = threadIdx.x; i < kTile + 4; i += 32) ts[i] = i < len ? w[i] : 0.0f;
  __syncwarp();
  if (threadIdx.x != 0) return;
  Params P;
  P.load(params);
  int last = -1;
  for (int i = 0; i < len; ++i) {
    last = ts[i] > P.thresh ? i : last;
    ts[i] = P.target(ts[i], min(i - last, kIdleStuck));
  }
  float o = w[0], acc = 0.0f;
  const long long t0 = clock64();
  for (int k = 0; k < reps; ++k) {
    float4 t = ld4(ts);
    for (int g = 0; g < len / 4; ++g) {
      const float4 tn = ld4(ts + 4 * g + 4);
      const float4 v = walk4(P, o, t);
      *reinterpret_cast<float4*>(os + 4 * g) = v;
      o = v.w;
      t = tn;
    }
    acc += os[k % len];
  }
  const long long t1 = clock64();
  cycles[0] = t1 - t0;
  sink[0] = acc + o;
}

}  // namespace

extern "C" int gpu_floor_launch(const void* w, const void* params, void* out,
                                int rows, long long n, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  static int sms = 0;
  static size_t opted = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int warps = (rows + sms - 1) / sms;
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const int blocks = (rows + warps - 1) / warps;
  const size_t smem = sizeof(float) * (size_t)warps * (kStages + 1) *
                      kTileWords;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        gpu_floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * (size_t)kMaxWarps * (kStages + 1) *
              kTileWords));
    if (err != cudaSuccess) return (int)err;
    opted = sizeof(float) * (size_t)kMaxWarps * (kStages + 1) * kTileWords;
  }
  gpu_floor_kernel<<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)params, (float*)out, rows, n);
  return (int)cudaGetLastError();
}

// cycles[0] = SM cycles of reps * (min(n, 2048) cut to a multiple of 4)
// dependent steps (see gpu_floor_cycles_kernel); a probe of the chain's
// own length per step
extern "C" int gpu_floor_step_cycles(const void* w, const void* params,
                                     long long n, int reps, void* cycles,
                                     void* sink, void* stream) {
  if (n < 4 || reps <= 0) return (int)cudaErrorInvalidValue;
  gpu_floor_cycles_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)params, n, reps, (long long*)cycles,
      (float*)sink);
  return (int)cudaGetLastError();
}
