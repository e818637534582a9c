// Escalation state machine over a class stream: kernel D of the port.
//
// Replaces the reference's escalation scan (src/repro/core/telemetry.py,
// escalation_scan, the blocked lax.scan at line 212), which folds
// escalation_class_step over the per-sample classes the monitor emits.
//
// Semantics, per sample (class 2 hit, 1 band, 0 clear, 3 pad = identity):
//   above = hit ? above+1 : (pad ? above : 0)
//   below = clear ? below+1 : (pad ? below : 0)
//   esc   = hit && above >= sustain && level < max_level
//   detect latches the global index of the first escalation; level += esc,
//   above = 0 on esc; deesc = clear && below >= cool && level > 0 lowers the
//   level by one and resets below.  (A sample is never both hit and clear,
//   so deesc may read the level from before the sample's esc.)
//
// Bound on this card: a serial chain.  Each sample's transition depends on
// the previous sample's (level, above, below), so one row costs one
// dependent step per sample; rows are independent.  The bytes (one int8 in,
// one int8 out per sample) are far below what the card moves in that time.
// So nothing but the step may sit on the chain: no load from device memory
// (a row a thread would put one there, its lanes n bytes apart), and no
// int64 arithmetic, two instructions an operation, where int32 is exact.
//
// Design (kernel C's, battery.cu): one warp a row, rows spread over the
// SMs (a block holds ceil(rows / SMs) warps, at most 8).  The warp's 32
// lanes copy the row in tiles of kTile classes into a ring of kStages
// shared-memory slots with cp.async, 16 bytes a lane, kStages - 1 tiles
// ahead of the chain; lane 0 walks the chain over the tile in shared memory,
// four classes to a 32-bit word, and writes each level over its class
// there; then the 32 lanes store the finished tile, 16 bytes a lane.  A row
// whose start is not 16-byte aligned (n % 16 != 0) is copied and stored a
// byte a lane.  detect is off the chain: lane 0 only notes whether the tile
// escalated, and while no escalation has been latched the warp finds the
// tile's first one in the levels it wrote (the first step up by one).
//
// 32-bit counters.  level, above and below are int32 on the chain for a row
// whose values provably stay in range: level stays in [min(level0, 0),
// max(level0, max_level)] and above, below grow by at most one a sample, so
// the row runs in int32 when level0, max_level, sustain and cool fit int32
// and above0 + n, below0 + n < 2^31 (above0, below0 >= -2^31).  Any other
// row runs the int64 instantiation of the same code.  This is a range rule
// checked per row before its walk, not a fallback; core/telemetry.py's
// escalation_fits_int32 states it for the tests.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;    // classes per ring slot: 32 lanes x 2 x 16 B
constexpr int kStages = 4;     // ring slots: kStages - 1 tiles in flight
constexpr int kMaxWarps = 8;   // rows a block

// sustain - 1 (cool - 1), so that a step compares the counter from before
// its sample; at the type's least value both comparisons always hold
template <typename I>
__device__ __forceinline__ I less_one(long long v) {
  const long long lo = sizeof(I) == 4 ? (long long)INT_MIN : LLONG_MIN;
  return v == lo ? (I)v : (I)(v - 1);
}

template <typename I>
struct Machine {
  I level, above, below, sustain1, cool1, max_level;

  // One transition on class k; the new level, and whether it escalated.
  // The escalation tests read level, above and below from before the
  // sample (above + 1 >= sustain is above >= sustain - 1), and the level
  // picks level + 1 or level - 1, so each counter's dependent chain a step
  // is a compare and a select or two.
  __device__ __forceinline__ I step(unsigned k, bool& esc_any) {
    const bool hit = k == 2u, clear = k == 0u, pad = k == 3u;
    const I up = hit ? above + 1 : (pad ? above : I(0));
    const I dn = clear ? below + 1 : (pad ? below : I(0));
    const bool esc = hit && above >= sustain1 && level < max_level;
    const bool deesc = clear && below >= cool1 && level > I(0);
    above = esc ? I(0) : up;
    below = deesc ? I(0) : dn;
    level = esc ? level + 1 : (deesc ? level - 1 : level);
    esc_any = esc_any || esc;
    return level;
  }

  // the len classes at xs (4-byte aligned), each replaced by its level;
  // returns whether any sample escalated
  __device__ __forceinline__ bool run(int8_t* xs, int len) {
    bool any = false;
    int i = 0;
#pragma unroll 4
    for (; i + 4 <= len; i += 4) {
      const unsigned w = *reinterpret_cast<const unsigned*>(xs + i);
      unsigned o = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const I lv = step((w >> (8 * e)) & 0xffu, any);
        o |= ((unsigned)lv & 0xffu) << (8 * e);
      }
      *reinterpret_cast<unsigned*>(xs + i) = o;
    }
    for (; i < len; ++i) xs[i] = (int8_t)step((unsigned)(uint8_t)xs[i], any);
    return any;
  }
};

__device__ __forceinline__ void cp_async16(int8_t* dst, const int8_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// every lane: copy tile t of the row (if it exists) into its slot, and
// close one cp.async group either way, so that group t is tile t
__device__ __forceinline__ void load_tile(int8_t (*ring)[kTile],
                                          const int8_t* row, long long n,
                                          long long t, int lane, bool vec) {
  if (t * kTile < n) {
    int8_t* slot = ring[t % kStages];
    const int8_t* src = row + t * kTile;
    const int len = (int)min((long long)kTile, n - t * kTile);
    if (vec) {
      for (int p = 16 * lane; p < len; p += 16 * 32) {
        if (p + 16 <= len) {
          cp_async16(slot + p, src + p);
        } else {
          for (int q = p; q < len; ++q) slot[q] = src[q];
        }
      }
    } else {
      for (int p = lane; p < len; p += 32) slot[p] = src[p];
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void store_tile(int8_t* dst, const int8_t* slot,
                                           int len, int lane, bool vec) {
  if (vec) {
    for (int p = 16 * lane; p < len; p += 16 * 32) {
      if (p + 16 <= len) {
        *reinterpret_cast<int4*>(dst + p) =
            *reinterpret_cast<const int4*>(slot + p);
      } else {
        for (int q = p; q < len; ++q) dst[q] = slot[q];
      }
    }
  } else {
    for (int p = lane; p < len; p += 32) dst[p] = slot[p];
  }
}

// the first position of the tile's levels (len of them, the level before
// them lv0) that steps up by one, or len; every lane gets it
__device__ __forceinline__ int first_step_up(const int8_t* slot, int len,
                                             int8_t lv0, int lane) {
  int first = len;
  for (int p = lane; p < len; p += 32) {
    const int8_t prev = p == 0 ? lv0 : slot[p - 1];
    if ((int8_t)(slot[p] - prev) == 1) {
      first = p;
      break;
    }
  }
  return __reduce_min_sync(0xffffffffu, first);
}

// one warp walks one row with the machine m (valid in lane 0)
template <typename I>
__device__ void walk(int8_t (*ring)[kTile], const int8_t* row, int8_t* out,
                     long long n, long long g0, Machine<I>& m,
                     long long& detect, int lane) {
  const bool vin = aligned16(row), vout = aligned16(out);
  const long long tiles = (n + kTile - 1) / kTile;
  for (int t = 0; t < kStages - 1; ++t) load_tile(ring, row, n, t, lane, vin);
  for (long long t = 0; t < tiles; ++t) {
    // the slot of tile t - 1 was stored last iteration: refill it
    load_tile(ring, row, n, t + kStages - 1, lane, vin);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    __syncwarp();
    int8_t* slot = ring[t % kStages];
    const long long base = t * kTile;
    const int len = (int)min((long long)kTile, n - base);
    const int8_t lv0 = (int8_t)m.level;
    bool any = false;
    if (lane == 0) any = m.run(slot, len);
    __syncwarp();
    if (__shfl_sync(0xffffffffu, any, 0) && detect < 0)
      detect = g0 + base + first_step_up(slot, len, lv0, lane);
    store_tile(out + base, slot, len, lane, vout);
    __syncwarp();
  }
}

__device__ __forceinline__ bool in32(long long v) {
  return v >= INT_MIN && v <= INT_MAX;
}

__global__ void escalation_kernel(const int8_t* __restrict__ cls,
                                  const long long* __restrict__ idx0,
                                  const long long* __restrict__ carry_in,
                                  int8_t* __restrict__ levels,
                                  long long* __restrict__ carry_out,
                                  int rows, long long n, long long sustain,
                                  long long cool, long long max_level) {
  extern __shared__ __align__(16) int8_t ring_mem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= rows) return;
  int8_t(*ring)[kTile] =
      reinterpret_cast<int8_t(*)[kTile]>(ring_mem + warp * kStages * kTile);
  const int8_t* row = cls + (long long)r * n;
  int8_t* out = levels + (long long)r * n;
  const long long* c = carry_in + 4 * r;
  long long detect = c[3];
  const long long g0 = idx0[r];
  const bool narrow = in32(c[0]) && in32(max_level) && in32(sustain) &&
                      in32(cool) && c[1] >= INT_MIN && c[2] >= INT_MIN &&
                      c[1] <= (long long)INT_MAX - n &&
                      c[2] <= (long long)INT_MAX - n;
  long long lv, ab, be;
  if (narrow) {
    Machine<int> m = {(int)c[0], (int)c[1], (int)c[2], less_one<int>(sustain),
                      less_one<int>(cool), (int)max_level};
    walk(ring, row, out, n, g0, m, detect, lane);
    lv = m.level, ab = m.above, be = m.below;
  } else {
    Machine<long long> m = {c[0], c[1], c[2], less_one<long long>(sustain),
                            less_one<long long>(cool), max_level};
    walk(ring, row, out, n, g0, m, detect, lane);
    lv = m.level, ab = m.above, be = m.below;
  }
  if (lane == 0) {
    long long* o = carry_out + 4 * r;
    o[0] = lv, o[1] = ab, o[2] = be, o[3] = detect;
  }
}

// the chain alone: lane 0 runs the int32 (or, with wide, the int64) machine
// over the first min(n, kTile) classes of row 0, already in shared memory,
// reps times (each pass on the levels the last one left there: levels are
// classes too), and writes the SM clock cycles it took and a sum that
// keeps the work
__global__ void escalation_cycles_kernel(const int8_t* __restrict__ cls,
                                         long long n, int reps, int wide,
                                         long long sustain, long long cool,
                                         long long max_level,
                                         long long* __restrict__ cycles,
                                         long long* __restrict__ sink) {
  __shared__ __align__(16) int8_t xs[kTile];
  const int len = n < kTile ? (int)n : kTile;
  for (int i = threadIdx.x; i < len; i += 32) xs[i] = cls[i];
  __syncwarp();
  if (threadIdx.x != 0) return;
  long long acc = 0, t0, t1;
  if (wide) {
    Machine<long long> m = {0, 0, 0, less_one<long long>(sustain),
                            less_one<long long>(cool), max_level};
    t0 = clock64();
    for (int k = 0; k < reps; ++k) acc += m.run(xs, len);
    t1 = clock64();
    acc += m.level + m.above + m.below;
  } else {
    Machine<int> m = {0, 0, 0, less_one<int>(sustain), less_one<int>(cool),
                      (int)max_level};
    t0 = clock64();
    for (int k = 0; k < reps; ++k) acc += m.run(xs, len);
    t1 = clock64();
    acc += m.level + m.above + m.below;
  }
  cycles[0] = t1 - t0;
  sink[0] = acc;
}

}  // namespace

extern "C" int escalation_launch(const void* cls, const void* idx0,
                                 const void* carry_in, void* levels,
                                 void* carry_out, int rows, long long n,
                                 long long sustain, long long cool,
                                 long long max_level, void* stream) {
  if (rows <= 0) return 0;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int warps = (rows + sms - 1) / sms;
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const int blocks = (rows + warps - 1) / warps;
  const size_t smem = (size_t)warps * kStages * kTile;
  escalation_kernel<<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const int8_t*)cls, (const long long*)idx0,
      (const long long*)carry_in, (int8_t*)levels, (long long*)carry_out,
      rows, n, sustain, cool, max_level);
  return (int)cudaGetLastError();
}

// cycles[0] = SM cycles of reps * min(n, 1024) dependent steps (see
// escalation_cycles_kernel); a probe of the chain's own length per step.
// The int32 machine needs sustain, cool and max_level in int32.
extern "C" int escalation_step_cycles(const void* cls, long long n, int reps,
                                      int wide, long long sustain,
                                      long long cool, long long max_level,
                                      void* cycles, void* sink,
                                      void* stream) {
  if (n <= 0 || reps <= 0) return (int)cudaErrorInvalidValue;
  if (!wide && (sustain > INT_MAX || cool > INT_MAX || max_level > INT_MAX ||
                sustain < INT_MIN || cool < INT_MIN || max_level < INT_MIN))
    return (int)cudaErrorInvalidValue;
  escalation_cycles_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const int8_t*)cls, n, reps, wide, sustain, cool, max_level,
      (long long*)cycles, (long long*)sink);
  return (int)cudaGetLastError();
}
