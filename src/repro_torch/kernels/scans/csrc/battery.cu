// Rack battery state-of-charge recursion, hard semantics: kernel C of the
// port.
//
// Replaces the reference's per-sample lax.scan of RackBattery.apply_jax
// (src/repro/core/smoothing/battery.py:96): an EMA grid target, the
// charge/discharge mode with its switch latency, SoC tapers near the
// bounds, power and energy limits and the round-trip efficiency.
//
// Bound on this card: a serial chain.  Each sample's SoC, target, mode and
// hold depend on the previous sample's, so a row costs one dependent step
// per sample (about thirty f32 operations, three divisions in a row on the
// SoC's path); rows are independent.  Device memory must not sit on
// that chain.  So one warp takes one row: its 32 lanes copy the row in
// tiles of kTile samples into a ring of kStages shared-memory slots with
// cp.async, kStages - 1 tiles ahead of the chain; lane 0 runs the chain on
// the tile in shared memory and writes each grid value over its input
// there; then the 32 lanes store the finished tile, coalesced, and the slot
// takes the next tile's copy.  The copies are 4 bytes a lane, so a row may
// start anywhere (a row of n samples starts at r n).  It writes the grid
// trace and the row's SoC minimum and maximum, not the SoC trace, which
// nothing on the Study path reads.
//
// The f32 operations are those of the reference step, in its order, with no
// fused multiply-add (built with -fmad=false), and every division correctly
// rounded, so the kernel equals battery_scan_plain bit for bit.  The IEEE
// division is the chain's longest link, and an empty battery's SoC leaves
// tiny and subnormal residues that send it down its slow path for
// thousands of steps; so a step divides by div_rn (a one-correction
// division in f32) where its dividends allow, else by the IEEE division,
// and the tiles after one with such a step divide by div64 (the same in
// f64, rounded once) until one fits div_rn again (see div_rn below).
//
// params[r] = {alpha, lat_n, cap_j, max_dis, max_chg, eff, soc0, tgt0}.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 512;   // samples per ring slot
constexpr int kStages = 4;   // ring slots: kStages - 1 tiles in flight

__device__ __forceinline__ float clipf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float signf(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

// Two correctly rounded divisions that avoid the IEEE division's
// reciprocal, range check and slow path.  Both take y = RN(1 / b), held
// per row, and Markstein's theorem: with q0 = RN(a y) and the residual
// nr = RN(b q0 - a), RN(q0 - nr y) is RN(a / b) wherever nothing
// underflows or overflows.  The residual is taken negated so that a zero a
// gives back its own signed zero.
//
// div_rn, in f32, for b in [2^-50, 2^50] and a zero or |a| in [2^-50,
// 2^50) (then q0 and nr are normal); `ok` turns false for another a.  (The
// range test is written out in both divisions: shared through a helper it
// made the kernel markedly slower on the H100.)
__device__ __forceinline__ float div_rn(float a, float b, float y,
                                        bool& ok) {
  const float m = fabsf(a);
  ok = ok && ((m >= 0x1p-50f && m < 0x1p50f) || a == 0.0f);
  const float q0 = __fmul_rn(a, y);
  const float nr = __fmaf_rn(b, q0, -a);
  return __fmaf_rn(-nr, y, q0);
}

// div64, in f64 and then rounded once to f32 (53 >= 2 * 24 + 2 bits, so
// the double rounding is innocuous, subnormal results included), for b a
// positive normal f32; `ok` turns false for a non-finite a, and ok32 for
// an a that div_rn would not take.
__device__ __forceinline__ float div64(float a, double b, double y,
                                       bool& ok, bool& ok32) {
  const float m = fabsf(a);
  ok = ok && m <= 3.4028235e38f;
  ok32 = ok32 && ((m >= 0x1p-50f && m < 0x1p50f) || a == 0.0f);
  const double ad = a;
  const double q0 = __dmul_rn(ad, y);
  const double nr = __fma_rn(b, q0, -ad);
  return __double2float_rn(__fma_rn(-nr, y, q0));
}

// the divisors' RN64 reciprocals, for div64, kept apart from the stepped
// state
struct Recip64 {
  double cap, eff, dt, tenth;
};

__device__ __forceinline__ bool fast_divisor(float b) {
  return b >= 0x1p-50f && b <= 0x1p50f;
}

struct Battery {
  float alpha, lat_n, cap_j, max_dis, max_chg, eff, dt;
  float soc, tgt, mode, hold, lo, hi;
  float r_cap, r_eff, r_dt, r_tenth;   // RN32 reciprocals of the divisors
  bool fast;   // every divisor in div_rn's range
  bool fell;   // a step of this tile left div_rn's range

  __device__ void init(const float* p, float dt_) {
    alpha = p[0], lat_n = p[1], cap_j = p[2], max_dis = p[3];
    max_chg = p[4], eff = p[5], dt = dt_, soc = p[6], tgt = p[7];
    mode = 0.0f, hold = 0.0f;
    lo = __int_as_float(0x7f800000), hi = -lo;
    fast = fast_divisor(cap_j) && fast_divisor(eff) && fast_divisor(dt);
    r_cap = __frcp_rn(cap_j), r_eff = __frcp_rn(eff), r_dt = __frcp_rn(dt);
    r_tenth = __frcp_rn(0.1f);
    fell = false;
  }

  // a / b by div_rn (kFast) or IEEE
  template <bool kFast>
  __device__ __forceinline__ float div(float a, float b, float y,
                                       bool& ok) const {
    if constexpr (kFast)
      return div_rn(a, b, y, ok);
    else
      return a / b;
  }

  // one sample of the reference step on the state in *this: the
  // grid-side power
  template <bool kFast>
  __device__ __forceinline__ float advance(float v, bool& ok) {
    tgt = tgt + alpha * (v - tgt);
    const float want = v - tgt;
    const float new_mode = signf(want);
    const bool switching =
        (new_mode != mode) && (new_mode != 0.0f) && (mode != 0.0f);
    hold = switching ? lat_n : fmaxf(hold - 1.0f, 0.0f);
    const bool blocked = hold > 0.0f;
    const float soc_frac = div<kFast>(soc, cap_j, r_cap, ok);
    const float taper_lo =
        clipf(div<kFast>(soc_frac, 0.1f, r_tenth, ok), 0.0f, 1.0f);
    const float taper_hi =
        clipf(div<kFast>(1.0f - soc_frac, 0.1f, r_tenth, ok), 0.0f, 1.0f);
    float dis = clipf(want, 0.0f, max_dis * taper_lo);
    dis = fminf(dis, div<kFast>(soc * eff, dt, r_dt, ok));
    float chg = clipf(-want, 0.0f, max_chg * taper_hi);
    chg = fminf(chg, div<kFast>(div<kFast>(cap_j - soc, eff, r_eff, ok), dt,
                                r_dt, ok));
    if (blocked) { dis = 0.0f; chg = 0.0f; }
    const float g = v - dis + chg;
    soc = soc - div<kFast>(dis * dt, eff, r_eff, ok) + chg * dt * eff;
    soc = clipf(soc, 0.0f, cap_j);
    mode = new_mode;
    lo = fminf(lo, soc);
    hi = fmaxf(hi, soc);
    return g;
  }

  // the same step by div64.  It is written out apart from advance: with
  // one body for both, the div_rn loop ran slower on the H100.
  __device__ __forceinline__ float advance64(float v, const Recip64& Z,
                                           bool& ok, bool& ok32) {
    tgt = tgt + alpha * (v - tgt);
    const float want = v - tgt;
    const float new_mode = signf(want);
    const bool switching =
        (new_mode != mode) && (new_mode != 0.0f) && (mode != 0.0f);
    hold = switching ? lat_n : fmaxf(hold - 1.0f, 0.0f);
    const bool blocked = hold > 0.0f;
    const float soc_frac = div64(soc, cap_j, Z.cap, ok, ok32);
    const float taper_lo =
        clipf(div64(soc_frac, 0.1f, Z.tenth, ok, ok32), 0.0f, 1.0f);
    const float taper_hi =
        clipf(div64(1.0f - soc_frac, 0.1f, Z.tenth, ok, ok32), 0.0f, 1.0f);
    float dis = clipf(want, 0.0f, max_dis * taper_lo);
    dis = fminf(dis, div64(soc * eff, dt, Z.dt, ok, ok32));
    float chg = clipf(-want, 0.0f, max_chg * taper_hi);
    chg = fminf(chg, div64(div64(cap_j - soc, eff, Z.eff, ok, ok32), dt,
                           Z.dt, ok, ok32));
    if (blocked) { dis = 0.0f; chg = 0.0f; }
    const float g = v - dis + chg;
    soc = soc - div64(dis * dt, eff, Z.eff, ok, ok32) + chg * dt * eff;
    soc = clipf(soc, 0.0f, cap_j);
    mode = new_mode;
    lo = fminf(lo, soc);
    hi = fmaxf(hi, soc);
    return g;
  }

  // one step by div_rn (kFast), redone by IEEE from the same state if a
  // dividend left its range
  template <bool kFast>
  __device__ __forceinline__ float step(float v) {
    bool ok = true;
    if constexpr (kFast) {
      Battery next = *this;
      const float g = next.advance<true>(v, ok);
      if (ok) {
        *this = next;
        return g;
      }
      fell = true;
    }
    return advance<false>(v, ok);
  }

  // one step by div64, else (a non-finite dividend) by IEEE; ok32 says
  // whether div_rn would have taken it
  __device__ __forceinline__ float step64(float v, const Recip64& Z,
                                         bool& ok32) {
    bool ok = true;
    ok32 = true;
    Battery next = *this;
    const float g = next.advance64(v, Z, ok, ok32);
    if (ok) {
      *this = next;
      return g;
    }
    return advance<false>(v, ok);
  }

  // n samples in shared memory, each grid value written over its sample
  template <bool kFast>
  __device__ __forceinline__ void run(float* xs, int n) {
#pragma unroll 8
    for (int i = 0; i < n; ++i) xs[i] = step<kFast>(xs[i]);
  }

  // a tile: by div_rn steps unless the last tile had one that fell back to
  // IEEE, else by div64 steps until a whole tile would have stayed in
  // div_rn's range (an empty battery's residues last for runs of tiles,
  // and there IEEE takes its slow path).  No loop leaves early, so that
  // the steps of a tile overlap.
  __device__ __forceinline__ void tile(float* xs, int n, const Recip64& Z) {
    if (!fast) {
      run<false>(xs, n);
    } else if (!fell) {
      run<true>(xs, n);
    } else {
      bool all32 = true, ok32;
      for (int i = 0; i < n; ++i) {
        xs[i] = step64(xs[i], Z, ok32);
        all32 = all32 && ok32;
      }
      fell = !all32;
    }
  }
};

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// every lane: copy tile t of the row (if it exists) into its slot, and
// close one cp.async group either way, so that group t is tile t
__device__ __forceinline__ void load_tile(float (*ring)[kTile],
                                          const float* x, long long n,
                                          long long t, int lane) {
  if (t * kTile < n) {
    float* slot = ring[t % kStages];
    const long long base = t * kTile;
    for (int i = lane; i < kTile && base + i < n; i += 32)
      copy4(slot + i, x + base + i);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(32)
battery_kernel(const float* __restrict__ w, const float* __restrict__ params,
               float dt, float* __restrict__ grid, float* __restrict__ soc_min,
               float* __restrict__ soc_max, long long n) {
  __shared__ float ring[kStages][kTile];
  const int r = blockIdx.x, lane = threadIdx.x;
  const float* x = w + (long long)r * n;
  float* g = grid + (long long)r * n;
  Battery bat;
  bat.init(params + 8 * r, dt);
  const Recip64 Z = {__drcp_rn(bat.cap_j), __drcp_rn(bat.eff), __drcp_rn(dt),
                     __drcp_rn(0.1f)};
  const long long tiles = (n + kTile - 1) / kTile;
  for (int t = 0; t < kStages - 1; ++t) load_tile(ring, x, n, t, lane);
  for (long long t = 0; t < tiles; ++t) {
    // the slot of tile t - 1 was stored last iteration: refill it
    load_tile(ring, x, n, t + kStages - 1, lane);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    __syncwarp();
    float* slot = ring[t % kStages];
    const long long base = t * kTile;
    const int len = n - base < kTile ? (int)(n - base) : kTile;
    if (lane == 0) bat.tile(slot, len, Z);
    __syncwarp();
    for (int i = lane; i < len; i += 32) g[base + i] = slot[i];
    __syncwarp();
  }
  if (lane == 0) {
    soc_min[r] = bat.lo;
    soc_max[r] = bat.hi;
  }
}

// the chain alone: lane 0 runs the steps over the first min(n, kTile)
// samples of row 0, already in shared memory, `reps` times (each pass on
// the grid values the last one left there), and writes the SM clock
// cycles it took and a sum that keeps the work; `ieee` forces the IEEE
// division throughout
__global__ void battery_cycles_kernel(const float* __restrict__ w,
                                      const float* __restrict__ params,
                                      float dt, long long n, int reps,
                                      int ieee, long long* __restrict__ cycles,
                                      float* __restrict__ sink) {
  __shared__ float xs[kTile];
  const int len = n < kTile ? (int)n : kTile;
  for (int i = threadIdx.x; i < len; i += 32) xs[i] = w[i];
  __syncwarp();
  if (threadIdx.x != 0) return;
  Battery bat;
  bat.init(params, dt);
  float acc = 0.0f;
  const long long t0 = clock64();
  for (int k = 0; k < reps; ++k) {
    if (bat.fast && !ieee) bat.run<true>(xs, len); else bat.run<false>(xs, len);
    acc += xs[len - 1];
  }
  const long long t1 = clock64();
  cycles[0] = t1 - t0;
  sink[0] = acc + bat.soc;
}

}  // namespace

extern "C" int battery_launch(const void* w, const void* params, float dt,
                              void* grid, void* soc_min, void* soc_max,
                              int rows, long long n, void* stream) {
  if (rows <= 0) return 0;
  battery_kernel<<<rows, 32, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)params, dt, (float*)grid,
      (float*)soc_min, (float*)soc_max, n);
  return (int)cudaGetLastError();
}

// cycles[0] = SM cycles of reps * min(n, 512) dependent steps (see
// battery_cycles_kernel); a probe of the chain's own length per step
extern "C" int battery_step_cycles(const void* w, const void* params,
                                   float dt, long long n, int reps, int ieee,
                                   void* cycles, void* sink, void* stream) {
  if (n <= 0 || reps <= 0) return (int)cudaErrorInvalidValue;
  battery_cycles_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)params, dt, n, reps, ieee,
      (long long*)cycles, (float*)sink);
  return (int)cudaGetLastError();
}
