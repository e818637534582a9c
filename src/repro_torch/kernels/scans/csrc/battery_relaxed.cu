// Relaxed rack battery state-of-charge recursion (smooth_tau > 0), forward
// and adjoint: kernel K of the port.
//
// Replaces the reference's per-sample lax.scan of RackBattery._apply_smooth
// (src/repro/core/smoothing/battery.py:106) and the reverse scan that
// jax.grad derives from it.  No TPU kernel stands behind it: the reference
// leaves both scans to XLA.  The design's gradient descent
// (core/engine.py design_gradient) runs this pair once per Adam step on
// every start.
//
// Per sample i of a row, with params {alpha, lat_n, cap, w_lo, w_hi,
// max_dis, max_chg, eff, soc0, tgt0, p_scale}, Z = tau p_scale and
// Y = tau (lat_n + 1):
//   tgt   = tgt + alpha (x - tgt);            want = x - tgt
//   mode' = tanh(want / Z)
//   sw    = clip(-(mode' mode), 0, 1)
//   hold  = sw lat_n + (1 - sw) max(hold - 1, 0)
//   open  = sigmoid((0.5 - hold) / Y)
//   dis   = open min(clip(want, 0, max_dis clip(soc / w_lo, 0, 1)),
//                    soc eff / dt)
//   chg   = open min(clip(-want, 0, max_chg clip((cap - soc) / w_hi, 0, 1)),
//                    (cap - soc) / eff / dt)
//   grid  = x - dis + chg
//   soc   = clip(soc - dis dt / eff + chg dt eff, 0, cap)
// from soc = soc0, tgt = tgt0, mode = hold = 0.  clip(v, lo, hi) is
// min(max(v, lo), hi).
//
// The forward writes the grid and SoC traces and the other three carries
// (target, mode, hold) after each step.  The adjoint recomputes each step
// from the carries before it with the forward's own expressions, and
// carries the adjoints of the carries back along the row, plus
// the caller's gradient with respect to the SoC trace where it passes one.
// It writes the gradient with respect to every sample and, summed in f64
// over the row, with respect to each parameter (lat_n's stays 0: the
// reference holds it with stop_gradient).  A max or min whose two sides are
// equal sends half of the gradient to each side, as JAX's lax.max and
// lax.min do; ties are real here (the SoC is clipped right after the
// discharge limit has drained it, and the tapers sit at 0 and 1).
//
// Bound on this card: the serial chains.  Three recurrences are serial in
// the forward: the target (three operations a step), the hold (four) and
// the SoC (about twenty, with five divisions, two of them in a row on its
// path); the mode's tanh, the open gate's sigmoid and the power limits'
// inputs depend on the chains' values but feed nothing back.  A design
// call has 6 or 10 rows, so a warp a row leaves most of the card idle;
// here each row is cut into chunks of 1024 samples, a warp a chunk, over
// the whole card (chain_walk.cuh has the scheme).
//
//  * Forward, one launch: a chunk's warp runs the three recurrences one
//    after the other, each as segmented walks with the exact merge test,
//    handing its end to the next chunk before it starts the next one, so
//    along a row the target's wave runs ahead of the hold's, and the hold's
//    ahead of the SoC's.  The target never forgets (its walks never meet:
//    it is the serial chain of three operations it was); the hold is
//    exactly lat_n where the switch is 1 and 0 where it has run out; the
//    SoC is exact after a clip to 0 or cap, and a battery that never
//    reaches a bound walks its row serially.  Between them the lanes
//    compute want, the mode, the switch and the open gate per sample, and
//    the grid after the SoC from each sample's SoC before it.  The SoC step
//    divides by div_rn (a correctly rounded division from a per-row
//    reciprocal and one correction, kernel C's), falling back to the IEEE
//    division for a group of 8 steps that leaves its range; two values a
//    step, the SoC and dis dt, are checked, the others follow from a row's
//    bounds (Bat::fast), so its bits are the IEEE division's.  The outputs
//    equal a warp-a-row kernel's (every division IEEE) bit for bit.
//  * Adjoint, one launch, chunks from the row's end: three float64 affine
//    scans in their dependency order.  The SoC's carry is A_i (c_i + gs_i)
//    + B_i (A_i and B_i the SoC step's adjoint at (1, 0) and (0, g_i), per
//    sample from the saved carries); the hold's is (1 - sw_i) m_i (c_i -
//    q_i), q_i what the open gate sends back; the target's is (1 - alpha)
//    (c_i - dwant_i), with 1 - alpha exact in float64 (in f32 it would move
//    a small alpha by up to 1e-3 of itself).  The mode needs no scan: its
//    adjoint is -dq_{i+1} mode_{i+1}, the next chunk's first sample's
//    passed in a mailbox.  Every other term is per sample; the parameter
//    sums are f64, reduced across the warp and then, by chunk 0, across
//    chunks in chunk order.
//  * battery_relaxed_step_cycles times the chains' own steps: the warp
//    walks the SoC, the hold and the target in step with the merge test,
//    or the adjoint's f64 affine steps, over a row's first 512 samples.
//
// Built with -fmad=false, so that the operations are those written here.
#include <cuda_runtime.h>

#include "chain_walk.cuh"

namespace {

using namespace chain;

constexpr int kCols = 11;

// ---- a correctly rounded division without the IEEE division's reciprocal
// and slow path: kernel C's div_rn (battery.cu; tests/
// test_torch_battery_division.py checks it exactly).  With y = RN(1 / b),
// q0 = RN(a y) and nr = RN(b q0 - a), RN(q0 - nr y) is RN(a / b) for b in
// [2^-50, 2^50] and a zero or |a| in [2^-50, 2^50).
__device__ __forceinline__ float div_rn(float a, float b, float y) {
  const float q0 = __fmul_rn(a, y);
  const float nr = __fmaf_rn(b, q0, -a);
  return __fmaf_rn(-nr, y, q0);
}

// 1 if a is neither zero nor of a magnitude in [2^lo, 2^lo + span) by its
// bits, else 0 (NaN and infinity give 1)
__device__ __forceinline__ unsigned outside(float a, unsigned lo,
                                            unsigned span) {
  const unsigned u = __float_as_uint(a) & 0x7fffffffu;
  return (u != 0u) & (u - lo >= span);
}

constexpr unsigned kBits50 = 0x26800000u;     // the bits of 2^-50
constexpr unsigned kSpan50 = 0x58800000u - kBits50;   // to 2^50
constexpr unsigned kBits40 = 0x2b800000u;     // the bits of 2^-40
constexpr unsigned kSpan40 = 0x53800000u - kBits40;   // to 2^40

__device__ __forceinline__ bool fast_divisor(float b) {
  return b >= 0x1p-50f && b <= 0x1p50f;
}

struct Bat {
  float alpha, lat, cap, w_lo, w_hi, max_dis, max_chg, eff, Z, Y, dt, tau;
  float r_lo, r_hi, r_eff, r_dt;   // RN32 reciprocals of the divisors
  // div_rn may stand in for every division of a step whose SoC before it
  // is 0 or in [2^-40, 2^40) and whose dis dt is 0 or in [2^-50, 2^50):
  // the divisors are in range, eff in [2^-8, 2^8] and cap in [2^-16,
  // 2^40], and every SoC a walk starts from lies in [0, cap] (soc0 does;
  // every step clips to it), so soc, cap - soc (0, or at least 2^-40:
  // exact where soc >= cap / 2, else at least cap / 2), soc eff and (cap -
  // soc) / eff are all zero or in [2^-50, 2^50)
  bool fast;

  __device__ void init(const float* p, float tau_, float dt_) {
    alpha = p[0]; lat = p[1]; cap = p[2]; w_lo = p[3]; w_hi = p[4];
    max_dis = p[5]; max_chg = p[6]; eff = p[7];
    Z = tau_ * p[10]; Y = tau_ * (lat + 1.0f); dt = dt_; tau = tau_;
    r_lo = __frcp_rn(w_lo); r_hi = __frcp_rn(w_hi);
    r_eff = __frcp_rn(eff); r_dt = __frcp_rn(dt);
    fast = fast_divisor(w_lo) && fast_divisor(w_hi) && fast_divisor(eff) &&
           fast_divisor(dt) && eff >= 0x1p-8f && eff <= 0x1p8f &&
           cap >= 0x1p-16f && cap <= 0x1p40f && p[8] >= 0.0f &&
           p[8] <= cap;
  }

  // a / b, by div_rn (kFast) or the IEEE division
  template <bool kFast>
  __device__ __forceinline__ float div(float a, float b, float y) const {
    if constexpr (kFast)
      return div_rn(a, b, y);
    else
      return a / b;
  }

  // the discharge and charge of a step from the SoC before it
  template <bool kFast>
  __device__ __forceinline__ void flows(float soc, float want, float of,
                                        float& dis, float& chg) const {
    const float tlo = fminf(fmaxf(div<kFast>(soc, w_lo, r_lo), 0.0f),
                            1.0f);
    const float thi = fminf(
        fmaxf(div<kFast>(cap - soc, w_hi, r_hi), 0.0f), 1.0f);
    dis = fminf(fmaxf(want, 0.0f), max_dis * tlo);
    dis = fminf(dis, div<kFast>(soc * eff, dt, r_dt));
    chg = fminf(fmaxf(-want, 0.0f), max_chg * thi);
    chg = fminf(chg, div<kFast>(div<kFast>(cap - soc, eff, r_eff), dt,
                                r_dt));
    dis = of * dis;
    chg = of * chg;
  }

  // one step; with kFast, `bad` turns nonzero where the step leaves the
  // range in which div_rn stands in for the IEEE division
  template <bool kFast>
  __device__ __forceinline__ float soc_next(float soc, float want, float of,
                                            unsigned& bad) const {
    float dis, chg;
    flows<kFast>(soc, want, of, dis, chg);
    const float dd = dis * dt;
    if constexpr (kFast)
      bad |= outside(soc, kBits40, kSpan40) | outside(dd, kBits50, kSpan50);
    const float s1 = soc - div<kFast>(dd, eff, r_eff) + chg * dt * eff;
    return fminf(fmaxf(s1, 0.0f), cap);
  }
};

__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float wmax(float a, float b) {
  return a > b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

__device__ __forceinline__ float wmin(float a, float b) {
  return a < b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

// ---- the forward's recurrences, over a lane's segment in shared memory

// tgt' = tgt + alpha (x - tgt)
struct TgtChain {
  const float* x;
  float alpha;
  __device__ __forceinline__ TgtChain shift(int d) const {
    return {x + d, alpha};
  }
  __device__ __forceinline__ float step(float s, int j) const {
    return s + alpha * (x[j] - s);
  }
  __device__ __forceinline__ void run8(float& s, int j, float* v) const {
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = s = step(s, j + q);
  }
};

// hold' = sw lat + (1 - sw) max(hold - 1, 0)
struct HoldChain {
  const float* sw;
  float lat;
  __device__ __forceinline__ HoldChain shift(int d) const {
    return {sw + d, lat};
  }
  __device__ __forceinline__ float step(float s, int j) const {
    return sw[j] * lat + (1.0f - sw[j]) * fmaxf(s - 1.0f, 0.0f);
  }
  __device__ __forceinline__ void run8(float& s, int j, float* v) const {
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = s = step(s, j + q);
  }
};

// soc' from want and the open gate; 8 steps by div_rn, again by the IEEE
// division if a dividend left its range
struct SocChain {
  const float* want;
  const float* of;
  Bat b;
  __device__ __forceinline__ SocChain shift(int d) const {
    return {want + d, of + d, b};
  }
  __device__ __forceinline__ float step(float s, int j) const {
    unsigned bad = 0;
    return b.soc_next<false>(s, want[j], of[j], bad);
  }
  __device__ __forceinline__ void run8(float& s, int j, float* v) const {
    if (b.fast) {
      unsigned bad = 0;
      float t = s;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        v[q] = t = b.soc_next<true>(t, want[j + q], of[j + q], bad);
      if (bad == 0u) {
        s = t;
        return;
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = s = step(s, j + q);
  }
};

__global__ void __launch_bounds__(kLanes)
battery_forward_kernel(const float* __restrict__ w,
                       const float* __restrict__ params, float tau, float dt,
                       float* __restrict__ grid, float* __restrict__ soc_out,
                       float* __restrict__ tgt_out,
                       float* __restrict__ mode_out,
                       float* __restrict__ hold_out, int rows, long long n,
                       unsigned long long* __restrict__ scratch,
                       int* __restrict__ stats) {
  __shared__ float sx[kWords], stg[kWords], ssw[kWords], shd[kWords],
      swant[kWords], sof[kWords], ssc[kWords];
  const Place p = place(scratch, rows, n, false);
  const float* prm = params + kCols * (size_t)p.row;
  Bat b;
  b.init(prm, tau, dt);
  const size_t base = (size_t)p.row * n + p.i0;
  for (int idx = p.lane; idx < p.cnt; idx += kLanes)
    sx[at(idx)] = w[base + idx];
  __syncwarp();
  const int seg = p.lane * kStride;
  // the target
  float t0;
  chain_chunk(TgtChain{sx + seg, b.alpha}, stg + seg, prm[9], prm[9],
              scratch, p, 0, stats, 3, t0);
  // want and the mode (ssc holds the mode until the SoC's walk)
  for (int idx = p.lane; idx < p.cnt; idx += kLanes) {
    const float tg = stg[at(idx)];
    const float want = sx[at(idx)] - tg;
    const float nm = tanhf(want / b.Z);
    swant[at(idx)] = want;
    ssc[at(idx)] = nm;
    tgt_out[base + idx] = tg;
    mode_out[base + idx] = nm;
  }
  __syncwarp();
  // the mode before the chunk: from the sample before it, whose target is
  // the chunk's start t0
  const float mode0 = p.chunk == 0 ? 0.0f
                                   : tanhf((w[base - 1] - t0) / b.Z);
  for (int idx = p.lane; idx < p.cnt; idx += kLanes) {
    const float mp = idx > 0 ? ssc[at(idx - 1)] : mode0;
    ssw[at(idx)] = fminf(fmaxf(-(ssc[at(idx)] * mp), 0.0f), 1.0f);
  }
  __syncwarp();
  // the hold, then the open gate
  float h0;
  chain_chunk(HoldChain{ssw + seg, b.lat}, shd + seg, 0.0f, 0.0f, scratch,
              p, 1, stats, 3, h0);
  for (int idx = p.lane; idx < p.cnt; idx += kLanes) {
    const float hd = shd[at(idx)];
    hold_out[base + idx] = hd;
    sof[at(idx)] = sigm((0.5f - hd) / b.Y);
  }
  __syncwarp();
  // the SoC, then the grid from each sample's SoC before it
  float s0;
  chain_chunk(SocChain{swant + seg, sof + seg, b}, ssc + seg, prm[8],
              prm[8], scratch, p, 2, stats, 3, s0);
  for (int idx = p.lane; idx < p.cnt; idx += kLanes) {
    const float sp = idx > 0 ? ssc[at(idx - 1)] : s0;
    float dis, chg;
    b.flows<false>(sp, swant[at(idx)], sof[at(idx)], dis, chg);
    grid[base + idx] = sx[at(idx)] - dis + chg;
    soc_out[base + idx] = ssc[at(idx)];
  }
}

// ---- the adjoint

// the SoC step's terms at one sample, from the carries before it
struct Step {
  float want, of, soc, ws, wsl, tlo, thi, d1, d2, e1, e2, h2, h4, w1, w2,
      w3, w4, a1, a2, b1, b2, dis, chg;
};

__device__ __forceinline__ Step soc_step(const Bat& b, float want, float of,
                                         float soc) {
  Step s;
  s.want = want; s.of = of; s.soc = soc;
  s.a1 = soc / b.w_lo;
  s.b1 = fmaxf(s.a1, 0.0f);
  s.tlo = fminf(s.b1, 1.0f);
  s.a2 = (b.cap - soc) / b.w_hi;
  s.b2 = fmaxf(s.a2, 0.0f);
  s.thi = fminf(s.b2, 1.0f);
  const float c1 = fmaxf(want, 0.0f);
  const float h1 = b.max_dis * s.tlo;
  s.d1 = fminf(c1, h1);
  s.h2 = soc * b.eff / b.dt;
  s.d2 = fminf(s.d1, s.h2);
  const float c2 = fmaxf(-want, 0.0f);
  const float h3 = b.max_chg * s.thi;
  s.e1 = fminf(c2, h3);
  s.h4 = (b.cap - soc) / b.eff / b.dt;
  s.e2 = fminf(s.e1, s.h4);
  s.dis = of * s.d2;
  s.chg = of * s.e2;
  const float s1 = soc - s.dis * b.dt / b.eff + s.chg * b.dt * b.eff;
  const float s2 = fmaxf(s1, 0.0f);
  s.ws = wmin(s2, b.cap);
  s.wsl = wmax(s1, 0.0f);
  s.w1 = wmin(c1, h1);
  s.w2 = wmin(s.d1, s.h2);
  s.w3 = wmin(c2, h3);
  s.w4 = wmin(s.e1, s.h4);
  return s;
}

// the SoC step's adjoint: takes dL/dsoc' (asoc) and dL/dgrid (gg);
// returns dL/dsoc and the rest through the references
struct SocGrad {
  float dsoc, dcap, deff, dw_lo, dw_hi, dmax_dis, dmax_chg, dwant, dof;
};

__device__ __forceinline__ SocGrad soc_adjoint(const Bat& b, const Step& s,
                                               float asoc, float gg) {
  SocGrad o;
  // soc' = min(max(s1, 0), cap)
  const float ds1 = asoc * s.ws * s.wsl;
  o.dcap = asoc * (1.0f - s.ws);
  o.dsoc = ds1;
  float ddis = -ds1 * b.dt / b.eff;
  float dchg = ds1 * b.dt * b.eff;
  o.deff = ds1 * (s.dis * b.dt / (b.eff * b.eff) + s.chg * b.dt);
  // grid = x - dis + chg
  ddis -= gg;
  dchg += gg;
  o.dof = ddis * s.d2 + dchg * s.e2;
  const float dd2 = ddis * s.of, de2 = dchg * s.of;
  // e2 = min(e1, h4), h4 = (cap - soc) / eff / dt
  const float de1 = de2 * s.w4, dh4 = de2 * (1.0f - s.w4);
  o.dcap += dh4 / b.eff / b.dt;
  o.dsoc -= dh4 / b.eff / b.dt;
  o.deff -= dh4 * s.h4 / b.eff;
  // e1 = min(c2, h3), h3 = max_chg thi, c2 = max(-want, 0)
  const float dc2 = de1 * s.w3, dh3 = de1 * (1.0f - s.w3);
  o.dmax_chg = dh3 * s.thi;
  const float dthi = dh3 * b.max_chg;
  o.dwant = -dc2 * wmax(-s.want, 0.0f);
  // d2 = min(d1, h2), h2 = soc eff / dt
  const float dd1 = dd2 * s.w2, dh2 = dd2 * (1.0f - s.w2);
  o.dsoc += dh2 * b.eff / b.dt;
  o.deff += dh2 * s.soc / b.dt;
  // d1 = min(c1, h1), h1 = max_dis tlo, c1 = max(want, 0)
  const float dc1 = dd1 * s.w1, dh1 = dd1 * (1.0f - s.w1);
  o.dmax_dis = dh1 * s.tlo;
  const float dtlo = dh1 * b.max_dis;
  o.dwant += dc1 * wmax(s.want, 0.0f);
  // the tapers
  const float da2 = dthi * wmin(s.b2, 1.0f) * wmax(s.a2, 0.0f);
  o.dcap += da2 / b.w_hi;
  o.dsoc -= da2 / b.w_hi;
  o.dw_hi = -da2 * s.a2 / b.w_hi;
  const float da1 = dtlo * wmin(s.b1, 1.0f) * wmax(s.a1, 0.0f);
  o.dsoc += da1 / b.w_lo;
  o.dw_lo = -da1 * s.a1 / b.w_lo;
  return o;
}

// one sample's forward step recomputed from the carries before it
struct KStep {
  float tgt, want, z, nm, q, r, sw, hm1, hm, of;
  Step st;
};

__device__ __forceinline__ KStep k_step(const Bat& b, float xv, float soc_p,
                                        float tgt_p, float mode_p,
                                        float hold_p) {
  KStep k;
  k.tgt = tgt_p + b.alpha * (xv - tgt_p);
  k.want = xv - k.tgt;
  k.z = k.want / b.Z;
  k.nm = tanhf(k.z);
  k.q = -(k.nm * mode_p);
  k.r = fmaxf(k.q, 0.0f);
  k.sw = fminf(k.r, 1.0f);
  k.hm1 = hold_p - 1.0f;
  k.hm = fmaxf(k.hm1, 0.0f);
  const float hold = k.sw * b.lat + (1.0f - k.sw) * k.hm;
  k.of = sigm((0.5f - hold) / b.Y);
  k.st = soc_step(b, k.want, k.of, soc_p);
  return k;
}

__global__ void __launch_bounds__(kLanes)
battery_adjoint_kernel(const float* __restrict__ w,
                       const float* __restrict__ params, float tau, float dt,
                       const float* __restrict__ soc_in,
                       const float* __restrict__ tgt_in,
                       const float* __restrict__ mode_in,
                       const float* __restrict__ hold_in,
                       const float* __restrict__ g_grid,
                       const float* __restrict__ g_soc,
                       float* __restrict__ g_w, float* __restrict__ g_params,
                       int rows, long long n,
                       unsigned long long* __restrict__ scratch) {
  __shared__ float sx[kWords], sgg[kWords], sgs[kWords], ssoc[kWords],
      stgt[kWords], smode[kWords], shold[kWords], sq[kWords], sdw[kWords];
  const Place p = place(scratch, rows, n, true);
  const float* prm = params + kCols * (size_t)p.row;
  Bat b;
  b.init(prm, tau, dt);
  const size_t base = (size_t)p.row * n + p.i0;
  for (int idx = p.lane; idx < p.cnt; idx += kLanes) {
    sx[at(idx)] = w[base + idx];
    sgg[at(idx)] = g_grid[base + idx];
    sgs[at(idx)] = g_soc != nullptr ? g_soc[base + idx] : 0.0f;
    ssoc[at(idx)] = soc_in[base + idx];
    stgt[at(idx)] = tgt_in[base + idx];
    smode[at(idx)] = mode_in[base + idx];
    shold[at(idx)] = hold_in[base + idx];
  }
  // the carries before the chunk
  const bool first = p.chunk == 0;
  const float soc_b = first ? prm[8] : soc_in[base - 1];
  const float tgt_b = first ? prm[9] : tgt_in[base - 1];
  const float mode_b = first ? 0.0f : mode_in[base - 1];
  const float hold_b = first ? 0.0f : hold_in[base - 1];
  __syncwarp();
  const int seg = p.lane * kStride;
  const int len = p.len;
  auto step_at = [&](int j) {
    const int idx = p.lane * kSeg + j;
    const bool f0 = idx == 0;
    return k_step(b, sx[seg + j], f0 ? soc_b : ssoc[at(idx - 1)],
                  f0 ? tgt_b : stgt[at(idx - 1)],
                  f0 ? mode_b : smode[at(idx - 1)],
                  f0 ? hold_b : shold[at(idx - 1)]);
  };
  double g[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) g[c] = 0.0;
  // 1. the SoC: c_{i-1} = A_i (c_i + gs_i) + B_i
  Map m = {1.0, 0.0};
  for (int j = len - 1; j >= 0; --j) {
    const KStep k = step_at(j);
    const double A = soc_adjoint(b, k.st, 1.0f, 0.0f).dsoc;
    const double B = soc_adjoint(b, k.st, 0.0f, sgg[seg + j]).dsoc;
    m = after(Map{A, A * (double)sgs[seg + j] + B}, m);
  }
  double asoc_out;
  double c = carry_in(m, scratch, p, 0, asoc_out);
  for (int j = len - 1; j >= 0; --j) {
    const KStep k = step_at(j);
    const float gg = sgg[seg + j];
    const double tot = c + (double)sgs[seg + j];
    c = (double)soc_adjoint(b, k.st, 1.0f, 0.0f).dsoc * tot +
        (double)soc_adjoint(b, k.st, 0.0f, gg).dsoc;
    const SocGrad sg = soc_adjoint(b, k.st, (float)tot, gg);
    g[2] += (double)sg.dcap;
    g[3] += (double)sg.dw_lo;
    g[4] += (double)sg.dw_hi;
    g[5] += (double)sg.dmax_dis;
    g[6] += (double)sg.dmax_chg;
    g[7] += (double)sg.deff;
    // open = sigmoid((0.5 - hold) / Y)
    const float dy = sg.dof * k.of * (1.0f - k.of);
    sq[seg + j] = dy / b.Y;
    sdw[seg + j] = sg.dwant;
  }
  // 2. the hold: c_{i-1} = (1 - sw_i) m_i (c_i - q_i)
  m = {1.0, 0.0};
  for (int j = len - 1; j >= 0; --j) {
    const KStep k = step_at(j);
    const double kh = (double)(1.0f - k.sw) * (double)wmax(k.hm1, 0.0f);
    m = after(Map{kh, -kh * (double)sq[seg + j]}, m);
  }
  double ahold_out;
  c = carry_in(m, scratch, p, 1, ahold_out);
  for (int j = len - 1; j >= 0; --j) {
    const KStep k = step_at(j);
    const double dh = c - (double)sq[seg + j];
    c = (double)(1.0f - k.sw) * (double)wmax(k.hm1, 0.0f) * dh;
    const float dhold = (float)dh;
    // hold = sw lat + (1 - sw) max(hold_prev - 1, 0); sw = clip(q, 0, 1)
    const float dsw = dhold * (b.lat - k.hm);
    sq[seg + j] = dsw * wmin(k.r, 1.0f) * wmax(k.q, 0.0f);
  }
  __syncwarp();
  // the mode's adjoint after each sample, -dq_{i+1} mode_{i+1}: the first
  // sample's goes to the previous chunk, the next chunk's comes in
  post_box(scratch, p, 3, (double)(-sq[0] * smode[0]), 0, p.chunk > 0);
  const float amode_next = p.chunk + 1 < p.C
                               ? (float)fetch_box(scratch, p, p.chunk + 1, 3)
                               : 0.0f;
  for (int j = len - 1; j >= 0; --j) {
    const int idx = p.lane * kSeg + j;
    const KStep k = step_at(j);
    const float am = idx == p.cnt - 1
                         ? amode_next
                         : -sq[at(idx + 1)] * smode[at(idx + 1)];
    const float mode_p = idx == 0 ? mode_b : smode[at(idx - 1)];
    const float dnm = am - sq[seg + j] * mode_p;
    // mode' = tanh(want / Z)
    const float dz = dnm * (1.0f - k.nm * k.nm);
    g[10] += (double)(-dz * k.z / b.Z * b.tau);        // Z = tau p_scale
    sdw[seg + j] = sdw[seg + j] + dz / b.Z;
  }
  // 3. the target: c_{i-1} = (1 - alpha) (c_i - dwant_i)
  const double ka = 1.0 - (double)b.alpha;
  m = {1.0, 0.0};
  for (int j = len - 1; j >= 0; --j)
    m = after(Map{ka, -ka * (double)sdw[seg + j]}, m);
  double atgt_out;
  c = carry_in(m, scratch, p, 2, atgt_out);
  for (int j = len - 1; j >= 0; --j) {
    const int idx = p.lane * kSeg + j;
    const float dwant = sdw[seg + j];
    const double dt64 = c - (double)dwant;
    c = ka * dt64;
    const float dtgt = (float)dt64;
    const float xv = sx[seg + j];
    const float tgt_p = idx == 0 ? tgt_b : stgt[at(idx - 1)];
    float dx = sgg[seg + j];
    dx += dwant;
    dx += dtgt * b.alpha;
    sgs[seg + j] = dx;
    g[0] += (double)(dtgt * (xv - tgt_p));
  }
  __syncwarp();
  for (int idx = p.lane; idx < p.cnt; idx += kLanes)
    g_w[base + idx] = sgs[at(idx)];
  double extra[kCols] = {0.0};
  extra[8] = asoc_out;
  extra[9] = atgt_out;
  reduce_params(g, kCols, scratch, p, 4, extra,
                g_params + kCols * (size_t)p.row);
}

// the chains' own steps over the row's first kProbe samples in shared
// memory, reps times, the warp walking in step as resolve does.  adj 0:
// cycles[0] the SoC walk, [1] the hold walk and [2] the target walk, each
// with the merge test against kept outputs it never meets (a row's serial
// path where walks do not merge), on the row's own inputs (its want and
// open gate, as the kernel's, so the SoC divides as it does there); adj
// 1: cycles[0] the adjoint's float64 affine composition a sample
constexpr int kProbe = 512;

__global__ void battery_relaxed_cycles_kernel(
    const float* __restrict__ w, const float* __restrict__ params,
    float tau, float dt, long long n, int reps, int adj,
    long long* __restrict__ cycles, float* __restrict__ sink) {
  __shared__ float px[kProbe], pw[kProbe], ps[kProbe], po[kProbe],
      pkept[kProbe];
  const int lane = threadIdx.x;
  const int len = (int)min(n, (long long)kProbe) / kSeg * kSeg;
  Bat b;
  b.init(params, tau, dt);
  for (int i = lane; i < len; i += kLanes) px[i] = w[i];
  __syncwarp();
  if (lane == 0) {             // the row's off-chain inputs, as the kernel's
    float tgt = params[9], mode = 0.0f, hold = 0.0f;
    for (int i = 0; i < len; ++i) {
      tgt = tgt + b.alpha * (px[i] - tgt);
      const float want = px[i] - tgt;
      const float nm = tanhf(want / b.Z);
      const float sw = fminf(fmaxf(-(nm * mode), 0.0f), 1.0f);
      hold = sw * b.lat + (1.0f - sw) * fmaxf(hold - 1.0f, 0.0f);
      pw[i] = want;
      ps[i] = sw;
      po[i] = sigm((0.5f - hold) / b.Y);
      mode = nm;
    }
  }
  __syncwarp();
  float acc = 0.0f;
  double dacc = 0.0;
  for (int which = 0; which < (adj ? 1 : 3); ++which) {
    long long spent = 0;
    for (int r = 0; r < reps; ++r) {
      for (int i = lane; i < kProbe; i += kLanes)
        pkept[i] = __int_as_float(0x7fc00001);
      __syncwarp();
      // every lane walks the same segments in step, as resolve does
      const long long t0 = clock64();
      if (adj) {
        Map m = {1.0, 0.0};
        for (int j = len - 1; j >= 0; --j) {
          const double k = (double)po[j];
          m = after(Map{k, k * (double)pw[j]}, m);
        }
        dacc += m.a + m.b;
      } else {
        // from the row's start each time: a carry left over would drift
        float s = which == 0 ? params[8] : (which == 1 ? 0.0f : params[9]);
        for (int j0 = 0; j0 < len; j0 += kSeg) {
          if (which == 0)
            walk<true>(SocChain{pw + j0, po + j0, b}, s, pkept + j0, kSeg);
          else if (which == 1)
            walk<true>(HoldChain{ps + j0, b.lat}, s, pkept + j0, kSeg);
          else
            walk<true>(TgtChain{px + j0, b.alpha}, s, pkept + j0, kSeg);
        }
        acc += s;
      }
      __syncwarp();
      spent += clock64() - t0;
    }
    if (lane == 0) cycles[which] = spent;
    __syncwarp();
  }
  if (lane == 0) sink[0] = acc + (float)dacc;
}

}  // namespace

// grid, soc, tgt, mode, hold [rows, n] of w [rows, n], params [rows, 11];
// scratch holds chain_walk.cuh's scratch_words(rows, n) 8-byte words
// (zeroed here); stats, if not null, gets [rows, chunks, 3 chains, 3]
// ints (each chunk's segments walked again once its start came in, those
// that did not merge, and their steps: chain 0 the target, 1 the hold, 2
// the SoC)
extern "C" int battery_relaxed_forward(const void* w, const void* params,
                                       float tau, float dt, void* grid,
                                       void* soc, void* tgt, void* mode,
                                       void* hold, int rows, long long n,
                                       void* scratch, void* stats,
                                       void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(scratch, 0,
                                  8 * chain::scratch_words(rows, n), s);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)(rows * chain::chunks(n));
  battery_forward_kernel<<<blocks, chain::kLanes, 0, s>>>(
      (const float*)w, (const float*)params, tau, dt, (float*)grid,
      (float*)soc, (float*)tgt, (float*)mode, (float*)hold, rows, n,
      (unsigned long long*)scratch, (int*)stats);
  return (int)cudaGetLastError();
}

// g_w [rows, n] and g_params [rows, 11] of the loss whose gradients with
// respect to the forward's grid and soc are g_grid and g_soc [rows, n]
// (g_soc may be null: no gradient reaches the SoC trace); scratch as the
// forward's
extern "C" int battery_relaxed_adjoint(const void* w, const void* params,
                                       float tau, float dt, const void* soc,
                                       const void* tgt, const void* mode,
                                       const void* hold, const void* g_grid,
                                       const void* g_soc, void* g_w,
                                       void* g_params, int rows, long long n,
                                       void* scratch, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(scratch, 0,
                                  8 * chain::scratch_words(rows, n), s);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)(rows * chain::chunks(n));
  battery_adjoint_kernel<<<blocks, chain::kLanes, 0, s>>>(
      (const float*)w, (const float*)params, tau, dt, (const float*)soc,
      (const float*)tgt, (const float*)mode, (const float*)hold,
      (const float*)g_grid, (const float*)g_soc, (float*)g_w,
      (float*)g_params, rows, n, (unsigned long long*)scratch);
  return (int)cudaGetLastError();
}

// cycles[0..2]: SM cycles of reps walks of the chains over min(n, 512)
// samples (rounded down to whole segments): adj 0 the SoC, hold and
// target walks with the merge test; adj 1 the adjoint's f64 composition
extern "C" int battery_relaxed_step_cycles(const void* w, const void* params,
                                           float tau, float dt, long long n,
                                           int reps, int adj, void* cycles,
                                           void* sink, void* stream) {
  if (n < chain::kSeg || reps <= 0) return (int)cudaErrorInvalidValue;
  battery_relaxed_cycles_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)params, tau, dt, n, reps, adj,
      (long long*)cycles, (float*)sink);
  return (int)cudaGetLastError();
}
