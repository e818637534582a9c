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
// (target, mode, hold) after each step.  The adjoint walks the row
// backwards, recomputes each step from the carries before it with the
// forward's own expressions, and carries the adjoints of the carries, plus
// the caller's gradient with respect to the SoC trace where it passes one.
// It writes the gradient with respect to every sample and, summed in f64
// over the row, with respect to each parameter (lat_n's stays 0: the
// reference holds it with stop_gradient).  A max or min whose two sides are
// equal sends half of the gradient to each side, as JAX's lax.max and
// lax.min do; ties are real here (the SoC is clipped right after the
// discharge limit has drained it, and the tapers sit at 0 and 1).
//
// Bound on this card: the serial chains.  Three recurrences are serial in
// the forward: the target (two operations a step), the hold (four) and the
// SoC (about twenty, five divisions among them); the mode's tanh, the
// open gate's sigmoid and the power limits' inputs depend on the chains'
// values but feed nothing back.  So one warp takes one row, in tiles of 32
// samples: the lanes load a tile (coalesced) and compute every off-chain
// term in parallel, lane 0 runs each recurrence over the tile out of shared
// memory, and the lanes store the tile.  In the adjoint every carry's
// adjoint is linear in the carry after it: the SoC's is A_i a_i + B_i with
// A_i and B_i computed per sample by the lanes (the SoC step's adjoint
// evaluated at (a, g) = (1, 0) and (0, g_i)), the hold's and the target's
// are three-operation chains, and the mode's needs no chain (it
// is -dq_{i+1} mode_{i+1}).  So lane 0 runs three short chains, the lanes
// do the rest, and the parameters' sums are kept per lane in f64 and
// reduced across the warp at the end.  battery_relaxed_step_cycles times
// the lane-0 loops alone over a tile resident in shared memory.
//
// Built with -fmad=false, so that the operations are those written here.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;     // samples a tile: one a lane
constexpr int kCols = 11;

struct Bat {
  float alpha, lat, cap, w_lo, w_hi, max_dis, max_chg, eff, Z, Y, dt, tau;

  __device__ void init(const float* p, float tau_, float dt_) {
    alpha = p[0]; lat = p[1]; cap = p[2]; w_lo = p[3]; w_hi = p[4];
    max_dis = p[5]; max_chg = p[6]; eff = p[7];
    Z = tau_ * p[10]; Y = tau_ * (lat + 1.0f); dt = dt_; tau = tau_;
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

// ---- the forward's serial chains, lane 0 over a tile of cnt samples

// sx[k] = x_k in, tgt_k out
__device__ __forceinline__ void tgt_chain(const Bat& b, float* sx, int cnt,
                                          float& tgt) {
  for (int k = 0; k < cnt; ++k) {
    tgt = tgt + b.alpha * (sx[k] - tgt);
    sx[k] = tgt;
  }
}

// ss[k] = sw_k in, hold_k out
__device__ __forceinline__ void hold_chain(const Bat& b, float* ss, int cnt,
                                           float& hold) {
  for (int k = 0; k < cnt; ++k) {
    const float sw = ss[k];
    hold = sw * b.lat + (1.0f - sw) * fmaxf(hold - 1.0f, 0.0f);
    ss[k] = hold;
  }
}

// sw_[k] = want_k, so[k] = open_k, sx[k] = x_k in; sw_[k] = grid_k and
// so[k] = soc_k out
__device__ __forceinline__ void soc_chain(const Bat& b, float* sw_, float* so,
                                          const float* sx, int cnt,
                                          float& soc) {
  for (int k = 0; k < cnt; ++k) {
    const float want = sw_[k], of = so[k];
    const float tlo = fminf(fmaxf(soc / b.w_lo, 0.0f), 1.0f);
    const float thi = fminf(fmaxf((b.cap - soc) / b.w_hi, 0.0f), 1.0f);
    float dis = fminf(fmaxf(want, 0.0f), b.max_dis * tlo);
    dis = fminf(dis, soc * b.eff / b.dt);
    float chg = fminf(fmaxf(-want, 0.0f), b.max_chg * thi);
    chg = fminf(chg, (b.cap - soc) / b.eff / b.dt);
    dis = of * dis;
    chg = of * chg;
    sw_[k] = sx[k] - dis + chg;
    const float s1 = soc - dis * b.dt / b.eff + chg * b.dt * b.eff;
    soc = fminf(fmaxf(s1, 0.0f), b.cap);
    so[k] = soc;
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

// reverse chains, lane 0 over a tile.  SoC: sa[k] = dL/dsoc_k from the
// output in, in total out; a_{k-1} = sA[k] a_k + sB[k]
__device__ __forceinline__ void asoc_chain(float* sa, const float* sA,
                                           const float* sB, int cnt,
                                           float& asoc) {
  for (int k = cnt - 1; k >= 0; --k) {
    asoc += sa[k];
    sa[k] = asoc;
    asoc = sA[k] * asoc + sB[k];
  }
}

// hold: sq[k] = dy_k / Y in, dL/dhold_k out; sk[k] = (1 - sw_k),
// sm[k] = d max(hold_{k-1} - 1, 0)
__device__ __forceinline__ void ahold_chain(float* sq, const float* sk,
                                            const float* sm, int cnt,
                                            float& ahold) {
  for (int k = cnt - 1; k >= 0; --k) {
    const float dhold = ahold - sq[k];
    sq[k] = dhold;
    ahold = dhold * sk[k] * sm[k];
  }
}

// target: sw[k] = dwant_k in, dL/dtgt_k out.  The carry is dtgt - alpha
// dtgt, as the step tgt + alpha (x - tgt) differentiates, and not dtgt
// (1 - alpha): 1 - alpha rounded to f32 moves a small alpha (3.3e-5 at
// dt 1 ms) by up to 1e-3 of itself, and the carry sums about 1 / alpha
// steps, so the target's and alpha's gradients would move by as much.
__device__ __forceinline__ void atgt_chain(const Bat& b, float* sw, int cnt,
                                           float& atgt) {
  for (int k = cnt - 1; k >= 0; --k) {
    const float dtgt = atgt - sw[k];
    sw[k] = dtgt;
    atgt = dtgt - b.alpha * dtgt;
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kTile)
battery_forward_kernel(const float* __restrict__ w,
                       const float* __restrict__ params,
                       float tau, float dt, float* __restrict__ grid,
                       float* __restrict__ soc_out, float* __restrict__ tgt_out,
                       float* __restrict__ mode_out,
                       float* __restrict__ hold_out,
                       long long n) {
  __shared__ float sx[kTile], st[kTile], sn[kTile], sh[kTile], sw_[kTile],
      so[kTile];
  const int lane = threadIdx.x;
  const float* p = params + kCols * (size_t)blockIdx.x;
  Bat b;
  b.init(p, tau, dt);
  const size_t base = (size_t)blockIdx.x * n;
  float tgt = p[9], hold = 0.0f, soc = p[8];   // lane 0's carries
  float mode = 0.0f;                           // the tile's mode_{i0-1}
  for (long long i0 = 0; i0 < n; i0 += kTile) {
    const int cnt = n - i0 < kTile ? (int)(n - i0) : kTile;
    const long long i = i0 + lane;
    const bool live = lane < cnt;
    const float xv = live ? w[base + i] : 0.0f;
    sx[lane] = xv;
    st[lane] = xv;
    __syncwarp();
    if (lane == 0) tgt_chain(b, st, cnt, tgt);
    __syncwarp();
    const float tg = st[lane];
    const float want = xv - tg;
    const float nm = tanhf(want / b.Z);
    sn[lane] = nm;
    __syncwarp();
    const float mode_p = lane == 0 ? mode : sn[lane - 1];
    sh[lane] = fminf(fmaxf(-(nm * mode_p), 0.0f), 1.0f);
    __syncwarp();
    if (lane == 0) hold_chain(b, sh, cnt, hold);
    __syncwarp();
    const float hd = sh[lane];
    sw_[lane] = want;
    so[lane] = sigm((0.5f - hd) / b.Y);
    __syncwarp();
    if (lane == 0) soc_chain(b, sw_, so, sx, cnt, soc);
    __syncwarp();
    if (live) {
      grid[base + i] = sw_[lane];
      soc_out[base + i] = so[lane];
      tgt_out[base + i] = tg;
      mode_out[base + i] = nm;
      hold_out[base + i] = hd;
    }
    mode = sn[cnt - 1];
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kTile)
battery_adjoint_kernel(const float* __restrict__ w,
                       const float* __restrict__ params,
                       float tau, float dt, const float* __restrict__ soc_in,
                       const float* __restrict__ tgt_in,
                       const float* __restrict__ mode_in,
                       const float* __restrict__ hold_in,
                       const float* __restrict__ g_grid,
                       const float* __restrict__ g_soc, float* __restrict__ g_w,
                       float* __restrict__ g_params, long long n) {
  __shared__ float s0[kTile], s1[kTile], s2[kTile], s3[kTile], s4[kTile];
  const int lane = threadIdx.x;
  const float* p = params + kCols * (size_t)blockIdx.x;
  Bat b;
  b.init(p, tau, dt);
  const size_t base = (size_t)blockIdx.x * n;
  double g[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) g[c] = 0.0;
  float asoc = 0.0f, ahold = 0.0f, atgt = 0.0f;   // lane 0's carries
  float amode = 0.0f;      // dL/dmode at the tile's last sample
  for (long long i0 = ((n - 1) / kTile) * kTile; i0 >= 0; i0 -= kTile) {
    const int cnt = n - i0 < kTile ? (int)(n - i0) : kTile;
    const long long i = i0 + lane;
    const bool live = lane < cnt;
    const bool first = i == 0 || !live;
    const float xv = live ? w[base + i] : 0.0f;
    const float gg = live ? g_grid[base + i] : 0.0f;
    const float gs = live && g_soc != nullptr ? g_soc[base + i] : 0.0f;
    const float soc_p = first ? p[8] : soc_in[base + i - 1];
    const float tgt_p = first ? p[9] : tgt_in[base + i - 1];
    const float mode_p = first ? 0.0f : mode_in[base + i - 1];
    const float hold_p = first ? 0.0f : hold_in[base + i - 1];
    // recompute the step
    const float tgt = tgt_p + b.alpha * (xv - tgt_p);
    const float want = xv - tgt;
    const float z = want / b.Z;
    const float nm = tanhf(z);
    const float q = -(nm * mode_p);
    const float r = fmaxf(q, 0.0f);
    const float sw = fminf(r, 1.0f);
    const float hm1 = hold_p - 1.0f;
    const float hm = fmaxf(hm1, 0.0f);
    const float hold = sw * b.lat + (1.0f - sw) * hm;
    const float of = sigm((0.5f - hold) / b.Y);
    const Step st = soc_step(b, want, of, soc_p);
    // the SoC chain: its adjoint is linear in the carry after each step
    s0[lane] = gs;
    s1[lane] = soc_adjoint(b, st, 1.0f, 0.0f).dsoc;
    s2[lane] = soc_adjoint(b, st, 0.0f, gg).dsoc;
    __syncwarp();
    if (lane == 0) asoc_chain(s0, s1, s2, cnt, asoc);
    __syncwarp();
    const SocGrad sg = soc_adjoint(b, st, s0[lane], gg);
    // open = sigmoid((0.5 - hold) / Y): the hold chain
    const float dy = sg.dof * of * (1.0f - of);
    __syncwarp();
    s1[lane] = dy / b.Y;
    s2[lane] = 1.0f - sw;
    s3[lane] = wmax(hm1, 0.0f);
    __syncwarp();
    if (lane == 0) ahold_chain(s1, s2, s3, cnt, ahold);
    __syncwarp();
    const float dhold = s1[lane];
    // hold = sw lat + (1 - sw) max(hold_prev - 1, 0); sw = clip(q, 0, 1)
    const float dsw = dhold * (b.lat - hm);
    const float dq = dsw * wmin(r, 1.0f) * wmax(q, 0.0f);
    // the mode's adjoint after this step: -dq_{i+1} mode_{i+1}
    s3[lane] = dq;
    s4[lane] = nm;
    __syncwarp();
    const float am = lane == cnt - 1
                         ? amode
                         : (lane < cnt ? -s3[lane + 1] * s4[lane + 1] : 0.0f);
    const float dnm = am - dq * mode_p;
    // mode' = tanh(want / Z)
    const float dz = dnm * (1.0f - nm * nm);
    const float dwant = sg.dwant + dz / b.Z;
    // Z = tau p_scale
    const float dps = -dz * z / b.Z * b.tau;
    // want = x - tgt; tgt = tgt_prev + alpha (x - tgt_prev): the target chain
    s2[lane] = dwant;
    __syncwarp();
    if (lane == 0) atgt_chain(b, s2, cnt, atgt);
    __syncwarp();
    const float dtgt = s2[lane];
    float dx = gg;
    dx += dwant;
    dx += dtgt * b.alpha;
    if (live) {
      g_w[base + i] = dx;
      g[0] += (double)(dtgt * (xv - tgt_p));
      g[2] += (double)sg.dcap;
      g[3] += (double)sg.dw_lo;
      g[4] += (double)sg.dw_hi;
      g[5] += (double)sg.dmax_dis;
      g[6] += (double)sg.dmax_chg;
      g[7] += (double)sg.deff;
      g[10] += (double)dps;
    }
    amode = -s3[0] * s4[0];
    __syncwarp();
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) g[c] = warp_sum(g[c]);
  if (lane == 0) {
    g[8] += (double)asoc;
    g[9] += (double)atgt;
    float* gp = g_params + kCols * (size_t)blockIdx.x;
#pragma unroll
    for (int c = 0; c < kCols; ++c) gp[c] = (float)g[c];
  }
}

// the chains alone: lane 0 runs the forward's (target, hold, SoC) or the
// adjoint's (SoC, hold, target) lane-0 loops over the row's first kProbe
// samples in shared memory, reps times, each time from the row's start on
// fresh copies of the same inputs (restored by all lanes).  The forward's inputs are the row's
// own (its samples, and the switch and open-gate values that its target
// and mode give), so the SoC chain takes the divisions it takes there.
constexpr int kProbe = 512;

__global__ void battery_relaxed_cycles_kernel(
    const float* __restrict__ w, const float* __restrict__ params,
    float tau, float dt, long long n, int reps, int adj,
    long long* __restrict__ cycles, float* __restrict__ sink) {
  __shared__ float px[kProbe], pw[kProbe], ps[kProbe], po[kProbe];
  __shared__ float w0[kProbe], w1[kProbe], w2[kProbe], w3[kProbe];
  const int lane = threadIdx.x;
  const int len = n < kProbe ? (int)n : kProbe;
  Bat b;
  b.init(params, tau, dt);
  for (int i = lane; i < len; i += kTile) px[i] = w[i];
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
  float tgt = 0.0f, hold = 0.0f, soc = 0.0f, asoc = 0.0f, ahold = 0.0f,
        atgt = 0.0f;
  long long spent = 0;
  for (int rep = 0; rep < reps; ++rep) {
    // each repetition replays the same samples from the row's start: a
    // carry left over would drift (an emptying SoC decays geometrically
    // into subnormals, and their divisions take the slow path)
    tgt = params[9], hold = 0.0f, soc = params[8];
    asoc = ahold = atgt = 0.0f;
    __syncwarp();
    for (int i = lane; i < len; i += kTile) {
      w0[i] = adj ? 1e-3f * ps[i] : px[i];
      w1[i] = adj ? 1e-3f * ps[i] : ps[i];
      w2[i] = adj ? 0.9f * ps[i] : pw[i];
      w3[i] = adj ? 0.1f * ps[i] : po[i];
    }
    __syncwarp();
    if (lane == 0) {
      const long long t0 = clock64();
      for (int k0 = 0; k0 < len; k0 += kTile) {
        const int cnt = len - k0 < kTile ? len - k0 : kTile;
        if (adj) {
          asoc_chain(w0 + k0, w2 + k0, w3 + k0, cnt, asoc);
          ahold_chain(w1 + k0, ps + k0, ps + k0, cnt, ahold);
          atgt_chain(b, w2 + k0, cnt, atgt);
        } else {
          tgt_chain(b, w0 + k0, cnt, tgt);
          hold_chain(b, w1 + k0, cnt, hold);
          soc_chain(b, w2 + k0, w3 + k0, px + k0, cnt, soc);
        }
      }
      spent += clock64() - t0;
    }
  }
  if (lane == 0) {
    cycles[0] = spent;
    sink[0] = tgt + hold + soc + asoc + ahold + atgt + w0[0] + w2[0];
  }
}

}  // namespace

// grid, soc, tgt, mode, hold [rows, n] of w [rows, n], params [rows, 11]
extern "C" int battery_relaxed_forward(const void* w, const void* params,
                                       float tau, float dt, void* grid,
                                       void* soc, void* tgt, void* mode,
                                       void* hold, int rows, long long n,
                                       void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  battery_forward_kernel<<<rows, kTile, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)params, tau, dt, (float*)grid,
      (float*)soc, (float*)tgt, (float*)mode, (float*)hold, n);
  return (int)cudaGetLastError();
}

// g_w [rows, n] and g_params [rows, 11] of the loss whose gradients with
// respect to the forward's grid and soc are g_grid and g_soc [rows, n]
// (g_soc may be null: no gradient reaches the SoC trace)
extern "C" int battery_relaxed_adjoint(const void* w, const void* params,
                                       float tau, float dt, const void* soc,
                                       const void* tgt, const void* mode,
                                       const void* hold, const void* g_grid,
                                       const void* g_soc, void* g_w,
                                       void* g_params, int rows, long long n,
                                       void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  battery_adjoint_kernel<<<rows, kTile, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)params, tau, dt, (const float*)soc,
      (const float*)tgt, (const float*)mode, (const float*)hold,
      (const float*)g_grid, (const float*)g_soc, (float*)g_w,
      (float*)g_params, n);
  return (int)cudaGetLastError();
}

// cycles[0] = SM cycles of reps * min(n, 512) steps of the forward's
// (adj 0) or the adjoint's (adj 1) serial chains; a probe of the chains
// alone
extern "C" int battery_relaxed_step_cycles(const void* w, const void* params,
                                           float tau, float dt, long long n,
                                           int reps, int adj, void* cycles,
                                           void* sink, void* stream) {
  if (n <= 0 || reps <= 0) return (int)cudaErrorInvalidValue;
  battery_relaxed_cycles_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)params, tau, dt, n, reps, adj,
      (long long*)cycles, (float*)sink);
  return (int)cudaGetLastError();
}
