// Relaxed GB200 device power smoothing (smooth_tau > 0), forward and
// adjoint: kernel J of the port.
//
// Replaces the reference's per-sample lax.scan of
// GpuPowerSmoothing._apply_smooth (src/repro/core/smoothing/gpu_floor.py:93)
// and the reverse scan that jax.grad derives from it.  No TPU kernel stands
// behind it: the reference leaves both scans to XLA.  The design's gradient
// descent (core/engine.py design_gradient) runs this pair once per Adam
// step on every start.
//
// Per sample i of a row, with params {mpf, thresh, ru, rd, stop_n, cap},
// T = tau tdp and S = tau (stop_n + 1):
//   a_i    = sigmoid((x_i - thresh) / T)
//   idle_i = (1 - a_i) (idle_{i-1} + 1)                     (idle_{-1} = 0)
//   f_i    = mpf sigmoid((stop_n - idle_i) / S)
//   t_i    = -T logaddexp(-(T logaddexp(x_i / T, f_i / T)) / T, -cap / T)
//   o_i    = min(max(t_i, o_{i-1} - rd), o_{i-1} + ru)        (o_{-1} = x_0)
//
// The forward writes o and the idle counter; the adjoint walks the row
// backwards, recomputes each step from (x_i, o_{i-1}, idle_{i-1}) with the
// forward's own expressions, and carries the adjoints of o and idle.  It
// writes the gradient with respect to every sample and, summed in f64 over
// the row, with respect to each of the six parameters.  A max or min whose
// two sides are equal sends half of the gradient to each side, as JAX's
// lax.max and lax.min do.
//
// Bound on this card: the serial chains.  Only two short recurrences are
// serial: idle (two operations a step) and o (three); a_i, the floor and
// the two soft maxima (two exp and two log1p, six divisions) depend on
// the chains' values but feed nothing back.  So one warp takes one row, in
// tiles of 32 samples: the lanes load a tile (coalesced) and compute each
// sample's off-chain terms in parallel, lane 0 runs the recurrence over the
// tile out of shared memory, and the lanes take its values back for the
// next parallel stage and store the tile.  The adjoint has the same shape:
// its two carries (dL/do and dL/didle) are short chains in lane 0, every
// other term is per sample in the lanes, and the parameters' sums are kept
// per lane in f64 and reduced across the warp at the end.  The chains'
// own time a step is measured by gpu_floor_relaxed_step_cycles, which runs
// the lane-0 loops alone over a tile resident in shared memory.
//
// Built with -fmad=false, so that the operations are those written here.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;     // samples a tile: one a lane

struct Floor {
  float mpf, thresh, ru, rd, stop_n, cap, T, S, tau;

  __device__ void init(const float* p, float tau_, float T_) {
    mpf = p[0]; thresh = p[1]; ru = p[2]; rd = p[3]; stop_n = p[4];
    cap = p[5]; tau = tau_; T = T_; S = tau_ * (stop_n + 1.0f);
  }
};

__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float logaddexp(float a, float b) {
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

// d max(a, b) / d a: 1, 1/2 on a tie, else 0
__device__ __forceinline__ float wmax(float a, float b) {
  return a > b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

__device__ __forceinline__ float wmin(float a, float b) {
  return a < b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

// the target t_i of a sample from its x and idle_i (off the chains)
__device__ __forceinline__ float target(const Floor& f, float x, float idle) {
  const float fl = f.mpf * sigm((f.stop_n - idle) / f.S);
  const float t1 = f.T * logaddexp(x / f.T, fl / f.T);
  return -(f.T * logaddexp(-t1 / f.T, -f.cap / f.T));
}

// ---- the serial chains, lane 0 over a tile of cnt samples in shared memory

// s[k] = a_k in, idle_k out
__device__ __forceinline__ void idle_chain(float* s, int cnt, float& idle) {
  for (int k = 0; k < cnt; ++k) {
    idle = (1.0f - s[k]) * (idle + 1.0f);
    s[k] = idle;
  }
}

// s[k] = t_k in, o_k out
__device__ __forceinline__ void out_chain(const Floor& f, float* s, int cnt,
                                          float& o) {
  for (int k = 0; k < cnt; ++k) {
    o = fminf(fmaxf(s[k], o - f.rd), o + f.ru);
    s[k] = o;
  }
}

// reverse: sg[k] = dL/do_k from the output in, dL/do_k in total out;
// wm[k], wt[k] the clip's two tie weights.  go: dL/do after the tile in,
// before it out.
__device__ __forceinline__ void go_chain(float* sg, const float* wm,
                                         const float* wt, int cnt,
                                         float& go) {
  for (int k = cnt - 1; k >= 0; --k) {
    go += sg[k];
    sg[k] = go;
    const float dm = go * wm[k], dhi = go * (1.0f - wm[k]);
    const float dlo = dm * (1.0f - wt[k]);
    go = dlo + dhi;
  }
}

// reverse: sd[k] = dN_k in, dL/didle_k out; sa[k] = a_k
__device__ __forceinline__ void gi_chain(float* sd, const float* sa, int cnt,
                                         float& gi) {
  for (int k = cnt - 1; k >= 0; --k) {
    const float didle = gi - sd[k];
    sd[k] = didle;
    gi = didle * (1.0f - sa[k]);
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kTile)
floor_forward_kernel(const float* __restrict__ w,
                     const float* __restrict__ params,
                     float tau, float T, float* __restrict__ out,
                     float* __restrict__ idle_out, long long n) {
  __shared__ float s[kTile];
  const int lane = threadIdx.x;
  Floor f;
  f.init(params + 6 * (size_t)blockIdx.x, tau, T);
  const size_t base = (size_t)blockIdx.x * n;
  const float* x = w + base;
  float o = x[0], idle = 0.0f;         // lane 0's carries
  for (long long i0 = 0; i0 < n; i0 += kTile) {
    const int cnt = n - i0 < kTile ? (int)(n - i0) : kTile;
    const long long i = i0 + lane;
    const bool live = lane < cnt;
    const float xv = live ? x[i] : 0.0f;
    s[lane] = sigm((xv - f.thresh) / f.T);
    __syncwarp();
    if (lane == 0) idle_chain(s, cnt, idle);
    __syncwarp();
    const float id = s[lane];
    __syncwarp();
    s[lane] = target(f, xv, id);
    __syncwarp();
    if (lane == 0) out_chain(f, s, cnt, o);
    __syncwarp();
    if (live) {
      out[base + i] = s[lane];
      idle_out[base + i] = id;
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kTile)
floor_adjoint_kernel(const float* __restrict__ w,
                     const float* __restrict__ params,
                     float tau, float T, const float* __restrict__ out,
                     const float* __restrict__ idle_in,
                     const float* __restrict__ g_out, float* __restrict__ g_w,
                     float* __restrict__ g_params, long long n) {
  __shared__ float sg[kTile], swm[kTile], swt[kTile], sd[kTile], sa[kTile];
  const int lane = threadIdx.x;
  Floor f;
  f.init(params + 6 * (size_t)blockIdx.x, tau, T);
  const size_t base = (size_t)blockIdx.x * n;
  const float* x = w + base;
  double g0 = 0.0, g1 = 0.0, g2 = 0.0, g3 = 0.0, g4 = 0.0, g5 = 0.0;
  float go = 0.0f, gi = 0.0f;          // lane 0's carries
  for (long long i0 = ((n - 1) / kTile) * kTile; i0 >= 0; i0 -= kTile) {
    const int cnt = n - i0 < kTile ? (int)(n - i0) : kTile;
    const long long i = i0 + lane;
    const bool live = lane < cnt;
    const float xv = live ? x[i] : 0.0f;
    const float o_prev = i > 0 && live ? out[base + i - 1] : x[0];
    const float idle_prev = i > 0 && live ? idle_in[base + i - 1] : 0.0f;
    // recompute the step
    const float u = (xv - f.thresh) / f.T;
    const float a = sigm(u);
    const float ip1 = idle_prev + 1.0f;
    const float idle = (1.0f - a) * ip1;
    const float v = (f.stop_n - idle) / f.S;
    const float gs = sigm(v);
    const float fl = f.mpf * gs;
    const float x1 = xv / f.T, x2 = fl / f.T;
    const float t1 = f.T * logaddexp(x1, x2);
    const float y1 = -t1 / f.T, y2 = -f.cap / f.T;
    const float t2 = -(f.T * logaddexp(y1, y2));
    const float lo = o_prev - f.rd, hi = o_prev + f.ru;
    const float m = fmaxf(t2, lo);
    const float wm = wmin(m, hi), wt = wmax(t2, lo);
    // the o chain: dL/do_i for every sample of the tile
    sg[lane] = live ? g_out[base + i] : 0.0f;
    swm[lane] = wm;
    swt[lane] = wt;
    __syncwarp();
    if (lane == 0) go_chain(sg, swm, swt, cnt, go);
    __syncwarp();
    const float got = sg[lane];
    // o = min(m, hi), m = max(t2, lo)
    const float dm = got * wm, dhi = got * (1.0f - wm);
    const float dt2 = dm * wt, dlo = dm * (1.0f - wt);
    // t2 = -T logaddexp(y1, y2): d/dy1 = 1 / (1 + exp(y2 - y1))
    const float dt1 = dt2 / (1.0f + expf(y2 - y1));
    const float dcap = dt2 / (1.0f + expf(y1 - y2));
    // t1 = T logaddexp(x1, x2)
    float dx = dt1 / (1.0f + expf(x2 - x1));
    const float dfl = dt1 / (1.0f + expf(x1 - x2));
    const float dg = dfl * f.mpf;
    const float dv = dg * gs * (1.0f - gs);
    const float dN = dv / f.S;
    // the idle chain: dL/didle_i for every sample of the tile
    sd[lane] = dN;
    sa[lane] = a;
    __syncwarp();
    if (lane == 0) gi_chain(sd, sa, cnt, gi);
    __syncwarp();
    const float didle = sd[lane];
    const float da = -didle * ip1;
    const float du = da * a * (1.0f - a);
    dx += du / f.T;
    if (live) {
      g_w[base + i] = dx;
      g0 += (double)(dfl * gs);
      g1 -= (double)(du / f.T);
      g2 += (double)dhi;
      g3 -= (double)dlo;
      g4 += (double)(dN - f.tau * dv * v / f.S);
      g5 += (double)dcap;
    }
    __syncwarp();
  }
  g0 = warp_sum(g0); g1 = warp_sum(g1); g2 = warp_sum(g2);
  g3 = warp_sum(g3); g4 = warp_sum(g4); g5 = warp_sum(g5);
  if (lane == 0) {
    g_w[base] += go;                   // o_{-1} = x_0
    float* gp = g_params + 6 * (size_t)blockIdx.x;
    gp[0] = (float)g0; gp[1] = (float)g1; gp[2] = (float)g2;
    gp[3] = (float)g3; gp[4] = (float)g4; gp[5] = (float)g5;
  }
}

// the chains alone: lane 0 runs the forward's (idle, o) or the adjoint's
// (go, gi) lane-0 loops over kProbe samples in shared memory, reps times,
// each time on fresh copies of the same inputs (restored by all lanes)
constexpr int kProbe = 512;

__global__ void floor_cycles_kernel(const float* __restrict__ w,
                              const float* __restrict__ params, float tau,
                              float T, long long n, int reps, int adj,
                              long long* __restrict__ cycles,
                              float* __restrict__ sink) {
  __shared__ float p0[kProbe], p1[kProbe], p2[kProbe], p3[kProbe];
  __shared__ float w0[kProbe], w1[kProbe];
  const int lane = threadIdx.x;
  const int len = n < kProbe ? (int)n : kProbe;
  Floor f;
  f.init(params, tau, T);
  for (int i = lane; i < len; i += kTile) {
    const float a = sigm((w[i] - f.thresh) / f.T);
    p0[i] = adj ? 1e-3f * w[i] : a;          // g_out / a
    p1[i] = adj ? (a > 0.5f ? 1.0f : 0.5f) : w[i];   // wm / t
    p2[i] = a > 0.25f ? 1.0f : 0.5f;         // wt
    p3[i] = a;
  }
  float o = 0.0f, idle = 0.0f, go = 0.0f, gi = 0.0f;
  long long spent = 0;
  for (int r = 0; r < reps; ++r) {
    o = w[0], idle = 0.0f, go = 0.0f, gi = 0.0f;   // from the row's start
    __syncwarp();
    for (int i = lane; i < len; i += kTile) {
      w0[i] = p0[i];
      w1[i] = adj ? 1e-4f * p3[i] : p1[i];
    }
    __syncwarp();
    if (lane == 0) {
      const long long t0 = clock64();
      for (int k0 = 0; k0 < len; k0 += kTile) {
        const int cnt = len - k0 < kTile ? len - k0 : kTile;
        if (adj) {
          go_chain(w0 + k0, p1 + k0, p2 + k0, cnt, go);
          gi_chain(w1 + k0, p3 + k0, cnt, gi);
        } else {
          idle_chain(w0 + k0, cnt, idle);
          out_chain(f, w1 + k0, cnt, o);
        }
      }
      spent += clock64() - t0;
    }
  }
  if (lane == 0) {
    cycles[0] = spent;
    sink[0] = o + idle + go + gi + w0[0] + w1[0];
  }
}

}  // namespace

// out, idle_out [rows, n] of w [rows, n] and params [rows, 6]
extern "C" int gpu_floor_relaxed_forward(const void* w, const void* params,
                                         float tau, float T, void* out,
                                         void* idle_out, int rows,
                                         long long n, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  floor_forward_kernel<<<rows, kTile, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)params, tau, T, (float*)out,
      (float*)idle_out, n);
  return (int)cudaGetLastError();
}

// g_w [rows, n] and g_params [rows, 6] of the loss whose gradient with
// respect to the forward's out is g_out [rows, n]
extern "C" int gpu_floor_relaxed_adjoint(const void* w, const void* params,
                                         float tau, float T, const void* out,
                                         const void* idle_in,
                                         const void* g_out, void* g_w,
                                         void* g_params, int rows,
                                         long long n, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  floor_adjoint_kernel<<<rows, kTile, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)params, tau, T, (const float*)out,
      (const float*)idle_in, (const float*)g_out, (float*)g_w,
      (float*)g_params, n);
  return (int)cudaGetLastError();
}

// cycles[0] = SM cycles of reps * min(n, 512) steps of the forward's
// (adj 0) or the adjoint's (adj 1) serial chains; a probe of the chains
// alone
extern "C" int gpu_floor_relaxed_step_cycles(const void* w,
                                             const void* params, float tau,
                                             float T, long long n, int reps,
                                             int adj, void* cycles,
                                             void* sink, void* stream) {
  if (n <= 0 || reps <= 0) return (int)cudaErrorInvalidValue;
  floor_cycles_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)params, tau, T, n, reps, adj,
      (long long*)cycles, (float*)sink);
  return (int)cudaGetLastError();
}
