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
// The forward writes o and the idle counter; the adjoint recomputes each
// step from (x_i, o_{i-1}, idle_{i-1}) with the forward's own expressions
// and carries the adjoints of o and idle back along the row.  It
// writes the gradient with respect to every sample and, summed in f64 over
// the row, with respect to each of the six parameters.  A max or min whose
// two sides are equal sends half of the gradient to each side, as JAX's
// lax.max and lax.min do.
//
// Bound on this card: the serial chains, idle (two operations a step) and
// o (three); a_i, the floor and the two soft maxima (two exp and two
// log1p, six divisions) depend on the chains' values but feed nothing
// back.  A design call has only 6 or 10 rows, so a warp a row leaves most
// of the card idle; here each row is cut into chunks of 1024 samples, a
// warp a chunk, over the whole card (chain_walk.cuh has the scheme).
//
//  * Forward, one launch: a chunk's lanes load its samples and compute
//    1 - a_i; the idle counter runs as segmented walks with the exact merge
//    test (guess 0: the factor 1 - a_i contracts the counter, so walks from
//    any start meet bit for bit within a few active samples); the chunk's
//    targets follow in parallel; then o runs the same way (guess: the
//    segment's first target; the walks meet where the ramp clip lets go,
//    and a ramp-limited row costs its serial walk).  The idle wave runs
//    ahead of the o wave along the row.  The f32 operations a step are the
//    ones a warp-a-row kernel ran, so the outputs are its bits exactly.
//  * Adjoint, one launch, chunks from the row's end: the carry of dL/do
//    is affine in the next one, carry_{i-1} = w_i (carry_i + g_i) with w_i
//    in {0, 1/4, 1/2, 3/4, 1} from the clip's tie weights; the carry of
//    dL/didle is (1 - a_i) (carry_i - dN_i).  Both are float64 affine scans
//    (lane maps, a warp scan, the chunk's map ready before its carry
//    arrives); every other term is per sample, recomputed from (x_i,
//    o_{i-1}, idle_{i-1}) with the forward's expressions.  The parameter
//    sums are f64 per lane, reduced across the warp and then, by chunk 0,
//    across chunks in chunk order.
//  * gpu_floor_relaxed_step_cycles times the chains' own steps: the warp
//    walks the forward's (o, idle) in step with the merge test, or the
//    adjoint's f64 affine steps, over a row's first 512 samples in shared
//    memory.
//
// Built with -fmad=false, so that the operations are those written here.
#include <cuda_runtime.h>

#include "chain_walk.cuh"

namespace {

using namespace chain;

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

// ---- the two recurrences, over a lane's segment in shared memory

// idle' = (1 - a) (idle + 1), c[j] = 1 - a_j
struct IdleChain {
  const float* c;
  __device__ __forceinline__ IdleChain shift(int d) const {
    return {c + d};
  }
  __device__ __forceinline__ float step(float s, int j) const {
    return c[j] * (s + 1.0f);
  }
  __device__ __forceinline__ void run8(float& s, int j, float* v) const {
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = s = step(s, j + q);
  }
};

// o' = min(max(t, o - rd), o + ru)
struct OutChain {
  const float* t;
  float rd, ru;
  __device__ __forceinline__ OutChain shift(int d) const {
    return {t + d, rd, ru};
  }
  __device__ __forceinline__ float step(float s, int j) const {
    return fminf(fmaxf(t[j], s - rd), s + ru);
  }
  __device__ __forceinline__ void run8(float& s, int j, float* v) const {
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = s = step(s, j + q);
  }
};

__global__ void __launch_bounds__(kLanes)
floor_forward_kernel(const float* __restrict__ w,
                     const float* __restrict__ params, float tau, float T,
                     float* __restrict__ out, float* __restrict__ idle_out,
                     int rows, long long n,
                     unsigned long long* __restrict__ scratch,
                     int* __restrict__ stats) {
  __shared__ float sx[kWords], sc[kWords], si[kWords], st[kWords],
      so[kWords];
  const Place p = place(scratch, rows, n, false);
  Floor f;
  f.init(params + 6 * (size_t)p.row, tau, T);
  const float* x = w + (size_t)p.row * n + p.i0;
  for (int idx = p.lane; idx < p.cnt; idx += kLanes) {
    const float v = x[idx];
    sx[at(idx)] = v;
    sc[at(idx)] = 1.0f - sigm((v - f.thresh) / f.T);
  }
  __syncwarp();
  const int seg = p.lane * kStride;
  float s0;
  chain_chunk(IdleChain{sc + seg}, si + seg, 0.0f, 0.0f, scratch, p, 0,
              stats, 2, s0);
  float* io = idle_out + (size_t)p.row * n + p.i0;
  for (int idx = p.lane; idx < p.cnt; idx += kLanes) {
    const float id = si[at(idx)];
    io[idx] = id;
    st[at(idx)] = target(f, sx[at(idx)], id);
  }
  __syncwarp();
  chain_chunk(OutChain{st + seg, f.rd, f.ru}, so + seg, st[seg],
              w[(size_t)p.row * n], scratch, p, 1, stats, 2, s0);
  float* o = out + (size_t)p.row * n + p.i0;
  for (int idx = p.lane; idx < p.cnt; idx += kLanes) o[idx] = so[at(idx)];
}

// one sample's step, recomputed from (x, o_{i-1}, idle_{i-1}) with the
// forward's expressions: every term the adjoint reads
struct FloorStep {
  float a, ip1, v, gs, x1, x2, y1, y2, wm, wt;
};

__device__ __forceinline__ FloorStep floor_step(const Floor& f, float xv,
                                                float o_prev,
                                                float idle_prev) {
  FloorStep r;
  const float u = (xv - f.thresh) / f.T;
  r.a = sigm(u);
  r.ip1 = idle_prev + 1.0f;
  const float idle = (1.0f - r.a) * r.ip1;
  r.v = (f.stop_n - idle) / f.S;
  r.gs = sigm(r.v);
  const float fl = f.mpf * r.gs;
  r.x1 = xv / f.T;
  r.x2 = fl / f.T;
  const float t1 = f.T * logaddexp(r.x1, r.x2);
  r.y1 = -t1 / f.T;
  r.y2 = -f.cap / f.T;
  const float t2 = -(f.T * logaddexp(r.y1, r.y2));
  const float lo = o_prev - f.rd, hi = o_prev + f.ru;
  const float m = fmaxf(t2, lo);
  r.wm = wmin(m, hi);
  r.wt = wmax(t2, lo);
  return r;
}

// dL/do_{i-1} per unit of dL/do_i in total: dm (1 - wt) + dhi
__device__ __forceinline__ double out_weight(const FloorStep& r) {
  return (double)r.wm * (1.0 - (double)r.wt) + (1.0 - (double)r.wm);
}

__global__ void __launch_bounds__(kLanes)
floor_adjoint_kernel(const float* __restrict__ w,
                     const float* __restrict__ params, float tau, float T,
                     const float* __restrict__ out,
                     const float* __restrict__ idle_in,
                     const float* __restrict__ g_out, float* __restrict__ g_w,
                     float* __restrict__ g_params, int rows, long long n,
                     unsigned long long* __restrict__ scratch) {
  __shared__ float sx[kWords], sop[kWords], sip[kWords], sg[kWords],
      sd[kWords], sdx[kWords];
  const Place p = place(scratch, rows, n, true);
  Floor f;
  f.init(params + 6 * (size_t)p.row, tau, T);
  const size_t base = (size_t)p.row * n;
  const float x0 = w[base];
  for (int idx = p.lane; idx < p.cnt; idx += kLanes) {
    const long long i = p.i0 + idx;
    sx[at(idx)] = w[base + i];
    sop[at(idx)] = i > 0 ? out[base + i - 1] : x0;
    sip[at(idx)] = i > 0 ? idle_in[base + i - 1] : 0.0f;
    sg[at(idx)] = g_out[base + i];
  }
  __syncwarp();
  const int seg = p.lane * kStride;
  const int len = p.len;
  // the o carry: c_{i-1} = w_i (c_i + g_i), composed from the segment's end
  Map m = {1.0, 0.0};
  for (int j = len - 1; j >= 0; --j) {
    const FloorStep r = floor_step(f, sx[seg + j], sop[seg + j], sip[seg + j]);
    const double wt = out_weight(r);
    m = after(Map{wt, wt * (double)sg[seg + j]}, m);
  }
  double go_out;
  double c = carry_in(m, scratch, p, 0, go_out);
  double g0 = 0.0, g1 = 0.0, g2 = 0.0, g3 = 0.0, g4 = 0.0, g5 = 0.0;
  for (int j = len - 1; j >= 0; --j) {
    const float xv = sx[seg + j];
    const FloorStep r = floor_step(f, xv, sop[seg + j], sip[seg + j]);
    const double tot = c + (double)sg[seg + j];
    c = out_weight(r) * tot;
    const float got = (float)tot;
    // o = min(m, hi), m = max(t2, lo)
    const float dm = got * r.wm, dhi = got * (1.0f - r.wm);
    const float dt2 = dm * r.wt, dlo = dm * (1.0f - r.wt);
    // t2 = -T logaddexp(y1, y2): d/dy1 = 1 / (1 + exp(y2 - y1))
    const float dt1 = dt2 / (1.0f + expf(r.y2 - r.y1));
    const float dcap = dt2 / (1.0f + expf(r.y1 - r.y2));
    // t1 = T logaddexp(x1, x2)
    const float dx = dt1 / (1.0f + expf(r.x2 - r.x1));
    const float dfl = dt1 / (1.0f + expf(r.x1 - r.x2));
    const float dg = dfl * f.mpf;
    const float dv = dg * r.gs * (1.0f - r.gs);
    const float dN = dv / f.S;
    sd[seg + j] = dN;
    sdx[seg + j] = dx;
    g0 += (double)(dfl * r.gs);
    g2 += (double)dhi;
    g3 -= (double)dlo;
    g4 += (double)(dN - f.tau * dv * r.v / f.S);
    g5 += (double)dcap;
  }
  // the idle carry: c_{i-1} = (1 - a_i) (c_i - dN_i)
  m = {1.0, 0.0};
  for (int j = len - 1; j >= 0; --j) {
    const float a = sigm((sx[seg + j] - f.thresh) / f.T);
    const double k = (double)(1.0f - a);
    m = after(Map{k, -k * (double)sd[seg + j]}, m);
  }
  double gi_out;
  c = carry_in(m, scratch, p, 1, gi_out);
  for (int j = len - 1; j >= 0; --j) {
    const float a = sigm((sx[seg + j] - f.thresh) / f.T);
    const double didle64 = c - (double)sd[seg + j];
    c = (double)(1.0f - a) * didle64;
    const float didle = (float)didle64;
    const float da = -didle * (sip[seg + j] + 1.0f);
    const float du = da * a * (1.0f - a);
    sdx[seg + j] = sdx[seg + j] + du / f.T;
    g1 -= (double)(du / f.T);
  }
  __syncwarp();
  float* gw = g_w + base + p.i0;
  for (int idx = p.lane; idx < p.cnt; idx += kLanes) gw[idx] = sdx[at(idx)];
  __syncwarp();
  if (p.chunk == 0 && p.lane == 0) gw[0] += (float)go_out;   // o_{-1} = x_0
  double g[6] = {g0, g1, g2, g3, g4, g5};
  const double none[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  reduce_params(g, 6, scratch, p, 2, none, g_params + 6 * (size_t)p.row);
}

// the chains' own steps over the row's first kProbe samples in shared
// memory, reps times, the warp walking in step as resolve does: adj 0,
// cycles[0] the o walk and cycles[1] the idle walk (each with the merge
// test, against kept outputs it never meets: the serial path of a row
// whose walks do not merge); adj 1, cycles[0] the adjoint's float64
// affine composition a sample
constexpr int kProbe = 512;

__global__ void floor_cycles_kernel(const float* __restrict__ w,
                                    const float* __restrict__ params,
                                    float tau, float T, long long n,
                                    int reps, int adj,
                                    long long* __restrict__ cycles,
                                    float* __restrict__ sink) {
  __shared__ float pin[kProbe], pkept[kProbe];
  const int lane = threadIdx.x;
  const int len = (int)min(n, (long long)kProbe) / kSeg * kSeg;
  Floor f;
  f.init(params, tau, T);
  float acc = 0.0f;
  double dacc = 0.0;
  for (int which = 0; which < (adj ? 1 : 2); ++which) {
    for (int i = lane; i < len; i += kLanes)
      pin[i] = which == 0 && !adj ? w[i]
                                  : 1.0f - sigm((w[i] - f.thresh) / f.T);
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
          const double k = (double)pin[j];
          m = after(Map{k, k * (double)pin[j]}, m);
        }
        dacc += m.a + m.b;
      } else {
        float s = which == 0 ? w[0] : 0.0f;
        for (int j0 = 0; j0 < len; j0 += kSeg) {
          if (which == 0)
            walk<true>(OutChain{pin + j0, f.rd, f.ru}, s, pkept + j0, kSeg);
          else
            walk<true>(IdleChain{pin + j0}, s, pkept + j0, kSeg);
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

// out, idle_out [rows, n] of w [rows, n] and params [rows, 6]; scratch
// holds chain_walk.cuh's scratch_words(rows, n) 8-byte words (zeroed
// here); stats, if not null, gets [rows, chunks, 2 chains, 3] ints (each
// chunk's segments walked again once its start came in, those that did
// not merge, and their steps: chain 0 idle, 1 o)
extern "C" int gpu_floor_relaxed_forward(const void* w, const void* params,
                                         float tau, float T, void* out,
                                         void* idle_out, int rows,
                                         long long n, void* scratch,
                                         void* stats, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(scratch, 0,
                                  8 * chain::scratch_words(rows, n), s);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)(rows * chain::chunks(n));
  floor_forward_kernel<<<blocks, chain::kLanes, 0, s>>>(
      (const float*)w, (const float*)params, tau, T, (float*)out,
      (float*)idle_out, rows, n, (unsigned long long*)scratch, (int*)stats);
  return (int)cudaGetLastError();
}

// g_w [rows, n] and g_params [rows, 6] of the loss whose gradient with
// respect to the forward's out is g_out [rows, n]; scratch as the forward's
extern "C" int gpu_floor_relaxed_adjoint(const void* w, const void* params,
                                         float tau, float T, const void* out,
                                         const void* idle_in,
                                         const void* g_out, void* g_w,
                                         void* g_params, int rows,
                                         long long n, void* scratch,
                                         void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(scratch, 0,
                                  8 * chain::scratch_words(rows, n), s);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)(rows * chain::chunks(n));
  floor_adjoint_kernel<<<blocks, chain::kLanes, 0, s>>>(
      (const float*)w, (const float*)params, tau, T, (const float*)out,
      (const float*)idle_in, (const float*)g_out, (float*)g_w,
      (float*)g_params, rows, n, (unsigned long long*)scratch);
  return (int)cudaGetLastError();
}

// cycles[0..1]: SM cycles of reps walks of the chains over min(n, 512)
// samples (rounded down to whole segments): adj 0, the o and the idle
// walks with the merge test; adj 1, the adjoint's float64 composition
extern "C" int gpu_floor_relaxed_step_cycles(const void* w,
                                             const void* params, float tau,
                                             float T, long long n, int reps,
                                             int adj, void* cycles,
                                             void* sink, void* stream) {
  if (n < chain::kSeg || reps <= 0) return (int)cudaErrorInvalidValue;
  floor_cycles_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)params, tau, T, n, reps, adj,
      (long long*)cycles, (float*)sink);
  return (int)cudaGetLastError();
}
