// The adjoint of kernel A's worst-bin amplitude: the gradient that the
// relaxed backstop (smooth_tau > 0) sends back through the monitor to the
// centred trace.
//
// Replaces the reverse pass that jax.grad derives from the reference's jnp
// monitor, sliding_bin_power_jnp (src/repro/kernels/goertzel/ref.py:62) and
// the max over its bins (src/repro/core/smoothing/backstop.py:124-153).  No
// TPU kernel stands behind it: the reference differentiates its jnp mirror,
// not sliding_monitor_pallas (goertzel.py:360), which kernel A ports.
//
// For a row with centred trace xc, bin k at phase step 2 f_k dt (in units of
// pi) and theta_k(j) = pi step_k j:
//   S_k(t)   = sum_{j = max(0, t-win+1)}^{t} xc[j] e^{-i theta_k(j)}
//   amp_k(t) = 2 |S_k(t)| / min(t + 1, win),  worst(t) = max_k amp_k(t)
// and with g = dL/dworst:
//   z_k(t) = g(t) [amp_k(t) = worst(t)] / ties(t) 2 / min(t + 1, win)
//            conj(S_k(t)) / |S_k(t)|                  (0 where |S| = 0)
//   y(j)   = sum_k Re(e^{-i theta_k(j)} sum_{t=j}^{min(j+win-1, n-1)} z_k(t))
//   dL/dxc = y;  the centring's adjoint, y - mean(y), is taken here too.
// A tie splits the gradient equally among the tied bins, as JAX's max does;
// where |S| = 0 the bin gets none, as jax.grad of jnp.abs gives.  Which bins
// hold the maximum is read from the amplitudes the caller passes: kernel
// E's, recomputed by the same walk that gives kernel A's (the A-E witness
// holds them equal bit for bit), so the mask is A's argmax exactly.  Where
// the worst amplitude is at the forward's f32 rounding noise, 2^-24 of the
// row's amplitude scale max |xc| or less, no bin gets any: a flat stretch
// of a trace sums to 0 over whole cycles, S is rounding noise there in f32
// and in float64 alike, and so is its direction.
//
// Bound on this card: the windowed sums.  S and the reverse windowed sum
// of z are differences of prefix sums taken win samples apart, so they
// cancel; they are summed in float64 (prefix sums of a 90 000-sample row
// lose nothing there).  One block of 1024 threads takes one (row, bin) and
// walks the row in tiles of 1024 samples, a sample a thread, so that every
// load and store of a warp is contiguous: a block scan gives each tile's
// prefix and the running total carries it to the next tile.  The prefix
// table P and the suffix table R live in float64 scratch (the window
// reaches 8000 samples back and ahead).  The last block of a row to finish
// (a ticket per row) sums the bins' contributions in bin order and removes
// their mean, so the result does not depend on which block ends first.
// Phases come from sincospi of the step times the index reduced mod 2 in
// float64.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// e^{i pi step j}: cos and sin
__device__ __forceinline__ void phase(double step, long long j, double& c,
                                      double& s) {
  sincospi(fmod(step * (double)j, 2.0), &s, &c);
}

// block-wide exclusive prefix of (re, im) over thread order, and the total
__device__ __forceinline__ void block_scan(double re, double im, double* sm,
                                           double& ex_re, double& ex_im,
                                           double& tot_re, double& tot_im) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double ir = re, ii = im;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double r = __shfl_up_sync(kFull, ir, o);
    const double i = __shfl_up_sync(kFull, ii, o);
    if (lane >= o) { ir += r; ii += i; }
  }
  double er = __shfl_up_sync(kFull, ir, 1), ei = __shfl_up_sync(kFull, ii, 1);
  if (lane == 0) er = ei = 0.0;
  if (lane == 31) { sm[2 * warp] = ir; sm[2 * warp + 1] = ii; }
  __syncthreads();
  if (warp == 0) {
    double wr = sm[2 * lane], wi = sm[2 * lane + 1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double r = __shfl_up_sync(kFull, wr, o);
      const double i = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) { wr += r; wi += i; }
    }
    sm[64 + 2 * lane] = wr;
    sm[64 + 2 * lane + 1] = wi;
  }
  __syncthreads();
  ex_re = er + (warp > 0 ? sm[64 + 2 * (warp - 1)] : 0.0);
  ex_im = ei + (warp > 0 ? sm[64 + 2 * (warp - 1) + 1] : 0.0);
  tot_re = sm[64 + 2 * (kWarps - 1)];
  tot_im = sm[64 + 2 * (kWarps - 1) + 1];
  __syncthreads();
}

__device__ __forceinline__ double block_sum(double v, double* sm) {
  double er, ei, tr, ti;
  block_scan(v, 0.0, sm, er, ei, tr, ti);
  return tr;
}

__device__ __forceinline__ float block_max(float v, double* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  if (lane == 0) sm[warp] = v;
  __syncthreads();
  float m = (float)sm[0];
  for (int q = 1; q < kWarps; ++q) m = fmaxf(m, (float)sm[q]);
  __syncthreads();
  return m;
}

__global__ void __launch_bounds__(kThreads)
monitor_adjoint_kernel(const float* __restrict__ xc,
                       const float* __restrict__ amps,
                       const float* __restrict__ g,
                       const double* __restrict__ step,
                       double* __restrict__ P, double* __restrict__ R,
                       unsigned* __restrict__ done, float* __restrict__ dw,
                       long long n, int K, int win) {
  __shared__ double sm[128];
  __shared__ bool last;
  const int row = blockIdx.x / K, k = blockIdx.x % K;
  const int tid = threadIdx.x;
  const long long tiles = (n + kThreads - 1) / kThreads;
  const float* x = xc + (size_t)row * n;
  const float* gr = g + (size_t)row * n;
  const float* am = amps + (size_t)row * n * K;
  double* Pk = P + (size_t)(row * K + k) * n * 2;
  double* Rk = R + (size_t)(row * K + k) * n * 2;
  const double st = step[k];
  double er, ei, tr, ti;

  // 1. P(j) = sum_{i <= j} xc[i] e^{-i theta(i)}, a tile at a time, and
  // the row's amplitude scale max |xc|
  double cr = 0.0, ci = 0.0;
  float scale = 0.0f;
  for (long long t0 = 0; t0 < tiles; ++t0) {
    const long long j = t0 * kThreads + tid;
    double ur = 0.0, ui = 0.0;
    if (j < n) {
      double c, s;
      phase(st, j, c, s);
      ur = (double)x[j] * c;
      ui = -(double)x[j] * s;
      scale = fmaxf(scale, fabsf(x[j]));
    }
    block_scan(ur, ui, sm, er, ei, tr, ti);
    if (j < n) {
      Pk[2 * j] = cr + er + ur;
      Pk[2 * j + 1] = ci + ei + ui;
    }
    cr += tr;
    ci += ti;
  }
  const float noise = block_max(scale, sm) * 0x1p-24f;
  __syncthreads();

  // 2. z(t) into R
  for (long long t = tid; t < n; t += kThreads) {
    float top = am[t * K];
    for (int q = 1; q < K; ++q) top = fmaxf(top, am[t * K + q]);
    int ties = 0;
    for (int q = 0; q < K; ++q) ties += am[t * K + q] == top;
    double zr = 0.0, zi = 0.0;
    if (top > noise && am[t * K + k] == top) {
      double Sr = Pk[2 * t], Si = Pk[2 * t + 1];
      if (t >= win) {
        Sr -= Pk[2 * (t - win)];
        Si -= Pk[2 * (t - win) + 1];
      }
      const double m = hypot(Sr, Si);
      if (m > 0.0) {
        const double denom = (double)min(t + 1, (long long)win);
        const double coef = (double)gr[t] * 2.0 / denom / (double)ties / m;
        zr = coef * Sr;
        zi = -coef * Si;
      }
    }
    Rk[2 * t] = zr;
    Rk[2 * t + 1] = zi;
  }
  __syncthreads();

  // R(t) = sum_{t' >= t} z(t'), a tile at a time from the row's end (each
  // thread takes the tile's samples in reverse, so the block scan in
  // thread order is the suffix in sample order; a thread reads and writes
  // only its own sample)
  cr = ci = 0.0;
  for (long long t0 = tiles - 1; t0 >= 0; --t0) {
    const long long t = t0 * kThreads + (kThreads - 1 - tid);
    double zr = 0.0, zi = 0.0;
    if (t < n) {
      zr = Rk[2 * t];
      zi = Rk[2 * t + 1];
    }
    block_scan(zr, zi, sm, er, ei, tr, ti);
    if (t < n) {
      Rk[2 * t] = cr + er + zr;
      Rk[2 * t + 1] = ci + ei + zi;
    }
    cr += tr;
    ci += ti;
  }
  __syncthreads();

  // 3. this bin's y(j), over P's real slots (P is read no more)
  for (long long j = tid; j < n; j += kThreads) {
    double Zr = Rk[2 * j], Zi = Rk[2 * j + 1];
    if (j + win < n) {
      Zr -= Rk[2 * (j + win)];
      Zi -= Rk[2 * (j + win) + 1];
    }
    double c, s;
    phase(st, j, c, s);
    Pk[2 * j] = c * Zr + s * Zi;
  }

  // 4. the row's last block: y = sum over bins in bin order, minus its mean
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(done + row, 1u) == (unsigned)K - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const double* Prow = P + (size_t)row * K * n * 2;
  double tot = 0.0;
  for (long long j = tid; j < n; j += kThreads) {
    double y = 0.0;
    for (int q = 0; q < K; ++q) y += __ldcg(Prow + ((size_t)q * n + j) * 2);
    tot += y;
  }
  const double mean = block_sum(tot, sm) / (double)n;
  for (long long j = tid; j < n; j += kThreads) {
    double y = 0.0;
    for (int q = 0; q < K; ++q) y += __ldcg(Prow + ((size_t)q * n + j) * 2);
    dw[(size_t)row * n + j] = (float)(y - mean);
  }
}

}  // namespace

// dw [B, n] = d L / d x (the raw trace, through its centring) from g [B, n]
// = d L / d worst, the centred trace xc [B, n], the amplitudes amps
// [B, n, K] (f32, kernel E's) and step [K] (f64, 2 f_k dt); P and R
// [B, K, n, 2] f64 and done [B] u32 are scratch (done zeroed here).
extern "C" int monitor_adjoint_launch(const void* xc, const void* amps,
                                      const void* g, const void* step,
                                      void* P, void* R, void* done, void* dw,
                                      int B, long long n, int K, int win,
                                      void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (K <= 0 || win <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(done, 0, sizeof(unsigned) * B, s);
  if (e != cudaSuccess) return (int)e;
  monitor_adjoint_kernel<<<B * K, kThreads, 0, s>>>(
      (const float*)xc, (const float*)amps, (const float*)g,
      (const double*)step, (double*)P, (double*)R, (unsigned*)done,
      (float*)dw, n, K, win);
  return (int)cudaGetLastError();
}
