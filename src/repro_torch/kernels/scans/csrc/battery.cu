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
// (about thirty f32 operations) per sample; rows are independent.  One
// thread per row walks its samples in order; input loads run ahead of the
// chain.  It writes the grid trace and the row's SoC minimum and maximum,
// not the SoC trace, which nothing on the Study path reads.
//
// The f32 operations are those of the reference step, in its order, with no
// fused multiply-add (built with -fmad=false).
//
// params[r] = {alpha, lat_n, cap_j, max_dis, max_chg, eff, soc0, tgt0}.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float clipf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float signf(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

__global__ void battery_kernel(const float* __restrict__ w,
                               const float* __restrict__ params, float dt,
                               float* __restrict__ grid,
                               float* __restrict__ soc_min,
                               float* __restrict__ soc_max, int rows,
                               long long n) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* x = w + (long long)r * n;
  float* g = grid + (long long)r * n;
  const float* p = params + 8 * r;
  const float alpha = p[0], lat_n = p[1], cap_j = p[2], max_dis = p[3];
  const float max_chg = p[4], eff = p[5];
  float soc = p[6], tgt = p[7], mode = 0.0f, hold = 0.0f;
  float lo = __int_as_float(0x7f800000), hi = -lo;
  for (long long i = 0; i < n; ++i) {
    const float v = x[i];
    tgt = tgt + alpha * (v - tgt);
    const float want = v - tgt;
    const float new_mode = signf(want);
    const bool switching =
        (new_mode != mode) && (new_mode != 0.0f) && (mode != 0.0f);
    hold = switching ? lat_n : fmaxf(hold - 1.0f, 0.0f);
    const bool blocked = hold > 0.0f;
    const float soc_frac = soc / cap_j;
    const float taper_lo = clipf(soc_frac / 0.1f, 0.0f, 1.0f);
    const float taper_hi = clipf((1.0f - soc_frac) / 0.1f, 0.0f, 1.0f);
    float dis = clipf(want, 0.0f, max_dis * taper_lo);
    dis = fminf(dis, soc * eff / dt);
    float chg = clipf(-want, 0.0f, max_chg * taper_hi);
    chg = fminf(chg, (cap_j - soc) / eff / dt);
    if (blocked) { dis = 0.0f; chg = 0.0f; }
    g[i] = v - dis + chg;
    soc = soc - dis * dt / eff + chg * dt * eff;
    soc = clipf(soc, 0.0f, cap_j);
    mode = new_mode;
    lo = fminf(lo, soc);
    hi = fmaxf(hi, soc);
  }
  soc_min[r] = lo;
  soc_max[r] = hi;
}

}  // namespace

extern "C" int battery_launch(const void* w, const void* params, float dt,
                              void* grid, void* soc_min, void* soc_max,
                              int rows, long long n, void* stream) {
  const int threads = 32;
  const int blocks = (rows + threads - 1) / threads;
  battery_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)params, dt, (float*)grid,
      (float*)soc_min, (float*)soc_max, rows, n);
  return (int)cudaGetLastError();
}
