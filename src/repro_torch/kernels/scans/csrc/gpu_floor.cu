// GB200-style device power smoothing, hard semantics: kernel B of the port.
//
// Replaces the reference's per-sample lax.scan of GpuPowerSmoothing.apply_jax
// (src/repro/core/smoothing/gpu_floor.py:85): an idle counter, the minimum
// power floor held for stop_delay after activity stops, the EDP cap and the
// ramp-rate clip against the previous output.
//
// Bound on this card: a serial chain.  Each output is clipped against the
// previous one, so a row costs one dependent step per sample; rows are
// independent.  One thread per row walks its samples in order.  The input
// loads do not depend on the chain and run ahead of it; the 8 bytes a
// sample moves are far below what the card can move in that time.
//
// The f32 operations are those of the reference step, in its order, with no
// fused multiply-add (built with -fmad=false), so the kernel and the plain
// PyTorch loop round alike.
//
// params[r] = {mpf, thresh, ru, rd, stop_n, cap}, all f32.
#include <cuda_runtime.h>

namespace {

__global__ void gpu_floor_kernel(const float* __restrict__ w,
                                 const float* __restrict__ params,
                                 float* __restrict__ out, int rows,
                                 long long n) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* x = w + (long long)r * n;
  float* y = out + (long long)r * n;
  const float* p = params + 6 * r;
  const float mpf = p[0], thresh = p[1], ru = p[2], rd = p[3];
  const float stop_n = p[4], cap = p[5];
  float o = x[0];
  float idle = 0.0f;
  for (long long i = 0; i < n; ++i) {
    const float v = x[i];
    idle = (v > thresh) ? 0.0f : idle + 1.0f;
    const float floor_w = (idle <= stop_n) ? mpf : 0.0f;
    const float target = fminf(fmaxf(v, floor_w), cap);
    o = fminf(fmaxf(target, o - rd), o + ru);
    y[i] = o;
  }
}

}  // namespace

extern "C" int gpu_floor_launch(const void* w, const void* params, void* out,
                                int rows, long long n, void* stream) {
  const int threads = 32;
  const int blocks = (rows + threads - 1) / threads;
  gpu_floor_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)params, (float*)out, rows, n);
  return (int)cudaGetLastError();
}
