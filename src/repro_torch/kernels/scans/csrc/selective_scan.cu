// Mamba's selective scan (S6): kernel L of the port.
//
// Replaces the reference's lax.scan over time in mamba_forward
// (src/repro/models/mamba.py:78-90; no pallas_call).  For each batch row
// b and inner channel d it runs, over the time steps t,
//
//   dA  = exp(dt[t, d] * A[d, s])
//   h_s = dA * h_s + (dt[t, d] * B[t, s]) * x[t, d]     (s < ds)
//   y[t, d] = sum_s h_s * C[t, s]
//
// with the f32 state h [B, di, ds] carried in and out.  Each product and
// sum is rounded on its own (__fmul_rn, __fadd_rn: never contracted into
// a fused multiply-add), in the reference's order; y sums the states in
// order s = 0, 1, ....  A step's arithmetic does not depend on where its
// call or tile begins, so calls that carry h_last into h0 equal one call
// bit for bit.  expf is the library's (no --use_fast_math).
//
// Bound on this card: at jamba's prefill shape (4 x 4096 steps, di 8192,
// ds 16) the bytes are xi (bf16), dt and ys (f32), about 1.34 GB, and the
// operations B T di ds expf calls, 2.1 G, on the special function units;
// the two are of one size.  The time axis is a dependent chain, but a
// chain of one multiply-add a state, and channels are independent.  So
// one thread takes one (b, d): its ds states and its row of A live in
// registers.  A block of kThreads consecutive channels of one row stages
// B and C (the same for every channel) for a tile of kTile steps in
// shared memory, in f32, and loads the tile's x and dt into registers
// before the tile's chain, so the loads are in flight together; x, dt and
// y move coalesced along the channels.  The tile's steps are unrolled
// whole: a step's expf do not wait on the state, so later steps' overlap
// its chain (staged in shared memory and unrolled by 4, the kernel took
// 3.35 ms at jamba's prefill shape against 2.08 ms this way).  Channels
// past di (a ragged edge) only help stage the tile.  Built for d_state 8
// and 16 (Mamba's and its reduced configurations'), in f32 and bf16.
//
// Layouts (row major, contiguous): xi, dt, ys [B, T, di]; Bc, Cc
// [B, T, ds]; A [di, ds]; h0, h_last [B, di, ds].
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // channels a block
constexpr int kTile = 16;     // time steps a tile

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int DS>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const T* __restrict__ xi, const float* __restrict__ dt,
                      const T* __restrict__ Bc, const T* __restrict__ Cc,
                      const float* __restrict__ A,
                      const float* __restrict__ h0, float* __restrict__ ys,
                      float* __restrict__ h_last, int steps, int di) {
  __shared__ float sb[kTile][DS];
  __shared__ float sc[kTile][DS];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < di;
  const size_t state = ((size_t)b * di + (live ? d : 0)) * DS;
  float a[DS], h[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    a[s] = live ? A[(size_t)(live ? d : 0) * DS + s] : 0.0f;
    h[s] = live ? h0[state + s] : 0.0f;
  }
  const size_t row = (size_t)b * steps;  // this row's first step
  for (int t0 = 0; t0 < steps; t0 += kTile) {
    const int n = min(kTile, steps - t0);
    __syncthreads();  // the previous tile's B and C are read
    for (int i = threadIdx.x; i < n * DS; i += kThreads) {
      const size_t g = (row + t0) * DS + i;
      sb[i / DS][i % DS] = f32(Bc[g]);
      sc[i / DS][i % DS] = f32(Cc[g]);
    }
    float xv[kTile], dv[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (live && j < n) {
        const size_t g = (row + t0 + j) * di + d;
        xv[j] = f32(xi[g]);
        dv[j] = dt[g];
      }
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j < n) {
        float y = 0.0f;
#pragma unroll
        for (int s = 0; s < DS; ++s) {
          const float dA = expf(__fmul_rn(dv[j], a[s]));
          const float dBx = __fmul_rn(__fmul_rn(dv[j], sb[j][s]), xv[j]);
          h[s] = __fadd_rn(__fmul_rn(dA, h[s]), dBx);
          y = __fadd_rn(y, __fmul_rn(h[s], sc[j][s]));
        }
        ys[(row + t0 + j) * di + d] = y;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < DS; ++s) h_last[state + s] = h[s];
  }
}

template <typename T, int DS>
int launch(const void* xi, const void* dt, const void* Bc, const void* Cc,
           const void* A, const void* h0, void* ys, void* h_last, int B,
           int steps, int di, cudaStream_t stream) {
  dim3 grid((di + kThreads - 1) / kThreads, B);
  selective_scan_kernel<T, DS><<<grid, kThreads, 0, stream>>>(
      (const T*)xi, (const float*)dt, (const T*)Bc, (const T*)Cc,
      (const float*)A, (const float*)h0, (float*)ys, (float*)h_last, steps,
      di);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ds(int ds, const void* xi, const void* dt, const void* Bc,
              const void* Cc, const void* A, const void* h0, void* ys,
              void* h_last, int B, int steps, int di, cudaStream_t stream) {
  switch (ds) {
    case 8:
      return launch<T, 8>(xi, dt, Bc, Cc, A, h0, ys, h_last, B, steps, di,
                          stream);
    case 16:
      return launch<T, 16>(xi, dt, Bc, Cc, A, h0, ys, h_last, B, steps, di,
                           stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16 != 0: xi, Bc and Cc are bf16, else f32.  ds must be 8 or 16 (the
// wrapper refuses any other before it gets here).
extern "C" int selective_scan_launch(const void* xi, const void* dt,
                                     const void* Bc, const void* Cc,
                                     const void* A, const void* h0, void* ys,
                                     void* h_last, int B, int steps, int di,
                                     int ds, int bf16, void* stream) {
  if (B <= 0 || steps <= 0 || di <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_ds<__nv_bfloat16>(ds, xi, dt, Bc, Cc, A, h0, ys, h_last, B,
                                    steps, di, s);
  return launch_ds<float>(ds, xi, dt, Bc, Cc, A, h0, ys, h_last, B, steps,
                          di, s);
}
