// RWKV-6's wkv recurrence: kernel M of the port.
//
// Replaces the reference's lax.scan over time in rwkv_tm_forward
// (src/repro/models/rwkv.py:79-89; no pallas_call).  For each batch row b
// and head h it runs, over the time steps t, with the f32 state S
// [hd_k, hd_v] carried in and out,
//
//   kv_ij = k_i v_j
//   y_j   = sum_i r_i (S_ij + u_i kv_ij)
//   S_ij  = w_i S_ij + kv_ij
//
// (r, k, w on the key channel i, v and y on the value channel j; w is the
// decay exp(-exp(w0 + lora)) in (0, 1), computed by the wrapper's caller
// as the reference computes it).  Each product and sum is rounded on its
// own (__fmul_rn, __fadd_rn: never contracted), in the reference's order;
// y_j sums over i = 0, 1, ....  A step's arithmetic does not depend on
// where its call or tile begins, so calls that carry S_last into S0 equal
// one call bit for bit.
//
// Bound on this card: at rwkv6-3b's prefill shape (4 x 4096 steps, 40
// heads of 64) the bytes are r, k, v (bf16), w and y (f32), about 0.59 GB,
// and the operations 6 hd^2 a (b, h, step), 16 G, at 67 TFLOP/s; but each
// step's y_j is a dependent sum of hd terms, and the steps of a (b, h)
// follow one another, so the chain (steps x hd dependent adds) is what a
// (b, h) cannot go below.  One block takes one (b, h), hd threads: thread j
// holds column j of S, and u, in registers, so the state never leaves the
// SM; for each tile of kTile steps the block stages r, k and w (the key
// side, which every thread reads whole, four channels a load) and v in
// shared memory, in f32, all the tile's loads in flight together; each
// thread writes its y_j, coalesced along j.  The loop over a tile's steps
// is not unrolled (the one over the key channel is), which keeps the
// build to seconds.
//
// Layouts (row major, contiguous): r, k, v, w, y [B, T, H, hd]; u [H, hd];
// S0, S_last [B, H, hd, hd] (key channel, then value channel).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;  // time steps a tile

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// four consecutive floats of shared memory (16-byte aligned when HD >= 4)
template <int HD>
__device__ __forceinline__ float4 quad(const float* p) {
  if constexpr (HD % 4 == 0) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    return make_float4(p[0], HD > 1 ? p[1] : 0.f, HD > 2 ? p[2] : 0.f, 0.f);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ S0,
            float* __restrict__ y, float* __restrict__ S_last, int steps,
            int H) {
  constexpr int kW = HD < 4 ? 4 : HD;  // a row's floats, padded to a quad
  __shared__ __align__(16) float sr[kTile][kW];
  __shared__ __align__(16) float sk[kTile][kW];
  __shared__ __align__(16) float sw[kTile][kW];
  __shared__ float sv[kTile][HD];
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x;
  const size_t state = (size_t)bh * HD * HD + j;
  float S[HD], uu[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) {
    S[i] = S0[state + (size_t)i * HD];
    uu[i] = u[h * HD + i];
  }
  const size_t stride = (size_t)H * HD;  // one step
  const size_t base = ((size_t)b * steps * H + h) * HD + j;
  for (int t0 = 0; t0 < steps; t0 += kTile) {
    const int n = min(kTile, steps - t0);
    __syncthreads();  // the previous tile is read
#pragma unroll
    for (int q = 0; q < kTile; ++q) {
      if (q < n) {
        const size_t g = base + (size_t)(t0 + q) * stride;
        sr[q][j] = f32(r[g]);
        sk[q][j] = f32(k[g]);
        sw[q][j] = w[g];
        sv[q][j] = f32(v[g]);
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int q = 0; q < n; ++q) {
      const float vj = sv[q][j];
      float yj = 0.0f;
#pragma unroll
      for (int i0 = 0; i0 < HD; i0 += 4) {
        const float4 k4 = quad<HD>(&sk[q][i0]);
        const float4 w4 = quad<HD>(&sw[q][i0]);
        const float4 r4 = quad<HD>(&sr[q][i0]);
        const float kq[4] = {k4.x, k4.y, k4.z, k4.w};
        const float wq[4] = {w4.x, w4.y, w4.z, w4.w};
        const float rq[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
        for (int e = 0; e < 4 && i0 + e < HD; ++e) {
          const int i = i0 + e;
          const float kv = __fmul_rn(kq[e], vj);
          const float a = __fadd_rn(S[i], __fmul_rn(uu[i], kv));
          yj = __fadd_rn(yj, __fmul_rn(rq[e], a));
          S[i] = __fadd_rn(__fmul_rn(wq[e], S[i]), kv);
        }
      }
      y[base + (size_t)(t0 + q) * stride] = yj;
    }
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) S_last[state + (size_t)i * HD] = S[i];
}

// The chain of one step alone: reps steps of a dependent sum of 64
// products (y_j's sum over i; the products do not wait on y), one thread.
__global__ void wkv6_cycles_kernel(const float* __restrict__ vals, int reps,
                                   long long* cycles, float* sink) {
  float p[64], q[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    p[i] = vals[i];
    q[i] = vals[64 + i];
  }
  float acc = 0.0f;
  const long long t0 = clock64();
  for (int n = 0; n < reps; ++n) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc = __fadd_rn(acc, __fmul_rn(p[i], q[i]));
  }
  const long long t1 = clock64();
  cycles[0] = t1 - t0;
  sink[0] = acc;
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* S0, void* y, void* S_last, int B,
           int steps, int H, cudaStream_t stream) {
  wkv6_kernel<T, HD><<<B * H, HD, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)w,
      (const float*)u, (const float*)S0, (float*)y, (float*)S_last, steps,
      H);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* r, const void* k, const void* v,
              const void* w, const void* u, const void* S0, void* y,
              void* S_last, int B, int steps, int H, cudaStream_t s) {
  switch (hd) {
    case 1: return launch<T, 1>(r, k, v, w, u, S0, y, S_last, B, steps, H, s);
    case 2: return launch<T, 2>(r, k, v, w, u, S0, y, S_last, B, steps, H, s);
    case 4: return launch<T, 4>(r, k, v, w, u, S0, y, S_last, B, steps, H, s);
    case 8: return launch<T, 8>(r, k, v, w, u, S0, y, S_last, B, steps, H, s);
    case 16:
      return launch<T, 16>(r, k, v, w, u, S0, y, S_last, B, steps, H, s);
    case 32:
      return launch<T, 32>(r, k, v, w, u, S0, y, S_last, B, steps, H, s);
    case 64:
      return launch<T, 64>(r, k, v, w, u, S0, y, S_last, B, steps, H, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16 != 0: r, k and v are bf16, else f32.  hd must be a power of two
// up to 64 (the wrapper refuses any other before it gets here).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* S0,
                           void* y, void* S_last, int B, int steps, int H,
                           int hd, int bf16, void* stream) {
  if (B <= 0 || steps <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_hd<__nv_bfloat16>(hd, r, k, v, w, u, S0, y, S_last, B,
                                    steps, H, s);
  return launch_hd<float>(hd, r, k, v, w, u, S0, y, S_last, B, steps, H, s);
}

// cycles[0] = SM cycles of reps steps of the chain alone (vals: 128 f32)
extern "C" int wkv6_step_cycles(const void* vals, int reps, void* cycles,
                                void* sink, void* stream) {
  if (reps <= 0) return (int)cudaErrorInvalidValue;
  wkv6_cycles_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const float*)vals, reps, (long long*)cycles, (float*)sink);
  return (int)cudaGetLastError();
}
