// The ballast GEMM burner: kernel G of the port.
//
// Replaces the reference's Pallas kernel ballast_pallas
// (src/repro/kernels/ballast/ballast.py:33, body _ballast_kernel at :22).
// From C = a [M, K] (f32 or bf16, widened to f32 on load), n_iter steps of
//   C <- (C B) decay,   B = b [K, N] (f32 or bf16, widened), K == N,
// with f32 products and sums on the CUDA cores (FFMA, not TF32: the
// reference's products are f32), into C [M, N] f32.
//
// Design.  Row i of C B needs only row i of C, but every step needs all of
// the previous row, so a block owns kRows rows of C and synchronises once
// per step.  The rows live in shared memory, double-buffered (a step reads
// one buffer and writes the other, then one barrier); one thread owns one
// column j and keeps the kRows sums of that column in registers:
//   acc[r] = sum_k C[r, k] B[k, j],   k ascending, one FFMA each,
// then C'[r, j] = acc[r] decay.  Threads of a warp read neighbouring
// columns of B's row k (coalesced) and the same C[r, k] (a broadcast).
// B at K = N = 256 is 256 KB in f32, more than the 227 KB of shared memory
// a block may have, so this simple kernel streams B's rows from L2 at every
// step.  No shortcut for a diagonal B: the burner exists to do the FLOPs.
//
// Bound on this card: operations, 2 M K N n_iter over the 67 TFLOP/s of
// f32 outside the tensor cores (2.09 ms for ballast_burn's default 140
// GFLOP burn); the bytes, a and C once, are microseconds.  At M = 1024 and
// kRows = 8 the grid is 128 blocks of N threads, one per SM, so each SM
// keeps 8 warps in flight against B's L2 latency.  Splitting N across a
// thread-block cluster with distributed shared memory, so that B stays on
// chip, or keeping B in registers is the redesign that would approach the
// bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TA, typename TB>
__global__ void ballast_kernel(const TA* __restrict__ a,
                               const TB* __restrict__ b,
                               float* __restrict__ out, int M, int N,
                               int n_iter, float decay) {
  extern __shared__ float4 smem4[];          // [2][kRows][N] floats
  float* cs = reinterpret_cast<float*>(smem4);
  const int j = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, (long long)M - row0);
  for (int idx = j; idx < kRows * N; idx += blockDim.x) {
    const int r = idx / N, k = idx % N;
    cs[idx] = r < rows ? widen(a[(row0 + r) * N + k]) : 0.f;
  }
  __syncthreads();
  for (int it = 0; it < n_iter; ++it) {
    const float* cur = cs + (it & 1) * kRows * N;
    float* nxt = cs + ((it + 1) & 1) * kRows * N;
    if (j < N) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 2
      for (int k = 0; k < N; k += 4) {
        const float b0 = widen(b[(long long)k * N + j]);
        const float b1 = widen(b[(long long)(k + 1) * N + j]);
        const float b2 = widen(b[(long long)(k + 2) * N + j]);
        const float b3 = widen(b[(long long)(k + 3) * N + j]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 c = *reinterpret_cast<const float4*>(cur + r * N + k);
          acc[r] = __fmaf_rn(c.x, b0, acc[r]);
          acc[r] = __fmaf_rn(c.y, b1, acc[r]);
          acc[r] = __fmaf_rn(c.z, b2, acc[r]);
          acc[r] = __fmaf_rn(c.w, b3, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) nxt[r * N + j] = __fmul_rn(acc[r], decay);
    }
    __syncthreads();
  }
  const float* fin = cs + (n_iter & 1) * kRows * N;
  if (j < N)
    for (int r = 0; r < rows; ++r) out[(row0 + r) * N + j] = fin[r * N + j];
}

template <typename TA, typename TB>
int launch(const void* a, const void* b, void* out, int M, int N,
           int n_iter, float decay, cudaStream_t stream) {
  const int smem = 2 * kRows * N * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ballast_kernel<TA, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = (N + 31) / 32 * 32;
  const int blocks = (M + kRows - 1) / kRows;
  ballast_kernel<TA, TB><<<blocks, threads, smem, stream>>>(
      (const TA*)a, (const TB*)b, (float*)out, M, N, n_iter, decay);
  return (int)cudaGetLastError();
}

template <typename TA>
int launch_b(const void* a, const void* b, void* out, int M, int N,
             int n_iter, float decay, int b_bf16, cudaStream_t stream) {
  return b_bf16 ? launch<TA, __nv_bfloat16>(a, b, out, M, N, n_iter, decay,
                                            stream)
                : launch<TA, float>(a, b, out, M, N, n_iter, decay, stream);
}

}  // namespace

// a_bf16, b_bf16: 0 for a float32 operand, 1 for bfloat16
extern "C" int ballast_launch(const void* a, const void* b, void* out,
                              int M, int N, int n_iter, float decay,
                              int a_bf16, int b_bf16, void* stream) {
  if (M <= 0 || N <= 0 || N > 1024 || N % 4 || n_iter < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return a_bf16 ? launch_b<__nv_bfloat16>(a, b, out, M, N, n_iter, decay,
                                          b_bf16, st)
                : launch_b<float>(a, b, out, M, N, n_iter, decay, b_bf16,
                                  st);
}
