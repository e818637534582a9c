// The ballast GEMM burner: kernel G of the port.
//
// Replaces the reference's Pallas kernel ballast_pallas
// (src/repro/kernels/ballast/ballast.py:33, body _ballast_kernel at :22).
// From C = a [M, K] (f32 or bf16, widened to f32 on load), n_iter steps of
//   C <- (C B) decay,   B = b [K, N] (f32 or bf16, widened), K == N,
// with f32 products and sums on the CUDA cores (FFMA, not TF32: the
// reference's products are f32), into C [M, N] f32.  Every output is
//   acc = fma(C[r, k], B[k, j], acc) for k ascending from 0, then acc decay,
// in both routes below, so the two give the same bits.
//
// Bound on this card: operations, 2 M K N n_iter over the 67 TFLOP/s of
// f32 outside the tensor cores (2.09 ms for ballast_burn's default 140
// GFLOP burn); the bytes, a and C once, are microseconds.  Row i of C B
// needs only row i of C, but every step needs the whole of B and all of
// the previous row, so a step ends in a barrier over the blocks that share
// the rows.
//
// Route "cluster" (N = 64, 128 or 256): B stays on chip.  A thread-block
// cluster of c blocks (c = 1, 2, 2; Nc = N / c = 64, 64, 128 columns a
// block) shares R = 2048 / Nc rows of C.  Each block keeps one [K x Nc]
// column slice of B in shared memory for the whole burn, and the
// cluster's R rows of C, double-buffered.  Each step, a block computes
// its [R x Nc] slice, writes it into every block's next buffer through
// distributed shared memory, and the cluster meets at one barrier
// (barrier.cluster arrive-release, wait-acquire); the last step writes C
// out instead.  Each of 128 threads holds a 4 x 4 register tile, and a
// group of 4 k loads its operands into one of two register sets while it
// multiplies the other.  A row of C is a 16-byte read shared by the lanes
// of a row, a row of B's slice one shared by the lanes of a column group;
// rows of C sit at a stride of N + 4 words, so a warp's rows fall in
// distinct bank groups.  Shared memory hands an SM 128 bytes a cycle, and
// the tile reads 2 bytes a FFMA (8 floats for 16 FFMAs), so a step is
// bound by those reads at about twice its FFMA time; a larger tile would
// leave the SM fewer than 4 warps at M = 1024.  With c = 2 at N = 256 the
// card holds all 64 clusters at once, 128 blocks, one an SM (c = 4 would
// need two waves).  Rows past M in the last cluster are zeros and are not
// stored.
//
// Route "stream" (every other N <= 1024, N % 4 == 0; from N = 512 on B's
// slices do not fit a cluster's shared memory, and the cluster route is
// built for the three widths above only): each block owns kRows rows of C
// in shared memory, double-buffered, one thread a column keeping kRows
// sums in registers, and streams B's rows from L2 at every step (the
// port's first design).
//
// The route is the wrapper's choice, by shape (kernels/ballast/ballast.py,
// ballast_route); neither gives way to the other.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 8;          // stream: rows of C a block
constexpr int kThreads = 128;     // cluster: threads a block
constexpr int kOutputs = 2048;    // cluster: outputs a block a step, R x Nc

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// ---------------------------------------------------------------------------
// route "cluster"
// ---------------------------------------------------------------------------

// A block's 128 threads each hold a 4 x 4 tile of its [R x Nc] slice:
// rows lr + LR i (i < 4) and columns 4 (warp LC + lc) .. + 3, for lane
// = lr LC + lc.
template <int N, int C>
struct Geometry {
  static constexpr int Nc = N / C;           // columns a block
  static constexpr int R = kOutputs / Nc;    // rows a cluster
  static constexpr int P = N + 4;            // row stride of C, words
  static constexpr int LR = R / 4;           // row lanes of a warp
  static constexpr int LC = 32 / LR;         // column lanes of a warp
  static constexpr size_t smem =
      sizeof(float) * ((size_t)N * Nc + 2 * (size_t)R * P);
  static_assert(N % C == 0 && (Nc == 64 || Nc == 128) &&
                    4 * LC * (kThreads / 32) == Nc,
                "geometry");
};

// a thread's operands of one group of 4 k: its 4 rows of C (a float4
// each, along k) and B's 4 rows at its 4 columns
template <typename G>
struct Operands {
  float4 c[4];
  float4 b[4];

  __device__ __forceinline__ void load(const float* cur, const float* bs,
                                      int lr, int col, int k) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      c[i] = *reinterpret_cast<const float4*>(cur + (lr + G::LR * i) * G::P +
                                              k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      b[kk] = *reinterpret_cast<const float4*>(bs + (k + kk) * G::Nc + col);
  }

  // acc += C B over the group, one FFMA a product, k ascending
  __device__ __forceinline__ void fma(float (&acc)[4][4]) const {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = lane_of(c[i], kk);
        acc[i][0] = __fmaf_rn(x, b[kk].x, acc[i][0]);
        acc[i][1] = __fmaf_rn(x, b[kk].y, acc[i][1]);
        acc[i][2] = __fmaf_rn(x, b[kk].z, acc[i][2]);
        acc[i][3] = __fmaf_rn(x, b[kk].w, acc[i][3]);
      }
  }
};

template <int N, int C, typename TA, typename TB>
__global__ void __launch_bounds__(kThreads, 1)
ballast_cluster_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                       float* __restrict__ out, int M, int n_iter,
                       float decay) {
  using G = Geometry<N, C>;
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                       // [N][Nc]: B's column slice
  float* cbuf = smem + N * G::Nc;         // [2][R][P]: the cluster's rows
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long row0 = (long long)(blockIdx.x / C) * G::R;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lr = lane / G::LC, lc = lane % G::LC;
  const int col = 4 * (warp * G::LC + lc);  // the thread's first column
  const int c0 = rank * G::Nc;            // the slice's first column

  for (int i = tid; i < N * G::Nc; i += kThreads) {
    const int k = i / G::Nc, j = i % G::Nc;
    bs[i] = widen(b[(long long)k * N + c0 + j]);
  }
  for (int i = tid; i < G::R * N; i += kThreads) {
    const int r = i / N, k = i % N;
    cbuf[r * G::P + k] =
        row0 + r < M ? widen(a[(row0 + r) * N + k]) : 0.0f;
  }
  // every block loaded, and running, before any block writes into it
  cluster.sync();

  for (int it = 0; it < n_iter; ++it) {
    const float* cur = cbuf + (it & 1) * G::R * G::P;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    // the operands of a group of 4 k, loaded a group ahead into the other
    // of two register sets (past the last k the loads read the rows'
    // padding and the buffers after B's slice, and are not used)
    Operands<G> op[2];
    op[0].load(cur, bs, lr, col, 0);
#pragma unroll 2
    for (int k = 0; k < N; k += 8) {
      op[1].load(cur, bs, lr, col, k + 4);
      op[0].fma(acc);
      op[0].load(cur, bs, lr, col, k + 8);
      op[1].fma(acc);
    }
    const bool last = it + 1 == n_iter;
    float* nxt = cbuf + ((it + 1) & 1) * G::R * G::P;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = lr + G::LR * i;
      {
        const float4 v = make_float4(__fmul_rn(acc[i][0], decay),
                                     __fmul_rn(acc[i][1], decay),
                                     __fmul_rn(acc[i][2], decay),
                                     __fmul_rn(acc[i][3], decay));
        const int j = c0 + col;
        if (last) {
          if (row0 + r < M)
            *reinterpret_cast<float4*>(out + (row0 + r) * N + j) = v;
        } else {
          for (int d = 0; d < C; ++d)
            *reinterpret_cast<float4*>(
                cluster.map_shared_rank(nxt + r * G::P + j, d)) = v;
        }
      }
    }
    // the next buffer is whole in every block, and no block reads this
    // one any more; after the last step no block writes into another
    if (!last) cluster.sync();
  }
  if (n_iter == 0) {
    for (int i = tid; i < G::R * G::Nc; i += kThreads) {
      const int r = i / G::Nc, j = c0 + i % G::Nc;
      if (row0 + r < M) out[(row0 + r) * N + j] = cbuf[r * G::P + j];
    }
  }
}

template <int N, int C, typename TA, typename TB>
int launch_cluster(const void* a, const void* b, void* out, int M,
                   int n_iter, float decay, cudaStream_t stream) {
  using G = Geometry<N, C>;
  auto kernel = ballast_cluster_kernel<N, C, TA, TB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::smem);
  if (err != cudaSuccess) return (int)err;
  const long long clusters = ((long long)M + G::R - 1) / G::R;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * C), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = G::smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const TA*)a, (const TB*)b,
                           (float*)out, M, n_iter, decay);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the cluster geometries: (N, c)
#define BALLAST_GEOMETRIES(X) X(64, 1) X(128, 2) X(256, 2)

template <typename TA, typename TB>
int dispatch_cluster(const void* a, const void* b, void* out, int M, int N,
                     int c, int n_iter, float decay, cudaStream_t s) {
#define BALLAST_DISPATCH(NN, CC)                                            \
  if (N == NN && c == CC)                                                   \
    return launch_cluster<NN, CC, TA, TB>(a, b, out, M, n_iter, decay, s);
  BALLAST_GEOMETRIES(BALLAST_DISPATCH)
#undef BALLAST_DISPATCH
  return (int)cudaErrorInvalidValue;
}

size_t cluster_smem(int N, int c) {
#define BALLAST_SMEM(NN, CC) \
  if (N == NN && c == CC) return Geometry<NN, CC>::smem;
  BALLAST_GEOMETRIES(BALLAST_SMEM)
#undef BALLAST_SMEM
  return 0;
}

// ---------------------------------------------------------------------------
// route "stream"
// ---------------------------------------------------------------------------

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
int launch_stream(const void* a, const void* b, void* out, int M, int N,
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

template <typename TA, typename TB>
int launch(const void* a, const void* b, void* out, int M, int N, int c,
           int n_iter, float decay, cudaStream_t s) {
  return c > 0 ? dispatch_cluster<TA, TB>(a, b, out, M, N, c, n_iter, decay,
                                          s)
               : launch_stream<TA, TB>(a, b, out, M, N, n_iter, decay, s);
}

template <typename TA>
int launch_b(const void* a, const void* b, void* out, int M, int N, int c,
             int n_iter, float decay, int b_bf16, cudaStream_t s) {
  return b_bf16 ? launch<TA, __nv_bfloat16>(a, b, out, M, N, c, n_iter,
                                            decay, s)
                : launch<TA, float>(a, b, out, M, N, c, n_iter, decay, s);
}

}  // namespace

// a_bf16, b_bf16: 0 for a float32 operand, 1 for bfloat16.  cluster: 0 for
// route "stream", else the cluster size c of route "cluster" (an (N, c)
// that cluster_smem knows).
extern "C" int ballast_launch(const void* a, const void* b, void* out,
                              int M, int N, int n_iter, float decay,
                              int a_bf16, int b_bf16, int cluster,
                              void* stream) {
  if (M <= 0 || N <= 0 || N > 1024 || N % 4 || n_iter < 0 || cluster < 0)
    return (int)cudaErrorInvalidValue;
  if (cluster > 0 && cluster_smem(N, cluster) == 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return a_bf16 ? launch_b<__nv_bfloat16>(a, b, out, M, N, cluster, n_iter,
                                          decay, b_bf16, st)
                : launch_b<float>(a, b, out, M, N, cluster, n_iter, decay,
                                  b_bf16, st);
}

// the dynamic shared memory a block of route "cluster" takes at (N, c), in
// bytes; 0 where the route has no such geometry
extern "C" long long ballast_cluster_smem(int N, int cluster) {
  return (long long)cluster_smem(N, cluster);
}

// how many clusters of (N, c) the card holds at once (f32 operands), or a
// negative CUDA error
extern "C" int ballast_cluster_occupancy(int N, int cluster) {
  int active = 0;
  cudaError_t err = cudaErrorInvalidValue;
#define BALLAST_OCC(NN, CC)                                                  \
  if (N == NN && cluster == CC) {                                            \
    using G = Geometry<NN, CC>;                                              \
    auto k = ballast_cluster_kernel<NN, CC, float, float>;                   \
    cudaLaunchConfig_t cfg = {};                                             \
    cfg.gridDim = dim3(CC, 1, 1);                                            \
    cfg.blockDim = dim3(kThreads, 1, 1);                                     \
    cfg.dynamicSmemBytes = G::smem;                                          \
    cudaLaunchAttribute attr[1];                                             \
    attr[0].id = cudaLaunchAttributeClusterDimension;                        \
    attr[0].val.clusterDim.x = CC;                                           \
    attr[0].val.clusterDim.y = 1;                                            \
    attr[0].val.clusterDim.z = 1;                                            \
    cfg.attrs = attr;                                                        \
    cfg.numAttrs = 1;                                                        \
    err = cudaFuncSetAttribute(                                              \
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::smem);       \
    if (err == cudaSuccess)                                                  \
      err = cudaOccupancyMaxActiveClusters(&active, k, &cfg);                \
  }
  BALLAST_GEOMETRIES(BALLAST_OCC)
#undef BALLAST_OCC
  return err == cudaSuccess ? active : -(int)err;
}
