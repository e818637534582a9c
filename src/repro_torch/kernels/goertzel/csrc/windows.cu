// Goertzel resonators on disjoint windows: kernel H of the port.
//
// Replaces the reference's Pallas kernel goertzel_pallas
// (src/repro/kernels/goertzel/goertzel.py:87, body _goertzel_kernel at :67).
// For window w of windows [W, win] f32 and coefficient coef[k] =
// 2 cos(2 pi f_k dt):
//   s0 = x[t] + coef_k s1 - s2,  t = 0 .. win-1, from s1 = s2 = 0,
//   out[w, k] = 2/win sqrt(max(s1 s1 + s2 s2 - coef_k s1 s2, 0)),
// rounded as the reference runs as XLA compiles it, which contracts each
// product-and-sum into one FMA: s0 = fma(coef_k, s1, x) - s2 and power =
// fma(-(coef_k s1), s2, fma(s1, s1, s2 s2)) (JAX's goertzel_pallas in
// interpret mode equals this bit for bit on the CPU).  Each step is
// written with explicit intrinsics (__fmaf_rn, __fsub_rn, __fmul_rn), so
// nvcc's own contraction cannot change a bit, and the plain version
// (fma32 in windows.py) takes the same steps.
//
// Bound on this card: bytes, W win 4 read and W K 4 written: about 0.7 us
// for the 600 s 1 kHz trace (152 windows of 4000, K 7), 0.103 ms for a day
// of it (21 600 windows).  But each (window, bin) is a chain of win
// dependent steps, an FFMA and then an FADD, in the reference's rounding
// order; a parallel form (a scan of 2x2 transfer matrices over segments)
// would land about as far from that float32 chain as the reference is
// from float64, so the chain stays serial.  Where the W K chains are far
// fewer than the card's issue slots, as at the entry point's shapes, the
// least time is the chain floor: win times one step's latency, which
// goertzel_step_cycles below measures.
//
// Design.  One lane a (window, bin) chain.  A warp takes a task, per_warp
// windows and up to 32 of their bins, and walks it alone: it streams its
// windows' rows through a ring of kStages slots of its own in shared
// memory with cp.async, kStages - 1 stages ahead of the stage it walks,
// waits only for the stage it is about to read (its lanes' copies, then
// __syncwarp), and refills a slot as soon as it has walked it.  No
// barrier is wider than the warp.  Within a stage a lane reads its row 16
// samples ahead of the chain (four 16-byte reads, on one address across
// the lanes of a window), in two register buffers used in turn, so loads,
// addresses and loop control stay off the chain.  windows.py chooses the
// geometry (windows_route): "chain", one window a warp and one warp a
// block, the whole window in flight at once for win <= 4096, where the
// chains are few (the windows spread over the SMs, each chain at its
// floor); "packed", floor(32 / K) windows a warp and several warps a
// block with 2 KB stages, where many windows make the bytes the bound.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kStages = 4;        // ring slots a warp
constexpr int kChunk = 16;        // samples a register buffer holds
// floats after each staged row: room for the read one buffer past a
// row's last sample, and rows 20 (mod 32) floats apart, so that the rows
// a warp reads at one offset sit in distinct groups of 4 banks
constexpr int kPad = 20;
constexpr int kMaxWarps = 8;      // warps a block
constexpr size_t kMaxSmem = 48 * 1024;  // a block's, without an opt-in
constexpr int kProbeLen = 2048;   // samples goertzel_step_cycles walks

struct Geometry {
  long long W, tasks;  // windows; tasks, ceil(W / per_warp) groups
  int win, K;
  int per_warp;        // windows a task
  int bins;            // bins a task, min(K, 32)
  int groups;          // tasks a window, ceil(K / 32)
  int stage, stride;   // samples a stage (a multiple of 2 kChunk), + kPad
  int nstages;         // ceil(win / stage)
  bool vec;            // 16-byte copies: win % 4 == 0, windows aligned
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// all but the newest N of this lane's cp.async groups have landed; then
// the warp's other lanes' copies too
template <int N>
__device__ __forceinline__ void landed() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  __syncwarp();
}

// copy stage s of the task's rows (windows w0 .. w0 + rows - 1) into ring
// slot s % kStages and close one cp.async group, an empty one past the
// last stage, so that the task's group s is its stage s
__device__ __forceinline__ void load_stage(float* ring, const float* x,
                                           const Geometry& g, long long w0,
                                           int rows, int s, int lane) {
  if (s < g.nstages) {
    const int t0 = s * g.stage;
    const int len = min(g.stage, g.win - t0);
    float* dst = ring + (size_t)(s % kStages) * g.per_warp * g.stride;
    const float* src = x + w0 * g.win + t0;
    for (int r = 0; r < rows; ++r, dst += g.stride, src += g.win) {
      if (g.vec) {
        for (int c = 4 * lane; c < len; c += 4 * kLanes)
          cp_async16(dst + c, src + c);
      } else {
        for (int c = lane; c < len; c += kLanes) cp_async4(dst + c, src + c);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void read16(float (&v)[kChunk], const float* p) {
#pragma unroll
  for (int i = 0; i < kChunk; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[i] = q.x;
    v[i + 1] = q.y;
    v[i + 2] = q.z;
    v[i + 3] = q.w;
  }
}

__device__ __forceinline__ void step(float c, float x, float& s1,
                                     float& s2) {
  const float s0 = __fsub_rn(__fmaf_rn(c, s1, x), s2);
  s2 = s1;
  s1 = s0;
}

__device__ __forceinline__ void walk16(float c, const float (&v)[kChunk],
                                       float& s1, float& s2) {
#pragma unroll
  for (int i = 0; i < kChunk; ++i) step(c, v[i], s1, s2);
}

// the first n <= kChunk samples of v
__device__ __forceinline__ void walk_n(float c, const float (&v)[kChunk],
                                       int n, float& s1, float& s2) {
#pragma unroll
  for (int i = 0; i < kChunk; ++i)
    if (i < n) step(c, v[i], s1, s2);
}

// the chain over the n <= stage samples of a staged row at p, each buffer
// read while the other is walked.  p advances by 2 kChunk from the row's
// start and stage is a multiple of 2 kChunk, so no read reaches past the
// row's stage + kChunk floats; the floats past n a read brings are not
// walked
__device__ __forceinline__ void walk_row(float c, const float* p, int n,
                                         float& s1, float& s2) {
  float a[kChunk], b[kChunk];
  read16(a, p);
  for (; n >= 2 * kChunk; n -= 2 * kChunk, p += 2 * kChunk) {
    read16(b, p + kChunk);
    walk16(c, a, s1, s2);
    read16(a, p + 2 * kChunk);
    walk16(c, b, s1, s2);
  }
  if (n > 0) {
    walk_n(c, a, min(n, kChunk), s1, s2);
    if (n > kChunk) {
      read16(b, p + kChunk);
      walk_n(c, b, n - kChunk, s1, s2);
    }
  }
}

__global__ void __launch_bounds__(kMaxWarps* kLanes)
    windows_kernel(const float* __restrict__ x,
                   const float* __restrict__ coef, float* __restrict__ out,
                   Geometry g) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int warps = blockDim.x / kLanes;
  float* ring = smem + (size_t)warp * kStages * g.per_warp * g.stride;
  const int j = lane / g.bins;             // the lane's window in a task
  const int kk = lane - j * g.bins;        // its bin in the task's group
  const int jr = j < g.per_warp ? j : 0;   // the row an idle lane reads
  const float scale = (float)(2.0 / (double)g.win);
  for (long long task = (long long)blockIdx.x * warps + warp;
       task < g.tasks; task += (long long)gridDim.x * warps) {
    const long long wg = task / g.groups;
    const int k = (int)(task - wg * g.groups) * kLanes + kk;
    const long long w0 = wg * g.per_warp;
    const int rows = (int)min((long long)g.per_warp, g.W - w0);
    const bool active = j < rows && k < g.K;
    const float c = coef[active ? k : 0];
    __syncwarp();  // the warp has walked the previous task's ring
    for (int s = 0; s < kStages; ++s) load_stage(ring, x, g, w0, rows, s, lane);
    float s1 = 0.f, s2 = 0.f;
    for (int s = 0; s < g.nstages; ++s) {
      landed<kStages - 1>();  // stage s
      const float* row = ring + ((size_t)(s % kStages) * g.per_warp + jr) *
                                    g.stride;
      walk_row(c, row, min(g.stage, g.win - s * g.stage), s1, s2);
      __syncwarp();  // every lane has walked slot s % kStages: refill it
      load_stage(ring, x, g, w0, rows, s + kStages, lane);
    }
    if (active) {
      const float power = __fmaf_rn(-__fmul_rn(c, s1), s2,
                                    __fmaf_rn(s1, s1, __fmul_rn(s2, s2)));
      out[(w0 + j) * g.K + k] = __fmul_rn(scale, sqrtf(fmaxf(power, 0.f)));
    }
  }
}

// lane 0 walks bin 0's chain over the first len samples of row 0, staged
// in shared memory, reps times, with the kernel's walk_row; cycles[0] = SM
// cycles in all
__global__ void step_cycles_kernel(const float* __restrict__ x,
                                   const float* __restrict__ coef, int len,
                                   int reps, long long* __restrict__ cycles,
                                   float* __restrict__ sink) {
  __shared__ __align__(16) float xs[kProbeLen + kPad];
  for (int i = threadIdx.x; i < kProbeLen + kPad; i += kLanes)
    xs[i] = i < len ? x[i] : 0.0f;
  __syncwarp();
  if (threadIdx.x != 0) return;
  const float c = coef[0];
  float acc = 0.0f;
  const long long t0 = clock64();
  for (int r = 0; r < reps; ++r) {
    float s1 = 0.f, s2 = 0.f;
    walk_row(c, xs, len, s1, s2);
    acc += s1;
  }
  const long long t1 = clock64();
  cycles[0] = t1 - t0;
  sink[0] = acc;
}

}  // namespace

// out [W, K] = the amplitudes of windows [W, win] at coef [K], at the
// geometry windows.py's windows_route chose: per_warp windows a warp,
// stage samples a ring slot's row, warps a block, blocks (each warp takes
// tasks blockIdx * warps + warp, then every gridDim * warps-th).  Refuses
// (cudaErrorInvalidValue) a geometry the kernel does not take.
extern "C" int windows_launch(const void* windows, const void* coef,
                              void* out, int W, int win, int K, int per_warp,
                              int stage, int warps, int blocks,
                              void* stream) {
  if (W <= 0 || win <= 0 || K <= 0 || per_warp <= 0 ||
      stage < 2 * kChunk || stage % (2 * kChunk) || warps <= 0 ||
      warps > kMaxWarps || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.W = W;
  g.win = win;
  g.K = K;
  g.per_warp = per_warp;
  g.bins = K < kLanes ? K : kLanes;
  g.groups = (K + kLanes - 1) / kLanes;
  g.stage = stage;
  g.stride = stage + kPad;
  g.nstages = (win + stage - 1) / stage;
  g.tasks = ((long long)W + per_warp - 1) / per_warp * g.groups;
  g.vec = win % 4 == 0 && reinterpret_cast<uintptr_t>(windows) % 16 == 0;
  const size_t smem =
      sizeof(float) * (size_t)warps * kStages * per_warp * g.stride;
  if (per_warp * g.bins > kLanes || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  windows_kernel<<<blocks, warps * kLanes, smem, (cudaStream_t)stream>>>(
      (const float*)windows, (const float*)coef, (float*)out, g);
  return (int)cudaGetLastError();
}

// cycles[0] = SM cycles of reps walks of min(n, 2048) samples (cut to a
// multiple of 32) of one chain (see step_cycles_kernel): a probe of the
// chain's own time a step
extern "C" int goertzel_step_cycles(const void* windows, const void* coef,
                                    int n, int reps, void* cycles,
                                    void* sink, void* stream) {
  const int len = (n < kProbeLen ? n : kProbeLen) & ~(2 * kChunk - 1);
  if (len <= 0 || reps <= 0) return (int)cudaErrorInvalidValue;
  step_cycles_kernel<<<1, kLanes, 0, (cudaStream_t)stream>>>(
      (const float*)windows, (const float*)coef, len, reps,
      (long long*)cycles, (float*)sink);
  return (int)cudaGetLastError();
}
