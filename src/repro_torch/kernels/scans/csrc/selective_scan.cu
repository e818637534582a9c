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
// a fused multiply-add), in the reference's order; y's sum is split over
// the two lanes of a channel, each summing its half of the states in
// order, and the halves are added once, states 0 .. ds / 2 - 1 first.
// A step's arithmetic does not depend on where its call or tile begins,
// so calls that carry h_last into h0 equal one call bit for bit.  expf is
// the library's (no --use_fast_math).
//
// Bound on this card: at jamba's prefill shape (4 x 4096 steps, di 8192,
// ds 16) the bytes are xi (bf16), dt and ys (f32), about 1.34 GB (0.40
// ms).  Each (b, t, d, s) element takes 7 f32 operations that may not be
// fused, an issue floor of 0.45 ms at one instruction a clock a lane
// (33.45 T/s), and one expf: the library's is 6 more f32 instructions, a
// shift and one MUFU.EX2, so the compiled step loop's 13 f32 instructions
// an element set a floor of 0.83 ms and all its instructions, about 16.6
// an element, one of 1.06 ms (chip_smoke.py counts them in the SASS); the
// special function units' floor is 0.51 ms (2.15 G ex2 at 16 a clock an
// SM).  The time axis is a dependent chain, but a chain of one multiply
// and one add a state, and channels are independent.
//
// Design: kLanes = 2 lanes take one (b, d), each with its half of the
// states and of d's row of A in registers: 2048 warps at jamba's shape
// where one thread a channel gave 1024, too few to hide the expf's and the
// shared memory's latency (4 lanes a channel ran 1.764-1.785 ms against
// 1.678-1.688 at jamba's prefill shape).  A block of 2 kChannels lanes
// stages each tile of kTile steps of B and C (the same for every channel
// of a row) and of its channels' x and dt in shared memory through a ring
// of kStages tiles with cp.async copies (16 bytes where d_inner is a
// multiple of 8, else 4), one loop a tensor indexed by shifts, the next
// tile in flight while this one computes; bf16 B and C are widened to f32
// once a tile for the whole block.  Each lane writes its partial y of a
// step to shared memory, and once a tile the block adds a channel's two
// sums and stores y.  A whole tile's steps run kUnroll = 4 at a time
// unguarded, so the compiler overlaps consecutive steps (the whole tile
// unrolled ran 1.708-1.725 ms); a partial last tile runs step by step.
// Channels past di (a ragged edge) only help stage the tile.  Built for
// d_state 8 and 16 (Mamba's and its reduced configurations'), in f32 and
// bf16 (bf16 with an even d_inner: a 4-byte copy holds two channels).
//
// Layouts (row major, contiguous, 16-byte aligned): xi, dt, ys [B, T, di];
// Bc, Cc [B, T, ds]; A [di, ds]; h0, h_last [B, di, ds].
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kChannels = 64;  // channels a block
constexpr int kLanes = 2;      // lanes a channel
constexpr int kUnroll = 4;     // steps of a whole tile unrolled together
constexpr int kTile = 16;      // time steps a tile
constexpr int kStages = 2;     // tiles in the ring

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest N cp.async groups this thread committed have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N consecutive floats of shared memory, in the widest loads their
// alignment allows (16 bytes where N is a multiple of 4)
template <int N>
__device__ __forceinline__ void read_floats(float* out, const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      out[i] = q.x;
      out[i + 1] = q.y;
      out[i + 2] = q.z;
      out[i + 3] = q.w;
    }
  } else {
    static_assert(N % 2 == 0, "read_floats: pairs");
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + i);
      out[i] = q.x;
      out[i + 1] = q.y;
    }
  }
}

template <typename T, int DS>
struct Smem {
  static constexpr bool kWiden = !std::is_same<T, float>::value;
  struct Stage {
    T b[kTile][DS];
    T c[kTile][DS];
    T x[kTile][kChannels];
    float dt[kTile][kChannels];
  };
  Stage ring[kStages];
  // B and C widened to f32 (bf16 inputs; f32 ones are read in the ring)
  float bf[kWiden ? kTile : 1][DS];
  float cf[kWiden ? kTile : 1][DS];
  // the lanes' partial sums of y: [step][channel][lane of the channel]
  float part[kTile][kChannels][kLanes];
};

template <typename T, int DS>
__global__ void __launch_bounds__(kLanes * kChannels)
selective_scan_kernel(const T* __restrict__ xi, const float* __restrict__ dt,
                      const T* __restrict__ Bc, const T* __restrict__ Cc,
                      const float* __restrict__ A,
                      const float* __restrict__ h0, float* __restrict__ ys,
                      float* __restrict__ h_last, int steps, int di,
                      int vec) {
  constexpr int kThreads = kLanes * kChannels;
  constexpr int kS = DS / kLanes;      // states a lane
  constexpr int kEl = 16 / sizeof(T);  // elements of x, B or C a copy
  constexpr int kEl4 = 4 / sizeof(T);  // elements of x a 4-byte copy
  static_assert(DS % kEl == 0 && DS % kLanes == 0 && kS % 2 == 0 &&
                    kTile % kUnroll == 0,
                "selective_scan: geometry");
  using S_t = Smem<T, DS>;
  static_assert(sizeof(S_t) <= 48 * 1024,
                "selective_scan: static shared memory");
  __shared__ __align__(16) unsigned char smem[sizeof(S_t)];
  S_t& sm = *reinterpret_cast<S_t*>(smem);

  const int tid = threadIdx.x;
  const int cl = tid / kLanes, q = tid % kLanes;  // channel, its lane
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int nc = min(kChannels, di - d0);  // the block's channels
  const bool live = cl < nc;
  const int d = live ? d0 + cl : d0;
  const int s0 = q * kS;  // the lane's first state
  float a[kS], h[kS];
#pragma unroll
  for (int m = 0; m < kS; ++m) {
    a[m] = live ? A[(size_t)d * DS + s0 + m] : 0.0f;
    h[m] = live ? h0[((size_t)b * di + d) * DS + s0 + m] : 0.0f;
  }
  const size_t row = (size_t)b * steps;  // this row's first step

  // tile t's B, C, x and dt into ring slot t % kStages, one cp.async group
  // (an empty one past the last tile)
  auto load = [&](int t) {
    const int t0 = t * kTile, n = max(0, min(kTile, steps - t0));
    typename S_t::Stage& st = sm.ring[t % kStages];
    // one loop a tensor, each copy's step and offset by shifts (the
    // counts a step are powers of two); copies past the block's nc
    // channels (a ragged edge) are skipped
    constexpr int kBC = DS / kEl;  // copies of a step's B (and C)
    for (int e = tid; e < n * kBC; e += kThreads) {
      const size_t f = (row + t0) * DS + e * kEl;
      cp_async16(&st.b[0][0] + e * kEl, Bc + f);
      cp_async16(&st.c[0][0] + e * kEl, Cc + f);
    }
    const size_t g = (row + t0) * di + d0;
    if (vec) {
      constexpr int kX = kChannels / kEl, kD = kChannels / 4;
      for (int e = tid; e < n * kX; e += kThreads) {
        const int s = e / kX, c = (e % kX) * kEl;
        if (c < nc) cp_async16(&st.x[s][c], xi + g + (size_t)s * di + c);
      }
      for (int e = tid; e < n * kD; e += kThreads) {
        const int s = e / kD, c = (e % kD) * 4;
        if (c < nc) cp_async16(&st.dt[s][c], dt + g + (size_t)s * di + c);
      }
    } else {
      constexpr int kX = kChannels / kEl4;
      for (int e = tid; e < n * kX; e += kThreads) {
        const int s = e / kX, c = (e % kX) * kEl4;
        if (c < nc) cp_async4(&st.x[s][c], xi + g + (size_t)s * di + c);
      }
      for (int e = tid; e < n * kChannels; e += kThreads) {
        const int s = e / kChannels, c = e % kChannels;
        if (c < nc) cp_async4(&st.dt[s][c], dt + g + (size_t)s * di + c);
      }
    }
    cp_async_commit();
  };
  // tile t's y: each channel's kLanes partial sums added in lane order
  // (states 0 .. ds / kLanes - 1 first), a channel a thread
  auto store_y = [&](int t) {
    const int t0 = t * kTile, n = min(kTile, steps - t0);
    float* out = ys + (row + t0) * di + d0;
    for (int e = tid; e < n * kChannels; e += kThreads) {
      const int s = e / kChannels, c = e % kChannels;
      if (c < nc) {
        float p[kLanes];
        read_floats<kLanes>(p, &sm.part[s][c][0]);
        float acc = p[0];
#pragma unroll
        for (int l = 1; l < kLanes; ++l) acc = __fadd_rn(acc, p[l]);
        out[(size_t)s * di + c] = acc;
      }
    }
  };

  const int tiles = (steps + kTile - 1) / kTile;
  for (int t = 0; t < kStages - 1; ++t) load(t);
  for (int t = 0; t < tiles; ++t) {
    const int n = min(kTile, steps - t * kTile);
    cp_async_wait<kStages - 2>();
    // tile t has landed; tile t - 1 is read (its slot is free for tile t +
    // kStages - 1) and its partial sums are in
    __syncthreads();
    if (t > 0) store_y(t - 1);
    load(t + kStages - 1);
    const typename S_t::Stage& st = sm.ring[t % kStages];
    const float* bs;
    const float* cs;
    if constexpr (S_t::kWiden) {
      const int pairs = n * DS / 2;
      for (int e = tid; e < 2 * pairs; e += kThreads) {
        const bool isc = e >= pairs;
        const int f = isc ? e - pairs : e;
        const __nv_bfloat162 two = reinterpret_cast<const __nv_bfloat162*>(
            isc ? &st.c[0][0] : &st.b[0][0])[f];
        reinterpret_cast<float2*>(isc ? &sm.cf[0][0] : &sm.bf[0][0])[f] =
            __bfloat1622float2(two);
      }
      bs = &sm.bf[0][0];
      cs = &sm.cf[0][0];
    } else {
      bs = &st.b[0][0];
      cs = &st.c[0][0];
    }
    __syncthreads();  // the widened tile is written; the sums are read
    // step j of the tile: the lane's states and its part of y
    auto step = [&](int j) {
      const float xv = f32(st.x[j][cl]);
      const float dv = st.dt[j][cl];
      float bb[kS], cc[kS];
      read_floats<kS>(bb, bs + j * DS + s0);
      read_floats<kS>(cc, cs + j * DS + s0);
      float yv = 0.0f;
#pragma unroll
      for (int m = 0; m < kS; ++m) {
        const float dA = expf(__fmul_rn(dv, a[m]));
        const float dBx = __fmul_rn(__fmul_rn(dv, bb[m]), xv);
        h[m] = __fadd_rn(__fmul_rn(dA, h[m]), dBx);
        yv = __fadd_rn(yv, __fmul_rn(h[m], cc[m]));
      }
      sm.part[j][cl][q] = yv;
    };
    if (n == kTile) {  // a whole tile: kUnroll steps at a time, unguarded
#pragma unroll 1
      for (int j0 = 0; j0 < kTile; j0 += kUnroll) {
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) step(j0 + j);
      }
    } else {
#pragma unroll 1
      for (int j = 0; j < n; ++j) step(j);
    }
  }
  __syncthreads();
  store_y(tiles - 1);
  if (live) {
#pragma unroll
    for (int m = 0; m < kS; ++m)
      h_last[((size_t)b * di + d) * DS + s0 + m] = h[m];
  }
}

template <typename T, int DS>
int launch(const void* xi, const void* dt, const void* Bc, const void* Cc,
           const void* A, const void* h0, void* ys, void* h_last, int B,
           int steps, int di, cudaStream_t stream) {
  dim3 grid((di + kChannels - 1) / kChannels, B);
  selective_scan_kernel<T, DS><<<grid, kLanes * kChannels, 0, stream>>>(
      (const T*)xi, (const float*)dt, (const T*)Bc, (const T*)Cc,
      (const float*)A, (const float*)h0, (float*)ys, (float*)h_last, steps,
      di, di % 8 == 0);
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

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

}  // namespace

// bf16 != 0: xi, Bc and Cc are bf16, else f32.  ds must be 8 or 16, di
// even in bf16, and every operand 16-byte aligned (the wrapper refuses any
// other before it gets here).
extern "C" int selective_scan_launch(const void* xi, const void* dt,
                                     const void* Bc, const void* Cc,
                                     const void* A, const void* h0, void* ys,
                                     void* h_last, int B, int steps, int di,
                                     int ds, int bf16, void* stream) {
  if (B <= 0 || B > 65535 || steps <= 0 || di <= 0 || (bf16 && di % 2))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(xi) || !aligned16(dt) || !aligned16(Bc) ||
      !aligned16(Cc) || !aligned16(ys))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_ds<__nv_bfloat16>(ds, xi, dt, Bc, Cc, A, h0, ys, h_last, B,
                                    steps, di, s);
  return launch_ds<float>(ds, xi, dt, Bc, Cc, A, h0, ys, h_last, B, steps,
                          di, s);
}
