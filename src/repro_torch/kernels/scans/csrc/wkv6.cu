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
// own (__fmul_rn, __fadd_rn: never contracted).  y_j's sum over i is split
// over the G lanes of column j: each sums its key channels in order, and
// the G partial sums are added in lane order, each add __fadd_rn.  A
// step's arithmetic does not depend on where its call or tile begins, so
// calls that carry S_last into S0 equal one call bit for bit.
//
// Bound on this card: at rwkv6-3b's prefill shape (4 x 4096 steps, 40
// heads of 64) the bytes are r, k, v (bf16), w and y (f32), about 0.59 GB
// (0.18 ms), and the operations 7 hd^2 a (b, h, step), 18.8 G.  No product
// may be fused with its sum, so each is an instruction of its own: 128 a
// clock an SM, 33.45 T/s at 1.98 GHz, an issue floor of 0.562 ms, which
// bounds the kernel (the 67 TFLOP/s peak counts fused multiply-adds); the
// compiled step loop issues about 9.7 instructions an element (its loads,
// widening and stores besides the 7), a floor of 0.78 ms.  The only chain
// carried from step to step is S = w S + kv, a multiply and an add; y is
// not carried.
//
// Design: each lane holds an RI x CJ tile of S (RI key channels, CJ value
// channels or columns) and its RI values of u in registers, so a step
// reads 3 RI + CJ values of shared memory for 7 RI CJ operations (a lane
// a column reads 3 R + 1 for 7 R).  A column's G = hd / RI lanes are
// neighbours; a lane's key channels come in chunks of 4, chunk n of lane
// g being n G + g, so neighbouring lanes read contiguous bytes.  Each
// lane writes its CJ partial sums of a step to shared memory, and once a
// tile the block adds them, a column's G sums in lane order, and stores y
// 16 bytes a lane: no shuffle chain waits at the end of every step.  A
// block takes JC columns of one (b, h): at rwkv6-3b's shape 640 blocks of
// 64 threads, 4 or 5 an SM (one block a head, 160 blocks, loads 28 of the
// 132 SMs twice).  The block stages each tile of kTile steps of r, k, w
// and its columns of v in shared memory through a ring of kStages tiles
// with 16-byte cp.async copies, one loop a tensor indexed by shifts, the
// next tile in flight while this one computes; bf16 values are widened
// where a lane reads them.  The step loop is unrolled by 2 (consecutive
// steps overlap); a lane's tile is unrolled whole.  The geometry (RI, CJ,
// JC) is chosen here for each head dim (launch_hd).
//
// Layouts (row major, contiguous, 16-byte aligned): r, k, v, w, y [B, T,
// H, hd]; u [H, hd]; S0, S_last [B, H, hd, hd] (key channel, then value
// channel).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kTile = 16;   // time steps a tile
constexpr int kStages = 2;  // tiles in the ring: this one and the next

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
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
__device__ __forceinline__ void read_rows(float* out, const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      out[i] = q.x;
      out[i + 1] = q.y;
      out[i + 2] = q.z;
      out[i + 3] = q.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + i);
      out[i] = q.x;
      out[i + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

// N consecutive values of shared memory as floats: f32 ones as read_rows
// reads them, bf16 ones 2, 4 or 8 a load, each widened on its own
template <int N>
__device__ __forceinline__ void read_vals(float* out, const float* p) {
  read_rows<N>(out, p);
}
template <int N>
__device__ __forceinline__ void read_vals(float* out,
                                          const __nv_bfloat16* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const uint2 q = *reinterpret_cast<const uint2*>(p + i);
      const float2 lo = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&q.x));
      const float2 hi = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&q.y));
      out[i] = lo.x;
      out[i + 1] = lo.y;
      out[i + 2] = hi.x;
      out[i + 3] = hi.y;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 two = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p + i));
      out[i] = two.x;
      out[i + 1] = two.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __bfloat162float(p[i]);
  }
}

template <typename T, int HD, int JC, int G>
struct Smem {
  struct Stage {
    T r[kTile][HD];
    T k[kTile][HD];
    float w[kTile][HD];
    T v[kTile][JC];  // the block's columns
  };
  Stage ring[kStages];
  // the lanes' partial sums of y, [step][column][lane of the column]: a
  // column's G sums padded by 4 floats, so the pass that adds them reads
  // 16 bytes a lane without bank conflicts
  float part[kTile][JC][G + 4];
};

template <typename T, int HD, int RI, int CJ, int JC>
__global__ void __launch_bounds__(JC / CJ * HD / RI)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ S0,
            float* __restrict__ y, float* __restrict__ S_last, int steps,
            int H) {
  constexpr int kG = HD / RI;              // lanes a column
  constexpr int kThreads = JC / CJ * kG;
  constexpr int kQ = RI < 4 ? RI : 4;      // key channels a chunk
  constexpr int kN = RI / kQ;              // chunks a lane
  constexpr int kEl = 16 / sizeof(T);      // elements of r, k or v a copy
  constexpr int kR = HD / kEl;             // copies of a step's r (and k)
  constexpr int kW = HD / 4;               // copies of a step's w
  constexpr int kV = JC / kEl;             // copies of a step's v
  constexpr int kY = JC / 4;               // 16-byte stores of a step's y
  static_assert(32 % kG == 0 && kG % 4 == 0 && JC % CJ == 0 &&
                    HD % JC == 0 && JC % kEl == 0 && HD % kEl == 0,
                "wkv6: geometry");
  using S_t = Smem<T, HD, JC, kG>;
  static_assert(sizeof(S_t) <= 48 * 1024, "wkv6: static shared memory");
  __shared__ __align__(16) unsigned char smem[sizeof(S_t)];
  S_t& sm = *reinterpret_cast<S_t*>(smem);

  const int tid = threadIdx.x;
  const int g = tid % kG;                  // the lane's key chunks g, g + kG..
  const int c0 = (tid / kG) * CJ;          // its first column in the block
  const int bh = blockIdx.x / (HD / JC);   // b * H + h
  const int j0 = (blockIdx.x % (HD / JC)) * JC;  // the block's first column
  const int b = bh / H, h = bh % H;
  const size_t stride = (size_t)H * HD;                  // one step
  const size_t base = ((size_t)b * steps * H + h) * HD;  // (b, 0, h, 0)

  // S[n kQ + e][c]: key channel (n kG + g) kQ + e, column c0 + c
  float S[RI][CJ], uu[RI];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int e = 0; e < kQ; ++e) {
      const int i = (n * kG + g) * kQ + e;
      uu[n * kQ + e] = u[h * HD + i];
#pragma unroll
      for (int c = 0; c < CJ; ++c)
        S[n * kQ + e][c] = S0[((size_t)bh * HD + i) * HD + j0 + c0 + c];
    }
  }

  // tile t's r, k, w and v into ring slot t % kStages, one cp.async group
  // (an empty one past the last tile)
  auto load = [&](int t) {
    const int t0 = t * kTile, n = max(0, min(kTile, steps - t0));
    typename S_t::Stage& st = sm.ring[t % kStages];
    const size_t g0 = base + (size_t)t0 * stride;
    // one loop a tensor, each copy's step and offset by shifts (kR, kW
    // and kV are powers of two): no lane branches away from its warp
    for (int e = tid; e < n * kR; e += kThreads) {
      const int s = e / kR, c = (e % kR) * kEl;
      const size_t gs = g0 + (size_t)s * stride + c;
      cp_async16(&st.r[s][c], r + gs);
      cp_async16(&st.k[s][c], k + gs);
    }
    for (int e = tid; e < n * kW; e += kThreads) {
      const int s = e / kW, c = (e % kW) * 4;
      cp_async16(&st.w[s][c], w + g0 + (size_t)s * stride + c);
    }
    for (int e = tid; e < n * kV; e += kThreads) {
      const int s = e / kV, c = (e % kV) * kEl;
      cp_async16(&st.v[s][c], v + g0 + (size_t)s * stride + j0 + c);
    }
    cp_async_commit();
  };
  // tile t's y: each column's kG partial sums added in lane order, 4
  // columns a thread, stored 16 bytes a lane
  auto store_y = [&](int t) {
    const int t0 = t * kTile, n = min(kTile, steps - t0);
    for (int e = tid; e < n * kY; e += kThreads) {
      const int s = e / kY, c = 4 * (e % kY);
      float acc[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float p[kG];
        read_rows<kG>(p, &sm.part[s][c + cc][0]);
        acc[cc] = p[0];
#pragma unroll
        for (int q = 1; q < kG; ++q) acc[cc] = __fadd_rn(acc[cc], p[q]);
      }
      *reinterpret_cast<float4*>(y + base + (size_t)(t0 + s) * stride + j0 +
                                 c) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
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
    __syncthreads();  // tile t - 1's sums are read
#pragma unroll 2
    for (int s = 0; s < n; ++s) {
      float rr[RI], kk[RI], ww[RI], vv[CJ];
#pragma unroll
      for (int m = 0; m < kN; ++m) {
        const int i = (m * kG + g) * kQ;
        read_vals<kQ>(&rr[m * kQ], &st.r[s][i]);
        read_vals<kQ>(&kk[m * kQ], &st.k[s][i]);
        read_rows<kQ>(&ww[m * kQ], &st.w[s][i]);
      }
      read_vals<CJ>(vv, &st.v[s][c0]);
      float part[CJ];
#pragma unroll
      for (int c = 0; c < CJ; ++c) part[c] = 0.0f;
#pragma unroll
      for (int m = 0; m < RI; ++m) {
#pragma unroll
        for (int c = 0; c < CJ; ++c) {
          const float kv = __fmul_rn(kk[m], vv[c]);
          const float a = __fadd_rn(S[m][c], __fmul_rn(uu[m], kv));
          part[c] = __fadd_rn(part[c], __fmul_rn(rr[m], a));
          S[m][c] = __fadd_rn(__fmul_rn(ww[m], S[m][c]), kv);
        }
      }
#pragma unroll
      for (int c = 0; c < CJ; ++c) sm.part[s][c0 + c][g] = part[c];
    }
  }
  __syncthreads();
  store_y(tiles - 1);
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int e = 0; e < kQ; ++e) {
      const int i = (n * kG + g) * kQ + e;
#pragma unroll
      for (int c = 0; c < CJ; ++c)
        S_last[((size_t)bh * HD + i) * HD + j0 + c0 + c] = S[n * kQ + e][c];
    }
  }
}

template <typename T, int HD, int RI, int CJ, int JC>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* S0, void* y, void* S_last, int B,
           int steps, int H, cudaStream_t stream) {
  if ((long long)B * H * (HD / JC) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  wkv6_kernel<T, HD, RI, CJ, JC>
      <<<B * H * (HD / JC), JC / CJ * HD / RI, 0, stream>>>(
          (const T*)r, (const T*)k, (const T*)v, (const float*)w,
          (const float*)u, (const float*)S0, (float*)y, (float*)S_last,
          steps, H);
  return (int)cudaGetLastError();
}

// the geometry for each head dim: RI key channels and CJ columns a lane,
// JC columns a block (at 64, tiles of 4 x 4 ran 1.373-1.384 ms against
// 1.312-1.320 for 8 x 2 at rwkv6-3b's prefill shape)
template <typename T>
int launch_hd(int hd, const void* r, const void* k, const void* v,
              const void* w, const void* u, const void* S0, void* y,
              void* S_last, int B, int steps, int H, cudaStream_t s) {
  switch (hd) {
    case 8:
      return launch<T, 8, 2, 1, 8>(r, k, v, w, u, S0, y, S_last, B, steps, H,
                                   s);
    case 16:
      return launch<T, 16, 4, 2, 16>(r, k, v, w, u, S0, y, S_last, B, steps,
                                     H, s);
    case 32:
      return launch<T, 32, 4, 4, 16>(r, k, v, w, u, S0, y, S_last, B, steps,
                                     H, s);
    case 64:
      return launch<T, 64, 8, 2, 16>(r, k, v, w, u, S0, y, S_last, B, steps,
                                     H, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

}  // namespace

// bf16 != 0: r, k and v are bf16, else f32.  hd must be 8, 16, 32 or 64,
// and r, k, v, w and y 16-byte aligned (the wrapper refuses any other
// before it gets here).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* S0,
                           void* y, void* S_last, int B, int steps, int H,
                           int hd, int bf16, void* stream) {
  if (B <= 0 || steps <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (!aligned16(r) || !aligned16(k) || !aligned16(v) || !aligned16(w) ||
      !aligned16(y))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_hd<__nv_bfloat16>(hd, r, k, v, w, u, S0, y, S_last, B,
                                    steps, H, s);
  return launch_hd<float>(hd, r, k, v, w, u, S0, y, S_last, B, steps, H, s);
}
