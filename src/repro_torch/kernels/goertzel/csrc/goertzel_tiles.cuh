// Shared by the sliding-Goertzel cluster kernels (monitor.cu, kernel A,
// and sliding_walk.cuh, kernels E and I): the geometry of a block's
// staged tiles and the cp.async copies that fill and drain them.
//
// Thread t's run of chunk = ceil(win/256) samples sits in row t of a
// [256, Q] tile, Q >= the columns staged a round and Q = 4 (mod 8): the
// passes read it 16 bytes at a time, and the 8 lanes of each quarter warp
// then hit 8 distinct groups of 4 banks.  Copies are 16 bytes a lane with
// neighbouring lanes on neighbouring addresses where win, the run and the
// bases allow (vec), else 4 bytes.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "goertzel_scan.cuh"

namespace {

constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kTiles = 6;       // staged [256, Q] tiles a block, usual case

// the least row stride >= cols with Q = 4 (mod 8)
__host__ __device__ inline int row_stride(int cols) {
  int q = (cols + 3) & ~3;
  return (q & 7) == 0 ? q + 4 : q;
}

__host__ inline size_t tiles_bytes(int J) {
  return sizeof(float) * (size_t)kTiles * kThreads * row_stride(J);
}

struct Geometry {
  int win, chunk;    // samples a segment, samples a thread's run
  int J, Q;          // run columns staged a round, tile row stride
  int rounds;
  bool vec;          // 16-byte copies (chunk, win and bases allow them)
  bool resident;     // the usual case: segment groups, kept prefix tables
  int group, groups; // segments a cluster walks, and clusters a row
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

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every cp.async of this thread has landed; then the block may read them
__device__ __forceinline__ void staged() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float at(const float4& v, int e) {
  return reinterpret_cast<const float*>(&v)[e];
}

__device__ __forceinline__ float& at(float4& v, int e) {
  return reinterpret_cast<float*>(&v)[e];
}

// Piece u = t * per + i of a tile's round (per pieces a run), walked by a
// thread in steps of kThreads pieces without a division a step.
struct Pieces {
  int t, i, dt, di, per;
  __device__ __forceinline__ Pieces(int u, int per_) : per(per_) {
    t = u / per, i = u - t * per;
    dt = kThreads / per, di = kThreads - dt * per;
  }
  __device__ __forceinline__ void next() {
    t += dt, i += di;
    if (i >= per) i -= per, ++t;
  }
};

// Copy columns [c0, c0 + jr) of every thread's run of a win-sample row
// (src) into rows of a tile (dst[t * Q + j]); with vec, jr % 4 == 0.
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      const Geometry& g, int c0, int jr) {
  if (g.vec) {
    const int q4 = jr >> 2;
    Pieces p(threadIdx.x, q4);
    for (int u = threadIdx.x; u < kThreads * q4; u += kThreads, p.next()) {
      const int gi = p.t * g.chunk + c0 + 4 * p.i;
      if (gi < g.win) cp_async16(dst + p.t * g.Q + 4 * p.i, src + gi);
    }
  } else {
    for (int u = threadIdx.x; u < kThreads * jr; u += kThreads) {
      const int t = u / jr, j = u - t * jr;
      const int gi = t * g.chunk + c0 + j;
      if (gi < g.win) cp_async4(dst + t * g.Q + j, src + gi);
    }
  }
}

// The reverse of stage, for the prefix state out.
__device__ __forceinline__ void unstage(float* dst, const float* src,
                                        const Geometry& g, int c0, int jr) {
  if (g.vec) {
    const int q4 = jr >> 2;
    Pieces p(threadIdx.x, q4);
    for (int u = threadIdx.x; u < kThreads * q4; u += kThreads, p.next()) {
      const int gi = p.t * g.chunk + c0 + 4 * p.i;
      if (gi < g.win) st4(dst + gi, ld4(src + p.t * g.Q + 4 * p.i));
    }
  } else {
    for (int u = threadIdx.x; u < kThreads * jr; u += kThreads) {
      const int t = u / jr, j = u - t * jr;
      const int gi = t * g.chunk + c0 + j;
      if (gi < g.win) dst[gi] = src[t * g.Q + j];
    }
  }
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace
