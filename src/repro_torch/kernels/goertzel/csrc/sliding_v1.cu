// Per-bin sliding-Goertzel amplitudes in the v1 (bin-minor) layout: kernel
// I of the port.
//
// Replaces the reference's Pallas kernel sliding_goertzel_pallas
// (src/repro/kernels/goertzel/goertzel.py:137, body _sliding_kernel at
// :106).  Operands: xseg [S, win] f32 (the centred, zero-padded trace in
// window-sized segments), cosp/sinp [win, K] f32 (cos/sin of w_k p) and
// rot [2, K] f32 ([cos; sin] of w_k win).  Output [S, win, K] f32: for
// segment s, offset j and bin k
//   2/win |P_s[j] + e^{j w_k win} (P_{s-1}[win-1] - P_{s-1}[j])|,
// with P_s the modulated prefix sums of segment s restarted at its start
// and P_{-1} = 0.  No warm-up scale: the caller applies it, as the
// reference's benchmark wrapper does.
//
// Design and bound: kernel E's (sliding_walk.cuh), in its mode with no
// scale, zero state in and none out: the same kernel body, so with the
// warm-up scale applied after, I equals E bit for bit on the same
// segments.  The bin's column of the [win, K] tables is copied straight
// into its tiles, 4 bytes a copy, once a group of segments (the TPU kernel
// carries the previous segment's table in scratch across a sequential
// grid; here a cluster keeps it in shared memory across its group).  One
// launch, no scratch buffer.
#include "sliding_walk.cuh"

extern "C" int sliding_v1_launch(const void* xseg, const void* cosp,
                                 const void* sinp, const void* rot, void* out,
                                 int S, int win, int K, int resident, int J,
                                 int group, void* stream) {
  const SlideOps op = {(const float*)xseg, (const float*)cosp,
                       (const float*)sinp, (const float*)rot, nullptr,
                       nullptr, nullptr, (float*)out, nullptr, nullptr,
                       S, K};
  return launch_walk<true>(op, 1, win, resident, J, group, aligned(xseg, 16),
                           stream);
}

// clusters of min(K, 8) blocks at smem bytes a block the card holds at once
// (or a negative CUDA error): segment_groups's input
extern "C" int sliding_v1_active_clusters(int K, long long smem) {
  return active_clusters<true>(K, smem);
}
