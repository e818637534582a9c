// Per-bin sliding-Goertzel amplitudes: kernel E of the port.
//
// Replaces the reference's Pallas kernel sliding_goertzel_v2_pallas
// (src/repro/kernels/goertzel/goertzel.py:250, body _sliding_kernel_v2 at
// :220 with _bin_amps_lane_major and _global_idx_scale).  Same operands and
// outputs, batched over rows: for row b, segment s, offset j and bin k the
// amplitude that kernel A (monitor.cu) computes before its reduction,
//   2/win |P_s[j] + e^{j w_k win} (P_{s-1}[win-1] - P_{s-1}[j])|
//         * win / min(idx + 1, win),   idx = (seg0 + s) win + j  (int64),
// with P_{-1} the state streamed in (re0/im0), and the last segment's
// prefix tables as the state out (nre/nim).
//
// Layout.  The amplitudes are written [B, S, win, K], bins minor, so the
// wrapper's reshape to [B, n, K] (the reference's stacked [n, K] output and
// what every caller indexes by sample) is a view, not a copy.
//
// Design and bound: sliding_walk.cuh, shared with kernel I
// (sliding_v1.cu): kernel A's cluster walk, bins in parallel, ending in
// interleaved, contiguous stores instead of A's reduction.  The wrapper
// (sliding.py, sliding_route and segment_groups) chooses the geometry.
#include "sliding_walk.cuh"

extern "C" int sliding_launch(const void* xseg, const void* cosp,
                              const void* sinp, const void* rot,
                              const void* seg0, const void* re0,
                              const void* im0, void* amps, void* nre,
                              void* nim, int B, int S, int win, int K,
                              int resident, int J, int group, void* stream) {
  const SlideOps op = {(const float*)xseg, (const float*)cosp,
                       (const float*)sinp, (const float*)rot,
                       (const long long*)seg0, (const float*)re0,
                       (const float*)im0, (float*)amps, (float*)nre,
                       (float*)nim, S, K};
  const bool vec = aligned(xseg, 16) && aligned(cosp, 16) &&
                   aligned(sinp, 16) && aligned(re0, 16) &&
                   aligned(im0, 16) && aligned(nre, 16) && aligned(nim, 16);
  return launch_walk<false>(op, B, win, resident, J, group, vec, stream);
}

// clusters of min(K, 8) blocks at smem bytes a block the card holds at once
// (or a negative CUDA error): segment_groups's input
extern "C" int sliding_active_clusters(int K, long long smem) {
  return active_clusters<false>(K, smem);
}
