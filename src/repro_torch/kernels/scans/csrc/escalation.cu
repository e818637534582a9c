// Escalation state machine over a class stream: kernel D of the port.
//
// Replaces the reference's escalation scan (src/repro/core/telemetry.py,
// escalation_scan, the blocked lax.scan at line 212), which folds
// escalation_class_step over the per-sample classes the monitor emits.
//
// Bound on this card: a serial chain.  Each sample's transition depends on
// the previous sample's (level, above, below, detect), so one row costs one
// dependent step per sample; rows are independent.  The design gives each
// row one thread and walks its samples in order; the loads of the class
// stream do not depend on the carry, so they run ahead of the chain.  The
// bytes (one int8 in, one int8 out per sample) are far below what the card
// can move in that time.
//
// Semantics, per sample (class 2 hit, 1 band, 0 clear, 3 pad = identity):
//   above = hit ? above+1 : (pad ? above : 0)
//   below = clear ? below+1 : (pad ? below : 0)
//   esc   = hit && above >= sustain && level < max_level
//   detect latches the global index of the first escalation; level += esc,
//   above = 0 on esc; deesc = clear && below >= cool && level > 0 lowers the
//   level by one and resets below.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void escalation_kernel(const int8_t* __restrict__ cls,
                                  const long long* __restrict__ idx0,
                                  const long long* __restrict__ carry_in,
                                  int8_t* __restrict__ levels,
                                  long long* __restrict__ carry_out,
                                  int rows, long long n, long long sustain,
                                  long long cool, long long max_level) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int8_t* c = cls + (long long)r * n;
  int8_t* out = levels + (long long)r * n;
  long long level = carry_in[4 * r + 0];
  long long above = carry_in[4 * r + 1];
  long long below = carry_in[4 * r + 2];
  long long detect = carry_in[4 * r + 3];
  const long long g0 = idx0[r];
  for (long long i = 0; i < n; ++i) {
    const int8_t k = c[i];
    const bool hit = k == 2, clear = k == 0, on = k != 3;
    above = hit ? above + 1 : (on ? 0 : above);
    below = clear ? below + 1 : (on ? 0 : below);
    const bool esc = hit && above >= sustain && level < max_level;
    if (esc && detect < 0) detect = g0 + i;
    if (esc) { level += 1; above = 0; }
    const bool deesc = clear && below >= cool && level > 0;
    if (deesc) { level -= 1; below = 0; }
    out[i] = (int8_t)level;
  }
  carry_out[4 * r + 0] = level;
  carry_out[4 * r + 1] = above;
  carry_out[4 * r + 2] = below;
  carry_out[4 * r + 3] = detect;
}

}  // namespace

extern "C" int escalation_launch(const void* cls, const void* idx0,
                                 const void* carry_in, void* levels,
                                 void* carry_out, int rows, long long n,
                                 long long sustain, long long cool,
                                 long long max_level, void* stream) {
  const int threads = 32;
  const int blocks = (rows + threads - 1) / threads;
  escalation_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)cls, (const long long*)idx0,
      (const long long*)carry_in, (int8_t*)levels, (long long*)carry_out,
      rows, n, sustain, cool, max_level);
  return (int)cudaGetLastError();
}
