// The machinery that kernels J and K (gpu_floor_relaxed.cu,
// battery_relaxed.cu) share: a row cut into chunks, one warp a chunk, the
// chunks handed their start through device memory, and inside a chunk the
// two ways a recurrence is spread over the lanes.
//
//  * Chunks.  A row of n samples is cut into chunks of kChunk = 32 x kSeg
//    samples; lane k of a chunk's warp owns segment k (kSeg samples, kept
//    in shared memory at a stride of kSeg + 1 words, so a lane's walk and
//    the warp's coalesced copies are free of bank conflicts).  Each block
//    is one warp and takes a ticket from a counter in the scratch words;
//    ticket t is chunk t / rows (or C - 1 - t / rows, in reverse) of row t
//    % rows, so a chunk's predecessors on its row hold smaller tickets,
//    have started, and never wait on it: waiting cannot deadlock.  A chunk
//    hands its end to the next through a mailbox (a flag word and a value
//    word, the value written first, then a fence, then the flag); the
//    scratch is zeroed by each entry before its launch.
//
//  * Forward recurrences: segmented walks with an exact merge test, kernel
//    B's scheme (gpu_floor.cu) spread over chunks.  Each lane walks its
//    segment from a guess and keeps its outputs.  A lane whose start (its
//    predecessor's end; lane 0's the chunk's start) differs bit for bit
//    from the start of its kept walk walks again from it, testing its state
//    against the kept output every 8 steps (and at the segment's end); at
//    the first equal test the two walks agree for good (a step depends on
//    its state and its sample alone), so the kept outputs from there on
//    stand and the lane's end is unchanged; a lane that never meets them
//    has a new end, which its successor must walk from.  Before the chunk's
//    start is in, two such rounds run in every lane at once, with lane 0's
//    guess as the start (settle).  Once it is in, the first lane whose
//    start changed walks again, then the next such lane, one lane at a time
//    (resolve): where the walks meet, lane 0's walk ends the chunk's work;
//    where they never do, the chunk costs its serial walk in one lane.  The
//    outputs are the serial walk's bit for bit whatever the data.
//
//  * Adjoint recurrences: each is affine in its successor's carry,
//    carry_{i-1} = a_i carry_i + b_i, with a_i and b_i from the forward's
//    saved carries.  Each lane composes its segment's maps in float64, a
//    warp scan composes the lanes', and the chunk's map, ready before its
//    carry arrives, turns the incoming carry into the outgoing one at once;
//    then each lane applies its maps from its own incoming carry.
#pragma once
#include <cuda_runtime.h>

namespace chain {

constexpr int kLanes = 32;
constexpr int kSeg = 32;                    // samples a lane owns
constexpr int kStride = kSeg + 1;           // words a segment in smem
constexpr int kChunk = kLanes * kSeg;       // samples a chunk
constexpr int kWords = kLanes * kStride;    // words an smem array
constexpr int kBoxes = 5;                   // mailboxes a (row, chunk)
constexpr int kSums = 11;                   // f64 partial sums a (row, chunk)
constexpr int kSlot = 2 * kBoxes + kSums;   // 8-byte words a (row, chunk)
constexpr unsigned kFull = 0xffffffffu;

// chunks a row of n samples; scratch words a call (the ticket in word 0)
__host__ __device__ inline long long chunks(long long n) {
  return (n + kChunk - 1) / kChunk;
}
__host__ inline size_t scratch_words(int rows, long long n) {
  return 1 + (size_t)rows * (size_t)chunks(n) * kSlot;
}

// smem position of chunk sample idx in the lane-segment layout
__device__ __forceinline__ int at(int idx) {
  return (idx / kSeg) * kStride + idx % kSeg;
}

struct Place {
  int row, chunk, lane, len;   // len: samples of this lane's segment
  long long i0, C;             // chunk's first sample, chunks a row
  int cnt;                     // samples of this chunk
};

// the block's ticket: row and chunk (reverse: from the row's end)
__device__ __forceinline__ Place place(unsigned long long* scratch, int rows,
                                       long long n, bool reverse) {
  Place p;
  p.lane = threadIdx.x & 31;
  unsigned t = 0;
  if (p.lane == 0) t = atomicAdd((unsigned*)scratch, 1u);
  t = __shfl_sync(kFull, t, 0);
  p.C = chunks(n);
  p.row = (int)(t % (unsigned)rows);
  const long long c = t / (unsigned)rows;
  p.chunk = (int)(reverse ? p.C - 1 - c : c);
  p.i0 = (long long)p.chunk * kChunk;
  p.cnt = (int)min((long long)kChunk, n - p.i0);
  p.len = max(0, min(kSeg, p.cnt - p.lane * kSeg));
  return p;
}

__device__ __forceinline__ unsigned long long* slot(
    unsigned long long* scratch, const Place& p, int chunk) {
  return scratch + 1 + ((size_t)p.row * p.C + chunk) * kSlot;
}

__device__ __forceinline__ void post(unsigned long long* box, double v) {
  *(volatile double*)(box + 1) = v;
  __threadfence();
  *(volatile unsigned long long*)box = 1ull;
}

__device__ __forceinline__ double fetch(const unsigned long long* box) {
  while (*(volatile const unsigned long long*)box == 0ull) __nanosleep(32);
  __threadfence();
  return *(volatile const double*)(box + 1);
}

// lane `from` posts v into box b of this chunk (only if `want`)
__device__ __forceinline__ void post_box(unsigned long long* scratch,
                                         const Place& p, int b, double v,
                                         int from, bool want = true) {
  if (want && p.lane == from) post(slot(scratch, p, p.chunk) + 2 * b, v);
}

// box b of chunk c on this row, read by lane 0 and given to every lane
__device__ __forceinline__ double fetch_box(unsigned long long* scratch,
                                            const Place& p, int c, int b) {
  double v = 0.0;
  if (p.lane == 0) v = fetch(slot(scratch, p, c) + 2 * b);
  return __shfl_sync(kFull, v, 0);
}

// ---- forward: segmented walks with the exact merge test

__device__ __forceinline__ bool same(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}

// Walk len steps of ch from s over the lane's segment, writing kept[];
// with kTest, stop at the first tested step whose state equals the kept
// output there (true: merged; s is then that step's state).  Else s is
// the walk's end.
template <bool kTest, class Ch>
__device__ __forceinline__ bool walk(const Ch& ch, float& s, float* kept,
                                     int len) {
  int j = 0;
  if (len == kSeg) {
#pragma unroll 1
    for (; j < kSeg; j += 8) {
      const float old = kTest ? kept[j + 7] : 0.0f;
      float v[8];
      ch.run8(s, j, v);
#pragma unroll
      for (int q = 0; q < 8; ++q) kept[j + q] = v[q];
      if (kTest && same(s, old)) return true;
    }
    return false;
  }
  for (; j < len; ++j) {
    const float old = kept[j];
    s = ch.step(s, j);
    kept[j] = s;
    if (kTest && same(s, old)) return true;
  }
  return false;
}

// what a chunk's resolution cost once its start came in: segments walked
// again (one after another), those among them that did not merge, and
// their steps
struct Tally {
  int walks, unmerged, steps;
};

// Up to `rounds` rounds in which every lane whose start (its predecessor's
// end; lane 0's is s0) differs from its kept walk's start walks again, all
// lanes at once: before the chunk's start is known (s0 = lane 0's own
// start), so that the kept walks agree with one another wherever the data
// let them meet.
template <class Ch>
__device__ __forceinline__ void settle(const Ch& ch, float* kept, int len,
                                       float s0, float& have, float& end,
                                       int rounds) {
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < rounds; ++r) {
    float start = __shfl_up_sync(kFull, end, 1);
    if (lane == 0) start = s0;
    const bool redo = !same(start, have);
    if (!__any_sync(kFull, redo)) return;
    if (redo) {
      float s = start;
      if (!walk<true>(ch, s, kept, len)) end = s;
      have = start;
    }
  }
}

// Every lane's kept walk made exact from the chunk's start s0: `have` is
// the start of the lane's kept walk, `end` its end (both updated).  The
// first lane whose start differs from its kept walk's start walks again
// (its predecessors are exact, so its start is final), and so on, one
// segment at a time: a walk that merges ends the chunk's work at once, and
// a chunk whose walks never merge costs its serial walk (on the H100 a
// step of 32 lanes walking 32 segments at once took several times a lone
// walk's, so the rounds of the parallel scheme cost more than they saved
// where nothing merges).  Returns the chunk's end to every lane.
template <class Ch>
__device__ __forceinline__ float resolve(const Ch& ch, float* kept, int len,
                                         float s0, float& have, float& end,
                                         Tally& tally) {
  const int lane = threadIdx.x & 31;
  tally = {0, 0, 0};
  while (true) {
    float start = __shfl_up_sync(kFull, end, 1);
    if (lane == 0) start = s0;
    const unsigned mis = __ballot_sync(kFull, !same(start, have));
    if (!mis) break;
    // every lane walks lane f's segment, in step: the warp stays
    // converged (one lane walking while 31 waited made each step several
    // times slower on the H100)
    const int f = __ffs(mis) - 1;
    const int d = (f - lane) * kStride;
    const int flen = __shfl_sync(kFull, len, f);
    float s = __shfl_sync(kFull, start, f);
    const float s_start = s;
    const bool met = walk<true>(ch.shift(d), s, kept + d, flen);
    if (lane == f) {
      have = s_start;
      if (!met) end = s;
    }
    ++tally.walks;
    tally.unmerged += !met && flen > 0;
    tally.steps += flen;
  }
  return __shfl_sync(kFull, end, 31);
}

constexpr int kSettle = 2;     // rounds before the chunk's start is known

// The chunk's recurrence ch from its guess (kept[] from each lane's own
// guess, settled), the start read from box b of the previous chunk (or
// s_first on the row's first chunk), resolved and its end posted in box
// b; writes the resolution's tally to stats[(row, chunk) * nstat + b] if
// stats is given.
template <class Ch>
__device__ __forceinline__ float chain_chunk(
    const Ch& ch, float* kept, float guess, float s_first,
    unsigned long long* scratch, const Place& p, int b, int* stats,
    int nstat, float& s0) {
  float s = guess;
  walk<false>(ch, s, kept, p.len);
  float have = guess, end = s;
  settle(ch, kept, p.len, __shfl_sync(kFull, have, 0), have, end, kSettle);
  s0 = p.chunk == 0 ? s_first
                    : (float)fetch_box(scratch, p, p.chunk - 1, b);
  Tally t;
  const float e = resolve(ch, kept, p.len, s0, have, end, t);
  post_box(scratch, p, b, (double)e, 31, p.chunk + 1 < p.C);
  if (stats != nullptr && p.lane == 0) {
    int* o = stats + (((size_t)p.row * p.C + p.chunk) * nstat + b) * 3;
    o[0] = t.walks, o[1] = t.unmerged, o[2] = t.steps;
  }
  __syncwarp();
  return e;
}

// ---- adjoint: float64 affine maps, composed across the warp

struct Map {
  double a, b;                 // c -> a c + b
};

// m applied after the map n: c -> m(n(c))
__device__ __forceinline__ Map after(const Map& m, const Map& n) {
  return {m.a * n.a, m.a * n.b + m.b};
}

// The carries run from the row's end to its start: lane k's incoming carry
// is the map of lanes k+1 .. 31 applied to the chunk's incoming carry.
// Given each lane's own map (its segment, from its last sample to its
// first), fetch the chunk's incoming carry from box b of chunk + 1 (0 past
// the row's end), post the outgoing one in box b, and return the lane's
// incoming carry; `out` gets the chunk's outgoing carry.
__device__ __forceinline__ double carry_in(Map own,
                                           unsigned long long* scratch,
                                           const Place& p, int b,
                                           double& out) {
  const int lane = p.lane;
  Map inc = own;               // lanes lane .. 31, composed
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    Map m;
    m.a = __shfl_down_sync(kFull, inc.a, o);
    m.b = __shfl_down_sync(kFull, inc.b, o);
    if (lane + o < 32) inc = after(inc, m);
  }
  Map rest;                    // lanes lane + 1 .. 31
  rest.a = __shfl_down_sync(kFull, inc.a, 1);
  rest.b = __shfl_down_sync(kFull, inc.b, 1);
  if (lane == 31) rest = {1.0, 0.0};
  const double cin = p.chunk + 1 < p.C
                         ? fetch_box(scratch, p, p.chunk + 1, b) : 0.0;
  out = __shfl_sync(kFull, inc.a * cin + inc.b, 0);
  post_box(scratch, p, b, out, 0, p.chunk > 0);
  return rest.a * cin + rest.b;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

// The parameter gradients: each lane's float64 sums g[0 .. ncol) reduced
// across the warp, kept in the chunk's slot and flagged in box b; chunk 0
// then sums every chunk's, in chunk order, into out[0 .. ncol) as f32
// (after adding extra[c] to column c).  No atomics: the bits do not depend
// on the order the chunks end in.
__device__ __forceinline__ void reduce_params(double* g, int ncol,
                                              unsigned long long* scratch,
                                              const Place& p, int b,
                                              const double* extra,
                                              float* out) {
  for (int c = 0; c < ncol; ++c) g[c] = warp_sum(g[c]);
  double* sums = (double*)(slot(scratch, p, p.chunk) + 2 * kBoxes);
  if (p.lane == 0) {
    for (int c = 0; c < ncol; ++c) sums[c] = g[c];
    if (p.chunk > 0) post(slot(scratch, p, p.chunk) + 2 * b, 1.0);
  }
  __syncwarp();
  if (p.chunk != 0) return;
  if (p.lane < ncol) {
    double tot = 0.0;
    for (long long c = 0; c < p.C; ++c) {
      unsigned long long* s = slot(scratch, p, (int)c);
      if (c > 0) fetch(s + 2 * b);
      tot += *(volatile double*)((double*)(s + 2 * kBoxes) + p.lane);
    }
    out[p.lane] = (float)(tot + extra[p.lane]);
  }
  __syncwarp();
}

}  // namespace chain
