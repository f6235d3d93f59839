// The segmented sum of gathered products shared by the sum kernels of
// bsp_superstep.cu and segment_reduce.cu, and its segmented scan
// (`tile_scan`), which bsp_superstep.cu's min kernel takes with an int
// min for its combine.
//
// A CTA sums a tile of kTile consecutive edges of one stream at a time,
//   sum over the edges e of a run of equal ld[e] of (double)(g[ls[e]] * w[e])
// for edges with w[e] != 0, each product rounded to f32 (as the plain
// versions round it) and added in f64; pads (w == 0) add nothing, by a
// select. The caller says where each run's sum goes (`emit`): into an f64
// accumulator by atomics, or, for a dst-sorted stream, straight to the
// output. The output is rounded to f32 once.
//
// What bounds it on an H100: bytes, the 12 bytes of an edge read once,
// and the gathers, each a 32-byte L2 sector for 4 useful bytes. Each
// thread takes kEdges consecutive edges with one 16-byte load each of ls,
// ld and w (48 bytes in flight a thread; a ragged or unaligned stream
// takes scalar loads), with the evict-first hint, so that the gathered
// vector keeps L2. A persistent grid loads a CTA's next tile before it
// sums the current one. Power-law hubs make destination runs long, so no
// run is left to one thread: a segmented scan bounded by run heads (in a
// thread over its edges, in a warp by shuffles, across the CTA's warps in
// shared memory) gives each thread the part of its first run that lies
// before it, and the thread holding a run's last edge in the tile emits
// the run. A hub of k edges is emitted about k / kTile times.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace segsum {

constexpr int kThreads = 256;
constexpr int kEdges = 4;  // edges a thread
constexpr int kTile = kThreads * kEdges;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// The bits an out-of-range id sets in the error flag.
constexpr unsigned kBadSrc = 1u, kBadDst = 2u;

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The id guard of the segment kernels: the error bits of one edge, which
// must have 0 <= s < V and 0 <= d < n.
__device__ __forceinline__ unsigned id_error(int s, int d, int V, int n) {
  return ((unsigned)s >= (unsigned)V ? kBadSrc : 0u) | ((unsigned)d >= (unsigned)n ? kBadDst : 0u);
}

// One thread's kEdges consecutive edges.
struct Edges {
  int s[kEdges], d[kEdges];
  float w[kEdges];
};

// Load edges [e0, e0 + kEdges) of a stream of E edges; edges past the end
// get d = -1 (a run never emitted) and w = 0. vec: the stream's arrays
// are 16-byte aligned, so a full group loads as one vector each.
__device__ __forceinline__ void load_edges(Edges& x, const int* __restrict__ ls,
                                           const int* __restrict__ ld,
                                           const float* __restrict__ w, long long E,
                                           long long e0, bool vec) {
  if (vec && e0 + kEdges <= E) {
    const int4 a = __ldcs(reinterpret_cast<const int4*>(ls + e0));
    const int4 b = __ldcs(reinterpret_cast<const int4*>(ld + e0));
    const float4 c = __ldcs(reinterpret_cast<const float4*>(w + e0));
    x.s[0] = a.x, x.s[1] = a.y, x.s[2] = a.z, x.s[3] = a.w;
    x.d[0] = b.x, x.d[1] = b.y, x.d[2] = b.z, x.d[3] = b.w;
    x.w[0] = c.x, x.w[1] = c.y, x.w[2] = c.z, x.w[3] = c.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < kEdges; ++k) {
    const bool in = e0 + k < E;
    x.s[k] = in ? __ldcs(ls + e0 + k) : 0;
    x.d[k] = in ? __ldcs(ld + e0 + k) : -1;
    x.w[k] = in ? __ldcs(w + e0 + k) : 0.0f;
  }
}

// The combines of `tile_scan`: an f64 sum (the sum kernels) and an int
// min (bsp_superstep.cu's min, over order-preserving keys of floats).
struct SumF64 {
  using T = double;
  static __device__ __forceinline__ T identity() { return 0.0; }
  static __device__ __forceinline__ T op(T a, T b) { return a + b; }
};
struct MinI32 {
  using T = int;
  static __device__ __forceinline__ T identity() { return 0x7fffffff; }
  static __device__ __forceinline__ T op(T a, T b) { return min(a, b); }
};

// The segmented reduction of one tile: this thread's kEdges consecutive
// edges have destinations d and values x; call emit(d, run, first, last)
// for every run of equal destinations that ends in this thread's edges,
// with `run` the Op-combine of the run's values within the tile, and first
// and last the destinations of the tile's first and last edge. Runs with
// a negative d (past the stream's end, or an id the guard refused) are
// not emitted. kCta: the tile is the CTA's edges, a run is emitted once a
// tile and every thread of the CTA calls it (it synchronizes the CTA);
// else the tile is the warp's edges, a run that crosses warps is emitted
// by each (first and last are -1), and nothing is synchronized — for a
// combine whose result does not change when a part is emitted twice (min).
template <typename Op, bool kCta = true, typename Emit>
__device__ __forceinline__ void tile_scan(const int (&d)[kEdges],
                                          const typename Op::T (&x)[kEdges], Emit&& emit) {
  using T = typename Op::T;
  __shared__ int first_d[kWarps], last_d[kWarps], flagged[kWarps];
  __shared__ T tail[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  // Run heads: an edge whose destination differs from the edge before it
  // (the tile's first edge is one).
  int prev = __shfl_up_sync(kFull, d[kEdges - 1], 1);
  int next = __shfl_down_sync(kFull, d[0], 1);
  int first = -1, last = -1;
  if constexpr (kCta) {
    if (lane == 0) first_d[warp] = d[0];
    if (lane == 31) last_d[warp] = d[kEdges - 1];
    __syncthreads();
    if (lane == 0 && warp > 0) prev = last_d[warp - 1];
    if (lane == 31) next = warp + 1 < kWarps ? first_d[warp + 1] : ~d[kEdges - 1];
    first = first_d[0], last = last_d[kWarps - 1];
  } else if (lane == 31) {
    next = ~d[kEdges - 1];
  }
  bool head[kEdges];
  head[0] = (kCta ? t : lane) == 0 || d[0] != prev;
#pragma unroll
  for (int k = 1; k < kEdges; ++k) head[k] = d[k] != d[k - 1];

  // The thread's trailing run: its combine, and whether the thread holds a head.
  T S = Op::identity();
  bool F = false;
#pragma unroll
  for (int k = 0; k < kEdges; ++k) {
    S = head[k] ? x[k] : Op::op(S, x[k]);
    F |= head[k];
  }
  // Inclusive segmented scan of the trailing runs over the warp: lane l
  // combines lanes back to the nearest one holding a head.
  const unsigned flags = __ballot_sync(kFull, F);
  const unsigned upto = flags & (kFull >> (31 - lane));
  const int start = upto ? 31 - __clz(upto) : 0;
  T I = S;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T y = __shfl_up_sync(kFull, I, off);
    if (lane - off >= start) I = Op::op(I, y);
  }
  // Across warps: the run open at this warp's start, combined over the
  // warps before it back to the nearest one holding a head.
  T carry_w = Op::identity();
  if constexpr (kCta) {
    if (lane == 31) {
      tail[warp] = I;
      flagged[warp] = flags != 0;
    }
    __syncthreads();
    for (int j = 0; j < warp; ++j) carry_w = flagged[j] ? tail[j] : Op::op(carry_w, tail[j]);
    if (!upto) I = Op::op(I, carry_w);
  }
  T carry = __shfl_up_sync(kFull, I, 1);
  if (lane == 0) carry = carry_w;

  // Emit every run that ends in this thread's edges.
  T run = head[0] ? Op::identity() : carry;
#pragma unroll
  for (int k = 0; k < kEdges; ++k) {
    if (k > 0 && head[k]) {
      if (d[k - 1] >= 0) emit(d[k - 1], run, first, last);
      run = Op::identity();
    }
    run = Op::op(run, x[k]);
  }
  if (next != d[kEdges - 1] && d[kEdges - 1] >= 0) emit(d[kEdges - 1], run, first, last);
}

// Sum one tile whose edges this thread loaded into `in` (edges e0.. of a
// stream of E), gathering from g, and call emit(d, sum, first, last) for
// every run that ends in this thread's edges (`tile_scan`). kCheck: an
// edge with an id outside [0, V) (ls) or [0, n) (ld) adds nothing and
// sets its bits in *err.
template <bool kCheck, typename Emit>
__device__ __forceinline__ void tile_sum(Edges in, const float* __restrict__ g, long long E,
                                         long long e0, int V, int n, unsigned* __restrict__ err,
                                         Emit&& emit) {
  const int lane = threadIdx.x & 31;
  double x[kEdges];
  unsigned bad = 0;
#pragma unroll
  for (int k = 0; k < kEdges; ++k) {
    if (kCheck && e0 + k < E) {
      const unsigned b = id_error(in.s[k], in.d[k], V, n);
      bad |= b;
      if (b & kBadDst) in.d[k] = -1;
      if (b & kBadSrc) in.w[k] = 0.0f;  // no gather through it
    }
    x[k] = in.w[k] != 0.0f ? (double)__fmul_rn(__ldg(g + in.s[k]), in.w[k]) : 0.0;
  }
  if (kCheck) {
    bad = __reduce_or_sync(kFull, bad);
    if (bad && lane == 0) atomicOr(err, bad);
  }
  tile_scan<SumF64>(in.d, x, emit);
}

// Walk the tiles of `rows` rows of E edges each with a persistent grid, a
// tile a CTA at a time, and call on_tile(edges, r, j, e0) for this
// thread's edges of tile j (counted over all rows) of row r, which start
// at edge e0 of the row. Row r reads stream r % stream_rows (at
// ls + (r % stream_rows) * E, ...): rows past the streams share them. A
// CTA loads its next tile before it hands over the current one, so that
// the stream's loads stay in flight through the gathers and the scan.
template <typename OnTile>
__device__ __forceinline__ void for_tiles(const int* __restrict__ ls, const int* __restrict__ ld,
                                          const float* __restrict__ w, int rows,
                                          int stream_rows, long long E, bool vec,
                                          OnTile&& on_tile) {
  const long long per_row = (E + kTile - 1) / kTile, total = per_row * rows;
  const long long off = (long long)threadIdx.x * kEdges;
  Edges cur, nxt;
  long long j = blockIdx.x;
  if (j < total) {
    const long long r = j / per_row, s = (r % stream_rows) * E;
    load_edges(cur, ls + s, ld + s, w + s, E, (j - r * per_row) * kTile + off, vec);
  }
  for (; j < total; j += gridDim.x) {
    const long long r = j / per_row, e0 = (j - r * per_row) * kTile + off;
    const long long jn = j + gridDim.x;
    if (jn < total) {
      const long long rn = jn / per_row, s = (rn % stream_rows) * E;
      load_edges(nxt, ls + s, ld + s, w + s, E, (jn - rn * per_row) * kTile + off, vec);
    }
    on_tile(cur, r, j, e0);
    cur = nxt;
  }
}

// Prepare `kern` for persistent launches and return how many CTAs of
// kThreads of it (with `smem` bytes of dynamic shared memory) the card
// holds at once, the grid of such a launch
// (callers keep it, as the queries cost host time). The kernel needs
// little shared memory, so the rest of the SM's 256 KB goes to L1, which
// serves the gathers that hit.
inline long long resident_ctas(const void* kern, size_t smem = 0) {
  cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, 0);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  return (long long)sms * (per_sm > 0 ? per_sm : 1);
}

// The grid of a persistent launch over `tiles` tiles.
inline int persistent_grid(long long resident, long long tiles) {
  return (int)(tiles < resident ? (tiles > 0 ? tiles : 1) : resident);
}

}  // namespace segsum
