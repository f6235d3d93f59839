// Whole local stage of one BSP superstep, per worker.
//
// Replaces the TPU kernel `_bsp_superstep_kernel` / `bsp_superstep_pallas`
// in src/repro/kernels/bsp_superstep.py. Inputs per worker w: an edge
// stream lsrc/ldst/weight [p, E] and values val [p, n] (n = num_out).
// A launch takes R = B·p value rows against the p streams: value row r
// reads stream r % p, so a batch of B queries over one partition shares
// its streams (the TPU kernel took the batch axis under vmap); the
// stream is never copied. Below, "worker" means a value row.
//   MIN: Jacobi min-plus passes to the local fixpoint, at most inner_cap
//        of them. A pass gathers from the values as they were at its start
//        (prev), combines into acc seeded with prev,
//          acc[d] = min(acc[d], prev[s] + w)   for every edge with w < INF,
//        and changed = any(acc != prev). iters[w] = the number of passes
//        that changed something. Pads carry w = INF (3e38) and are masked
//        by a select, never by arithmetic. With a live mask (one byte a
//        query), the rows of a query that is not live run no pass, keep
//        their values and count 0 iterations.
//   SUM: one push-sum sweep, out[d] = sum over edges into d of share[s] * w
//        with share = val/outdeg (0 where outdeg == 0); edges with w == 0
//        (pads) add nothing. The f32 products are added in f64 and the sum
//        rounded to f32 once. Each worker's stream must be dst-sorted.
//        iters[w] = 1.
// Both guard their ids: an edge with lsrc or ldst outside [0, n) reads and
// commits nothing and sets bit 0 (lsrc) or bit 1 (ldst) of the 4-byte
// device flag *err, which the kernels only ever OR into (the caller zeroes
// it, and may let it gather the bits of many launches).
//
// What bounds it on an H100: bytes. A min pass reads the edge stream (12
// bytes an edge) and gathers one value an edge from L2. MIN is one
// cooperative launch of a persistent grid that runs the workers' passes in
// lock step, each pass two phases between grid barriers:
//   * the edge phase walks the tiles (1,024 edges) of the workers still
//     active, worker-major, so that the whole card works on one or two
//     workers at a time and their values (prev, and acc as int keys, about
//     1 MB each at full width) stay in L2 while the stream flows past with
//     the evict-first hint. A thread takes 4 consecutive edges (16-byte
//     loads; ragged or unaligned streams take scalar ones); while it
//     reduces a tile, the loads of its next tile (ld, w, the gathered
//     source values) and the sources of the tile after are in flight. An
//     edge whose source kept its value bits in the pass before is skipped
//     (its ld and w are not loaded, nothing is gathered): the term
//     prev[s] + w was already offered then, so the seed bounds it — exact,
//     not a heuristic. A pass reads this frontier only when at most half
//     of its workers' vertices changed in the pass before: where more did,
//     every edge takes part, as in the first pass, since the lookup stands
//     between an edge's source and its gather. The other edges'
//     candidates, as order-preserving int keys (-0 below +0), are
//     min-reduced per run of equal destinations by the segmented scan of
//     segmented_sum.cuh in a thread and a warp (a min may take a part of a
//     run twice, so a run that crosses warps is committed by each, and the
//     tile loop has no CTA barrier), and each run is committed by a
//     fire-and-forget atomicMin (red.global.min.s32). On keys that keeps
//     the plain version's rule, that a candidate equal to the seed as a
//     float never replaces it, for every value but -0 (whose key lies
//     below +0's): a -0 run min is committed only when the seed is
//     positive, the one case that reads the seed;
//   * the vertex phase decodes acc, counts acc != prev as floats (the
//     plain version's `new != v`), writes the next pass's prev and the
//     worker's frontier bitmap (bit v: v's value bits changed; 16 vertices
//     a word, under the pass's 16-bit tag), and marks the worker changed.
//     A worker that did not change drops out: its tiles go to nobody. acc
//     stays as the next pass's seed.
// Data other CTAs wrote in the launch is read through L2 (ld.cg), except
// the two arrays every edge reads: the frontier, and the values (kept
// beside the number of the pass that wrote them, 8 bytes a vertex; the
// vertex phase rewrites every active worker's). A frontier word or a
// value is read through L1 and taken only if it carries the current pass's
// tag, else read again through L2: an L1 line from an earlier pass can be
// stale, an entry with the current tag cannot. L2 serves a gather a
// 32-byte sector, so the L1 hits are what the tags buy.
// As measured (PERF.md §6), a pass takes about 2 ms at full width even
// when almost no edge takes part: the walk is bound by the latency of the
// loads it keeps one tile ahead, not yet by bytes.
//
// SUM is three ordinary launches, no barrier: a pass that divides once a
// vertex (share = val/outdeg, in place of a division and a second gather
// an edge); the segmented sum of segmented_sum.cuh over every worker's
// edge tiles (a persistent grid), which zeroes out tile by tile, stores
// each run that lies inside a tile, rounded once, and leaves each tile's
// first and last run in two carry slots; and a pass that adds up the runs
// that cross tiles. The stream being dst-sorted (the reference requires it), a
// destination is one run, so no atomic is needed, and no f64 accumulator
// of [p, n] is zeroed, updated and rounded.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "segmented_sum.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;
constexpr float kInf = 3.0e38f;
constexpr int kFrontBits = 16;  // vertices a frontier word; its upper 16 bits are the tag
constexpr int kNoTag = 1 << 16;  // passes from here on read the frontier through L2 only
constexpr int kNegZeroKey = -1;  // fkey(-0.0f)
// A pass reads the frontier when at most 1/kFrontierShare of its workers'
// vertices changed in the pass before; else every edge takes part.
constexpr int kFrontierShare = 2;

// Order-preserving int key of a float (-0 below +0) and back: min over
// keys is min over floats, with -0 < +0.
__device__ __forceinline__ int fkey(float x) {
  const int b = __float_as_int(x);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float funkey(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// The workers still active at `pass` (those whose last change was in the
// pass before; all of them at pass 0, where chg is 0), in order, into
// act[]; returns how many. Every thread of the CTA calls it.
__device__ int active_workers(const int* __restrict__ chg, int p, int pass, int* act) {
  __shared__ int cnt[segsum::kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = 0;
  for (int w0 = 0; w0 < p; w0 += segsum::kThreads) {
    const int w = w0 + threadIdx.x;
    const bool on = w < p && __ldcg(chg + w) == pass;
    const unsigned bal = __ballot_sync(kFull, on);
    if (lane == 0) cnt[warp] = __popc(bal);
    __syncthreads();
    int off = base, total = 0;
    for (int j = 0; j < segsum::kWarps; ++j) {
      off += j < warp ? cnt[j] : 0;
      total += cnt[j];
    }
    if (on) act[off + __popc(bal & ((1u << lane) - 1))] = w;
    base += total;
    __syncthreads();
  }
  return base;
}

// One thread's 4 edges of a tile of the min kernel's edge phase, in the
// two stages of the tile walk: their sources (row r, edges e0.. of it;
// `act` bit k: edge e0+k is in the stream), then, resolved, their
// destinations, weights and gathered source values, with `act` the edges
// that take part and `loaded` those whose ld and w were read.
struct MinSources {
  int s[segsum::kEdges];
  unsigned act;
  int r;
  long long e0;
};
struct MinEdges {
  int s[segsum::kEdges], d[segsum::kEdges];
  float w[segsum::kEdges];
  uint2 g[segsum::kEdges];  // the gathered (value bits, tag) of the sources
  unsigned act, loaded;
  int r;
};

__global__ void __launch_bounds__(segsum::kThreads)
    bsp_min_kernel(const int* __restrict__ lsrc, const int* __restrict__ ldst,
                   const float* __restrict__ weight, const float* __restrict__ val,
                   float* __restrict__ out, unsigned long long* __restrict__ nchg,
                   uint2* __restrict__ vals, int* __restrict__ acc, unsigned* __restrict__ front,
                   int* __restrict__ chg, int* __restrict__ iters, unsigned* __restrict__ err,
                   unsigned long long* __restrict__ taken,
                   const unsigned char* __restrict__ live, int max_passes, int p, int ps,
                   int E, int n, int inner_cap, int vec) {
  using segsum::kEdges;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int act[];  // [p] the value rows active in this pass
  const int t = threadIdx.x, lane = t & 31;
  const long long tid = (long long)blockIdx.x * segsum::kThreads + t;
  const long long nthreads = (long long)gridDim.x * segsum::kThreads;
  const long long pn = (long long)p * n;
  const int fw = (n + kFrontBits - 1) / kFrontBits;  // frontier words a worker
  const long long per_row = (E + segsum::kTile - 1) / segsum::kTile;

  // vals: the values at the start of a pass (prev), each beside the pass
  // that wrote it (its tag); acc: their keys.
  for (long long i = tid; i < pn; i += nthreads) {
    const float x = val[i];
    vals[i] = make_uint2(__float_as_uint(x), 0u);
    acc[i] = fkey(x);
  }
  // A row of a query that is not live (live[r / ps] == 0) is never
  // active: it runs no pass and keeps its values.
  for (long long i = tid; i < p; i += nthreads)
    chg[i] = live == nullptr || live[i / ps] ? 0 : -1;
  if (tid < 2) nchg[tid] = 0;
  grid.sync();

  for (int pass = 0; pass < inner_cap; ++pass) {
    const int nact = active_workers(chg, p, pass, act);
    if (nact == 0) break;  // the same for every CTA
    const long long tiles = nact * per_row;
    const unsigned tag = (unsigned)pass & 0xffffu;
    // nchg[k & 1]: the vertices whose bits pass k changed (zeroed in pass
    // k's edge phase).
    const bool use_front = pass > 0 && kFrontierShare * __ldcg(nchg + ((pass - 1) & 1)) <=
                                           (unsigned long long)nact * n;
    if (tid == 0) nchg[pass & 1] = 0;
    unsigned bad = 0;
    unsigned ntaken = 0;  // edges that took part (counted when `taken` is given)

    // ---- edge phase. A CTA walks tiles j, j + G, ... (G = gridDim.x):
    // while it reduces tile j, the loads of tile j + G (ld, w and the
    // gathers of the edges that take part) and the sources of tile j + 2G
    // are in flight.
    auto load_src = [&](MinSources& x, long long j) {
      const long long row = j / per_row;
      x.r = act[row];
      x.e0 = (j - row * per_row) * segsum::kTile + (long long)t * kEdges;
      const int* ls = lsrc + (long long)(x.r % ps) * E + x.e0;
      if (vec && x.e0 + kEdges <= E) {
        const int4 a = __ldcs(reinterpret_cast<const int4*>(ls));
        x.s[0] = a.x, x.s[1] = a.y, x.s[2] = a.z, x.s[3] = a.w;
        x.act = 0xfu;
      } else {
        x.act = 0;
#pragma unroll
        for (int k = 0; k < kEdges; ++k) {
          const bool in = x.e0 + k < E;
          x.s[k] = in ? __ldcs(ls + k) : 0;
          x.act |= (unsigned)in << k;
        }
      }
    };
    // The id guard and the frontier on the sources; then the loads of ld,
    // w and the source values of the edges that take part.
    auto resolve = [&](const MinSources& x, MinEdges& y) {
      const unsigned* fr = front + (long long)x.r * fw;
      const uint2* prev = vals + (long long)x.r * n;
      unsigned on = x.act;
#pragma unroll
      for (int k = 0; k < kEdges; ++k) {
        y.s[k] = x.s[k];
        y.g[k] = make_uint2(0u, (unsigned)pass);
        if (!((on >> k) & 1u)) continue;
        const int s = x.s[k];
        if ((unsigned)s >= (unsigned)n) {
          bad |= segsum::kBadSrc;
          on &= ~(1u << k);
          continue;
        }
        if (use_front) {
          unsigned word = pass < kNoTag ? __ldca(fr + s / kFrontBits) : 0u;
          if ((word >> 16) != tag) word = __ldcg(fr + s / kFrontBits);
          if (!((word >> (s % kFrontBits)) & 1u)) {
            on &= ~(1u << k);
            continue;
          }
        }
        y.g[k] = __ldca(prev + s);  // taken if its tag is this pass's (reduce)
      }
      y.act = on;
      y.r = x.r;
      const int* ld = ldst + (long long)(x.r % ps) * E + x.e0;
      const float* wt = weight + (long long)(x.r % ps) * E + x.e0;
      if (on && vec && x.e0 + kEdges <= E) {
        const int4 b = __ldcs(reinterpret_cast<const int4*>(ld));
        const float4 c = __ldcs(reinterpret_cast<const float4*>(wt));
        y.d[0] = b.x, y.d[1] = b.y, y.d[2] = b.z, y.d[3] = b.w;
        y.w[0] = c.x, y.w[1] = c.y, y.w[2] = c.z, y.w[3] = c.w;
        y.loaded = 0xfu;
      } else {
#pragma unroll
        for (int k = 0; k < kEdges; ++k) {
          const bool o = (on >> k) & 1u;
          y.d[k] = o ? __ldcs(ld + k) : -1;
          y.w[k] = o ? __ldcs(wt + k) : kInf;
        }
        y.loaded = on;
      }
    };
    // Candidates, their runs' mins, and the commits. A loaded edge that
    // does not take part keeps its destination (its candidate is the
    // identity), so that its run is not cut. A commit is a bare atomicMin
    // of the key, which keeps the plain version's rule (a candidate that
    // ties the seed as a float does not replace it) for every candidate
    // but -0, whose key lies below +0's: a -0 run min is committed only
    // below a positive seed.
    auto reduce = [&](MinEdges& y) {
      int* a = acc + (long long)y.r * n;
      const uint2* prev = vals + (long long)y.r * n;
      int key[kEdges];
#pragma unroll
      for (int k = 0; k < kEdges; ++k) {
        // A value read through L1 from a line of an earlier pass: read it again.
        if (y.g[k].y != (unsigned)pass) y.g[k] = __ldcg(prev + y.s[k]);
        if (((y.loaded >> k) & 1u) && (unsigned)y.d[k] >= (unsigned)n) {
          bad |= segsum::kBadDst;
          y.d[k] = -1;
          y.act &= ~(1u << k);
        }
        key[k] = segsum::MinI32::identity();
        if ((y.act >> k) & 1u)
          key[k] = fkey(y.w[k] < kInf ? __fadd_rn(__uint_as_float(y.g[k].x), y.w[k]) : kInf);
      }
      ntaken += __popc(y.act);
      segsum::tile_scan<segsum::MinI32, false>(y.d, key, [&](int d, int m, int, int) {
        if (m == segsum::MinI32::identity()) return;
        if (m == kNegZeroKey && !(__uint_as_float(__ldcg(prev + d).x) > 0.0f)) return;
        atomicMin(a + d, m);
      });
    };
    MinSources src;
    MinEdges cur, nxt;
    long long j = blockIdx.x;
    if (j < tiles) {
      load_src(src, j);
      resolve(src, cur);
    }
    if (j + gridDim.x < tiles) load_src(src, j + gridDim.x);
    for (; j < tiles; j += gridDim.x) {
      const long long jn = j + gridDim.x;
      if (jn < tiles) resolve(src, nxt);
      if (jn + gridDim.x < tiles) load_src(src, jn + gridDim.x);
      reduce(cur);
      cur = nxt;
    }
    bad = __reduce_or_sync(kFull, bad);
    if (bad && lane == 0) atomicOr(err, bad);
    if (taken != nullptr && pass < max_passes) {
      ntaken = __reduce_add_sync(kFull, ntaken);
      if (lane == 0 && ntaken) atomicAdd(taken + pass, (unsigned long long)ntaken);
    }
    grid.sync();

    // ---- vertex phase: a warp a group of 32 vertices of an active worker.
    const int groups = (n + 31) / 32;
    const unsigned next_tag = ((unsigned)(pass + 1) & 0xffffu) << 16;
    unsigned nflip = 0;  // vertices whose value bits changed
    for (long long gi = tid >> 5; gi < (long long)nact * groups; gi += nthreads >> 5) {
      const long long row = gi / groups;
      const int r = act[row];
      const int v = (int)(gi - row * groups) * 32 + lane;
      bool fch = false, bch = false;
      if (v < n) {
        const long long i = (long long)r * n + v;
        const float x = funkey(__ldcg(acc + i)), old = __uint_as_float(__ldcg(vals + i).x);
        fch = x != old;
        bch = __float_as_int(x) != __float_as_int(old);
        vals[i] = make_uint2(__float_as_uint(x), (unsigned)(pass + 1));  // every one: its tag
      }
      const unsigned fb = __ballot_sync(kFull, fch), bb = __ballot_sync(kFull, bch);
      if (lane == 0 && fb) chg[r] = pass + 1;
      nflip += lane == 0 ? __popc(bb) : 0u;
      const int word = (v - lane) / kFrontBits + lane / kFrontBits;
      if (lane % kFrontBits == 0 && word < fw)
        front[(long long)r * fw + word] = next_tag | ((bb >> lane) & 0xffffu);
    }
    if (lane == 0 && nflip) atomicAdd(nchg + (pass & 1), (unsigned long long)nflip);
    grid.sync();
  }
  // A worker changed in passes 1..c and then not (or was capped): c passes.
  if (blockIdx.x == 0)
    for (int w = t; w < p; w += segsum::kThreads) iters[w] = max(__ldcg(chg + w), 0);
  for (long long i = tid; i < pn; i += nthreads) out[i] = __uint_as_float(__ldcg(vals + i).x);
}

// SUM, first pass: share = val / outdeg once a vertex (0 where outdeg is
// 0; the same IEEE division the plain version takes), and iters = 1. Four
// elements a thread, in 16-byte accesses where the buffers allow.
__device__ __forceinline__ float share_of(float v, float dg) {
  return dg > 0.0f ? __fdiv_rn(v, dg) : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
    bsp_share_kernel(const float* __restrict__ val, const float* __restrict__ out_degree,
                     float* __restrict__ share, int* __restrict__ iters, long long total,
                     long long deg_total, int p, int vec) {
  // Value i divides by out_degree[i % deg_total]: the rows of a batch
  // share the p rows of out degrees.
  const long long i0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (i0 < p) {
    for (long long i = i0; i < i0 + 4 && i < p; ++i) iters[i] = 1;
  }
  if (vec && i0 + 4 <= total) {
    const float4 v = *reinterpret_cast<const float4*>(val + i0);
    const float4 dg = *reinterpret_cast<const float4*>(out_degree + i0 % deg_total);
    *reinterpret_cast<float4*>(share + i0) = make_float4(
        share_of(v.x, dg.x), share_of(v.y, dg.y), share_of(v.z, dg.z), share_of(v.w, dg.w));
    return;
  }
  for (long long i = i0; i < i0 + 4 && i < total; ++i)
    share[i] = share_of(val[i], out_degree[i % deg_total]);
}

// SUM, second pass: the workers' dst-sorted streams, tile by tile (a
// persistent grid). A destination's edges are one run of its worker's
// row, so a run that starts and ends inside a tile is the whole sum: it is
// rounded and stored. The tile's first and last runs may go on in the
// tiles beside it: they go to the tile's two carry slots (2j, 2j + 1;
// destination -1 when empty) for the last pass. Each tile first zeroes
// its part of out, the destinations after the previous tile's last edge's
// up to its own last edge's (the row's first tile from 0, its last to
// n - 1), clamped to [0, n): whole sectors, written before the tile's
// stores of its sums. Ids outside [0, n) are refused by the guard of
// tile_sum (into *err); such a stream's sums are not defined, but nothing
// is read or written outside the tensors.
__global__ void __launch_bounds__(segsum::kThreads)
    bsp_sum_kernel(const int* __restrict__ lsrc, const int* __restrict__ ldst,
                   const float* __restrict__ weight, const float* __restrict__ share,
                   float* __restrict__ out, int* __restrict__ carry_d,
                   double* __restrict__ carry_v, unsigned* __restrict__ err, int p, int ps, int E,
                   int n, int vec) {
  segsum::for_tiles(
      lsrc, ldst, weight, p, ps, E, vec != 0,
      [&](const segsum::Edges& edges, long long r, long long j, long long e0) {
        int* const cd = carry_d + 2 * j;
        double* const cv = carry_v + 2 * j;
        float* const o = out + r * n;
        const int* const ld = ldst + (r % ps) * E;
        const long long begin = e0 - (long long)threadIdx.x * segsum::kEdges;
        const long long end = begin + segsum::kTile;
        const long long lo = begin == 0 ? 0 : max(0LL, __ldg(ld + begin - 1) + 1LL);
        const long long hi =
            end >= E ? n - 1 : min((long long)n - 1, (long long)__ldg(ld + end - 1));
        for (long long x = lo + threadIdx.x; x <= hi; x += segsum::kThreads) o[x] = 0.0f;
        if (threadIdx.x == 0) cd[0] = cd[1] = -1;
        // tile_sum's barriers order the stores above before its sums'.
        segsum::tile_sum<true>(edges, share + r * n, E, e0, n, n, err,
                               [&](int d, double v, int first, int last) {
                                 if (d == first) {
                                   cd[0] = d, cv[0] = v;
                                 } else if (d == last) {
                                   cd[1] = d, cv[1] = v;
                                 } else if (v != 0.0) {
                                   o[d] = __double2float_rn(v);
                                 }
                               });
      });
}

// SUM, last pass: the runs that cross tiles. Each row's carry slots are in
// stream order, so a destination's partials are consecutive slots (empty
// slots, only ever odd ones, between them). The slot that holds a
// destination's first partial adds them all in f64 and rounds once,
// reading kBatch slots at a time (a hub's run crosses many tiles).
__global__ void __launch_bounds__(kThreads)
    bsp_carry_kernel(const int* __restrict__ carry_d, const double* __restrict__ carry_v,
                     float* __restrict__ out, int p, long long slots, int n) {
  constexpr int kBatch = 8;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= p * slots) return;
  const int d = carry_d[i];
  if (d < 0) return;
  const long long r = i / slots, k0 = i - r * slots;
  const int* const cd = carry_d + r * slots;
  const double* const cv = carry_v + r * slots;
  long long k = k0 - 1;
  if (k >= 0 && cd[k] < 0) --k;
  if (k >= 0 && cd[k] == d) return;  // not the destination's first partial
  double sum = 0.0;
  bool more = true;
  for (k = k0; more && k < slots; k += kBatch) {
    int dk[kBatch];
    double vk[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      dk[q] = k + q < slots ? cd[k + q] : INT_MAX;
      vk[q] = dk[q] == d ? cv[k + q] : 0.0;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      more = more && (dk[q] == d || dk[q] < 0);
      if (more) sum += vk[q];
    }
  }
  if (sum != 0.0) out[r * n + d] = __double2float_rn(sum);
}

// The grid of the min kernel's cooperative launch with `smem` bytes of
// active list: the occupancy queries run once a size (a graph capture
// replays launches without calling them, and the engine launches each
// size eagerly before it captures it).
long long min_resident(const void* kern, size_t smem) {
  constexpr int kSlots = 32;
  static size_t sizes[kSlots];
  static long long resident[kSlots];
  static int used = 0;
  for (int i = 0; i < used; ++i)
    if (sizes[i] == smem) return resident[i];
  const long long r = segsum::resident_ctas(kern, smem);
  if (used < kSlots) {
    sizes[used] = smem;
    resident[used++] = r;
  }
  return r;
}

}  // namespace

extern "C" {

// Bytes of the scratch buffer bsp_superstep_launch needs for `rows` value
// rows (p for one query, B·p for a batch).
long long bsp_superstep_scratch_bytes(int rows, int E, int n, int combine) {
  if (combine == 0) {  // 2 counts, tagged values [R, n], keys [R, n], frontier [R, fw], chg [R]
    const long long fw = (n + kFrontBits - 1) / kFrontBits;
    return 16 + 12LL * rows * n + 4LL * rows * fw + 4LL * rows;
  }
  const long long slots = 2 * (((long long)E + segsum::kTile - 1) / segsum::kTile);
  return 12LL * rows * slots + 4LL * rows * n;
}

// combine: 0 = min (fixpoint), 1 = sum (one sweep; each worker's stream
// dst-sorted). p streams of E edges; rows value rows (a multiple of p:
// row r reads stream r % p); val, out [rows, n]; iters [rows];
// out_degree [p, n], read by sum only. scratch: 8-byte aligned,
// bsp_superstep_scratch_bytes(rows, E, n, combine) of it (min: the keys,
// the frontier and the change marks; sum: the carry sums, the shares, the
// carry destinations). err: a 4-byte device flag that the kernels OR the
// id guard's bits into (bit 0: lsrc, bit 1: ldst outside [0, n)). taken
// (min only; may be null): max_passes zeroed 8-byte counters, to which
// pass k adds the edges that took part in it (k < max_passes). live (min
// only; may be null): one byte a query (rows / p of them); the rows of a
// query whose byte is 0 run no pass, keep their values and count 0
// iterations (the engine's masked steps). Every host
// call here besides the launches is made once a shape, so a launch can be
// captured into a CUDA graph after one eager launch of its shape. Returns
// the launches' cudaGetLastError.
int bsp_superstep_launch(const void* lsrc, const void* ldst, const void* weight, const void* val,
                         const void* out_degree, void* out, void* scratch, void* iters,
                         void* err, void* taken, int max_passes, const void* live, int p,
                         int rows, int E, int n, int combine, int inner_cap, void* stream) {
  if (p < 1 || rows < p || rows % p != 0 || E < 1 || n < 1 || err == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ls = static_cast<const int*>(lsrc);
  const int* ld = static_cast<const int*>(ldst);
  const float* w = static_cast<const float*>(weight);
  const float* v = static_cast<const float*>(val);
  const float* deg = static_cast<const float*>(out_degree);
  float* o = static_cast<float*>(out);
  int* it = static_cast<int*>(iters);
  unsigned* flag = static_cast<unsigned*>(err);
  auto* tk = static_cast<unsigned long long*>(taken);
  const auto* lv = static_cast<const unsigned char*>(live);
  int vec = E % segsum::kEdges == 0 && segsum::aligned16(ls) && segsum::aligned16(ld) &&
            segsum::aligned16(w);
  cudaError_t e;
  if (combine == 0) {
    const void* kern = reinterpret_cast<const void*>(bsp_min_kernel);
    const size_t smem = 4 * (size_t)rows;  // the active list
    static size_t smem_set = 48 * 1024;
    if (smem > smem_set) {
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      smem_set = smem;
    }
    const long long resident = min_resident(kern, smem);
    const long long fw = (n + kFrontBits - 1) / kFrontBits;
    const long long tiles = (long long)rows * ((E + segsum::kTile - 1) / segsum::kTile);
    const long long groups = (long long)rows * ((n + 31) / 32) / segsum::kWarps;
    const int grid = segsum::persistent_grid(resident, tiles > groups ? tiles : groups);
    auto* nchg = static_cast<unsigned long long*>(scratch);
    uint2* tv = reinterpret_cast<uint2*>(nchg + 2);
    int* acc = reinterpret_cast<int*>(tv + (size_t)rows * n);
    unsigned* front = reinterpret_cast<unsigned*>(acc + (size_t)rows * n);
    int* chg = reinterpret_cast<int*>(front + (size_t)rows * fw);
    void* args[] = {&ls, &ld, &w, &v, &o, &nchg, &tv, &acc, &front, &chg, &it, &flag, &tk, &lv,
                    &max_passes, &rows, &p, &E, &n, &inner_cap, &vec};
    e = cudaLaunchCooperativeKernel(kern, grid, segsum::kThreads, args, smem, s);
  } else if (combine == 1) {
    double* carry_v = static_cast<double*>(scratch);
    const long long slots = 2 * ((E + segsum::kTile - 1) / segsum::kTile);
    float* share = reinterpret_cast<float*>(carry_v + rows * slots);
    int* carry_d = reinterpret_cast<int*>(share + (size_t)rows * n);
    const long long total = (long long)rows * n, deg_total = (long long)p * n;
    // A vector of 4 must not wrap around the out degrees' end.
    const int vec4 = segsum::aligned16(v) && segsum::aligned16(deg) &&
                     segsum::aligned16(share) && (deg_total % 4 == 0 || deg_total == total);
    bsp_share_kernel<<<(total + 4 * kThreads - 1) / (4 * kThreads), kThreads, 0, s>>>(
        v, deg, share, it, total, deg_total, rows, vec4);
    static const long long resident =
        segsum::resident_ctas(reinterpret_cast<const void*>(bsp_sum_kernel));
    const int grid = segsum::persistent_grid(resident, rows * slots / 2);
    bsp_sum_kernel<<<grid, segsum::kThreads, 0, s>>>(ls, ld, w, share, o, carry_d, carry_v, flag,
                                                     rows, p, E, n, vec);
    bsp_carry_kernel<<<(rows * slots + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        carry_d, carry_v, o, rows, slots, n);
    e = cudaGetLastError();
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
