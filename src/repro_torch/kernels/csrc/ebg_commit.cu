// Streaming-scorer block commit for the chunked vertex-cut partitioners.
//
// Replaces the TPU kernel `_ebg_commit_kernel` / `ebg_commit_block_pallas`
// in src/repro/kernels/ebg_commit.py. For each block of B edges:
//   1. miss bits of u and v against the BLOCK-START membership, for every
//      part;
//   2. for each edge in turn, the argmin over parts i of
//        fma(cv*v_c, inv_v, fma(ce*e_c, norm, gain))    (ties -> lowest i)
//      with gain = mu + mv, or wu*mu + wv*mv for HDRF's degree weights, and
//      norm = inv_e ("static") or 1/(eps + (max e_c - min e_c)) ("range");
//      a valid edge commits e_c[i] += 1 and v_c[i] += mu[i] + mv[i];
//   3. the winners' membership bits.
// Pad edges (valid == 0) are scored but commit nothing; their part is p.
// WINDOW replays each valid commit onto the block's later edges: the
// winner's miss bit is cleared on every later column whose u (or v) equals
// u_j or v_j, which makes any block size bit-identical to the per-edge scan.
//
// Layout. The public bitset is keep[p, vw] (bit k of word c = vertex
// 32c+k of part r). For one launch the kernel works on its transpose,
// memb[32·vw, W] (bit i of word w = part 32w+i holds the vertex; W =
// ⌈p/32⌉): an endpoint's parts are W consecutive words, so an edge's
// gather is 2·W loads and a commit is one atomicOr a word.
// `membt::transpose_kernel` (in memb_transpose.cuh; the wrappers
// `keep_bits_to_memb` and `memb_to_keep_bits` of ebg_commit.py) converts at
// the launch's start and end, in tiles of 256 32x32 bit blocks a CTA.
//
// What bounds it on an H100: the per-edge chain is strictly sequential
// (edge j+1's argmin needs edge j's counters), so the cost is the latency
// of one score and argmin per edge, not bytes or FLOPs. One CTA keeps that
// chain short and overlaps everything else with it (warp specialisation):
//   * chain warps hold the counters in registers for the whole launch, one
//     part a lane: warp 0 alone for p <= 32 (K = 0); for 33..1,024 parts,
//     W chain warps of 32 parts (K = 1, p <= 512) or ⌈W/2⌉ warps of 64, two
//     a lane (K = 2);
//   * the argmin is one __reduce_min_sync over an order-preserving u32
//     image of the score and one ballot: the lowest lane at the min wins.
//     With several chain warps each publishes its min in shared memory
//     behind one named barrier that only they join (bar.sync 1), then one
//     more redux and ballot over the warps' minima pick the lowest warp;
//   * static mode: each lane computes both of its keys for edge j+1 (as it
//     stands, and as it would stand after winning edge j) while edge j's
//     argmin runs, so a link of the chain is redux -> ballot -> select
//     (-> barrier -> redux -> ballot with several warps). Range mode's
//     normalizer needs every counter after the commit: its max/min of e_c
//     are two more reductions (and a second barrier) after it;
//   * edge j+1's mask words and weights are read from shared memory while
//     edge j is scored;
//   * the stream is walked in TILES, which shared memory double-buffers:
//     while the chain warps run tile t, the staging warps (1-7, or the 8
//     after the chain warps) stage tile t+1 into the other half of the
//     buffer and gather its masks from memb.
// A tile is not a commit block. Two ways to keep the block-start rule:
//   * patched (WINDOW, whose tiles may cut the stream anywhere since any
//     block size equals the scan: tiles of 64 edges, as its in-tile replay
//     sweeps the rest of the tile for every valid edge — a table built
//     during the chain instead, a lookup an edge, ran ~2x slower: the chain
//     warp issues in order, so each lookup's dependent loads stall it; and
//     frozen blocks that fit in one tile, T = B): after tile t's chain its
//     parts are written and entered in a hash table in shared memory (memb
//     word -> the bits tile t set in it), the table is committed to memb
//     with one atomic a word, and tile t+1's masks, gathered before those
//     commits, are patched from it — the WINDOW replay applied across the
//     tile boundary, which also gives exactly the block-start state of a
//     frozen block t+1;
//   * deferred (frozen blocks longer than a patched tile: ⌈B/1,024⌉ tiles
//     or more a block, all gathered against the block-start memb): no
//     commit of a block may reach memb before its last tile is gathered.
//     The staging warps commit the block's earlier tiles during its last
//     tile's chain (no gather of the block is left), then, after that
//     chain, all warps commit the last tile and gather the next block's
//     first tile (its edges were staged meanwhile): one gather bubble a
//     block. A table for the whole block would not fit (8 slots an edge at
//     4,096 edges is 256 KB), so the bubble was chosen over a smaller
//     table. Commits are deduplicated within a warp (__match_any_sync, an
//     OR of the lanes' bits) so that a hub costs one atomic a warp.
// Two kernels share this design. Frozen blocks of p <= 32 parts whose
// double buffer and table fit (B <= 2,048; 1,584 with weights; the main
// path's 256) run ebg_commit_pipe_kernel, the patched one-warp case kept as
// a kernel of its own: the same chain loop inside the general kernel
// schedules ~7 % slower there (scripts/probe_ebg_commit.py). Every other
// launch of p <= 1,024 runs ebg_commit_tiled_kernel.
// p > 1,024 (beyond ⌈W/2⌉ <= 16 chain warps) runs the WIDE kernel: one CTA
// with block-wide reductions, the per-edge staging in a global workspace,
// each thread scoring several parts in turn; no overlap, only to be right.
// memb (16 MB at 2^22 vertices and p = 32) stays in global memory, where
// L2 holds it; it is read through L2 (ld.cg) so that the commits (atomics
// at L2) are seen by the next gather.
//
// Bit parity: the score is the reference's arithmetic as XLA compiles it on
// the CPU, where `gain + ce*e*norm + cv*v*inv_v` becomes two fused
// multiply-adds, fma(cv*v, inv_v, fma(ce*e, norm, gain)) — that is what
// the pinned reference outputs were computed with. The two FMAs are written
// out (__fmaf_rn); everything else is built with -fmad=false and written
// with __fmul_rn/__fadd_rn/__fdiv_rn, so nothing else is contracted and the
// range normalizer's division is IEEE. The u32 images order the scores as
// float comparison does once -0 is made +0 (x + 0.0f), and e_c as float
// max/min do, since counts are non-negative.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "memb_transpose.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kEmpty = 0xffffffffu;  // a lane with no memb word to commit
constexpr int kThreads = 256;             // K = 0: warp 0's chain and 7 staging warps
constexpr int kStageWarps = 8;            // K >= 1: staging warps after the chain warps
constexpr int kMultiThreads = 768;        // K >= 1: at most 16 chain warps + 8
constexpr int kMaxPipeParts = 1024;       // more parts run the WIDE kernel
constexpr int kDeferredTile = 1024;       // the longest tile of a deferred block
constexpr int kWindowTile = 64;           // WINDOW's tile: its replay sweeps the rest of the tile
constexpr size_t kMaxSmem = 232448;
// K >= 1: each chain warp's min key [2][32] (by edge parity), then its max
// and min of e_c [2][2][32] (by call parity).
constexpr size_t kScratch = 6 * 32 * 4;

// ------------------------------------------------------------ helpers

__device__ __forceinline__ uint32_t score_key(float s) {
  const uint32_t b = __float_as_uint(__fadd_rn(s, 0.0f));  // -0 -> +0: they tie
  return b ^ ((uint32_t)((int)b >> 31) | 0x80000000u);
}

__device__ __forceinline__ void better(float& s, int& i, float s2, int i2) {
  if (s2 < s || (s2 == s && i2 < i)) {
    s = s2;
    i = i2;
  }
}

__device__ __forceinline__ void warp_argmin(float& s, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float s2 = __shfl_xor_sync(kFull, s, off);
    int i2 = __shfl_xor_sync(kFull, i, off);
    better(s, i, s2, i2);
  }
}

__device__ __forceinline__ void warp_maxmin(float& mx, float& mn) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    mn = fminf(mn, __shfl_xor_sync(kFull, mn, off));
  }
}

__device__ __forceinline__ void bar_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
}

struct Coef {
  float ce, cv, inv_e, inv_v, eps;
};

__device__ __forceinline__ Coef load_coef(const float* coef) {
  return Coef{coef[0], coef[1], coef[2], coef[3], coef[4]};
}

// --------------------------------------------- p <= 1,024: the pipelined kernel

// One half of the double buffer: a tile's edges and miss masks (W words an
// endpoint, edge-major: word w of edge j at j·W + w).
struct Buf {
  int* u;
  int* v;
  int* ok;
  int* win;  // the chain's record: K = 0 the ballot of the lanes at the min (lowest = the part),
             // 0 for a pad; K >= 1 the part, p for a pad
  uint32_t* mu;  // miss-u mask (bit i of word w: part 32w+i lacks u)
  uint32_t* mv;
  float* wu;
  float* wv;
};

// The half of the double buffer at `base` (pointers computed, not stored,
// so that they stay shared-memory addresses): a block of B edges, W = 1.
__device__ __forceinline__ Buf buf_at(unsigned char* base, int B) {
  int* i32 = reinterpret_cast<int*>(base);
  Buf b;
  b.u = i32;
  b.v = i32 + B;
  b.ok = i32 + 2 * B;
  b.win = i32 + 3 * B;
  b.mu = reinterpret_cast<uint32_t*>(i32 + 4 * B);
  b.mv = b.mu + B;
  b.wu = reinterpret_cast<float*>(b.mv + B);
  b.wv = b.wu + B;
  return b;
}

__host__ __device__ __forceinline__ size_t buf_bytes(int B, bool weighted) {
  return (size_t)B * 4 * (weighted ? 8 : 6);
}

// The same for a tile of T edges and W mask words an endpoint.
__device__ __forceinline__ Buf tile_at(unsigned char* base, int T, int W) {
  int* i32 = reinterpret_cast<int*>(base);
  Buf b;
  b.u = i32;
  b.v = i32 + T;
  b.ok = i32 + 2 * T;
  b.win = i32 + 3 * T;
  b.mu = reinterpret_cast<uint32_t*>(i32 + 4 * T);
  b.mv = b.mu + (size_t)T * W;
  b.wu = reinterpret_cast<float*>(b.mv + (size_t)T * W);
  b.wv = b.wu + T;
  return b;
}

__host__ __device__ __forceinline__ size_t tile_bytes(int T, int W, bool weighted) {
  return (size_t)T * 4 * (4 + 2 * W + (weighted ? 2 : 0));
}

// memb word -> OR of the bits a block (tile) set in it (open addressing).
__device__ __forceinline__ int slot_of(int x, int hbits) {
  return (int)(((uint32_t)x * 2654435761u) >> (32 - hbits));
}

__device__ __forceinline__ void table_add(int* keys, uint32_t* bits, int hbits, int x,
                                          uint32_t bit) {
  const int mask = (1 << hbits) - 1;
  for (int h = slot_of(x, hbits);; h = (h + 1) & mask) {
    const int old = keys[h] == x ? x : atomicCAS(keys + h, -1, x);
    if (old == -1 || old == x) {
      atomicOr(bits + h, bit);
      return;
    }
  }
}

__device__ __forceinline__ uint32_t table_get(const int* keys, const uint32_t* bits, int hbits,
                                              int x) {
  const int mask = (1 << hbits) - 1;
  for (int h = slot_of(x, hbits);; h = (h + 1) & mask) {
    const int k = keys[h];
    if (k == x) return bits[h];
    if (k == -1) return 0u;
  }
}

// Stage block `blk` into `buf` and gather its masks from memb (W = 1).
template <bool WEIGHTED>
__device__ __forceinline__ void stage(const Buf buf, const uint32_t* memb, const int* u,
                                      const int* v, const uint8_t* valid, const float* wu,
                                      const float* wv, size_t base, int B, int tid, int nthreads) {
  for (int j = tid; j < B; j += nthreads) {
    const int uu = u[base + j], vv = v[base + j];
    buf.u[j] = uu;
    buf.v[j] = vv;
    buf.ok[j] = valid[base + j] != 0;
    if (WEIGHTED) {
      buf.wu[j] = wu[base + j];
      buf.wv[j] = wv[base + j];
    }
    buf.mu[j] = ~__ldcg(memb + uu);
    buf.mv[j] = ~__ldcg(memb + vv);
  }
}

// The masks of edges [base, base + L) into `buf`, W words an endpoint (the
// ids are read again from global memory: one edge's words go to several
// threads).
__device__ __forceinline__ void gather_masks(const Buf buf, const uint32_t* memb, const int* u,
                                             const int* v, size_t base, int L, int W, int tid,
                                             int nthreads) {
  for (int k = tid; k < L * W; k += nthreads) {
    const int j = k / W, w = k - j * W;
    buf.mu[k] = ~__ldcg(memb + (size_t)u[base + j] * W + w);
    buf.mv[k] = ~__ldcg(memb + (size_t)v[base + j] * W + w);
  }
}

// Stage the tile of edges [base, base + L) into `buf`, and gather their
// masks from memb unless `masks` is false (a deferred block's first tile,
// gathered after the block before it commits).
template <bool WEIGHTED>
__device__ __forceinline__ void stage_tile(const Buf buf, const uint32_t* memb, const int* u,
                                      const int* v, const uint8_t* valid, const float* wu,
                                      const float* wv, size_t base, int L, int W, bool masks,
                                      int tid, int nthreads) {
  for (int j = tid; j < L; j += nthreads) {
    const int uu = u[base + j], vv = v[base + j];
    buf.u[j] = uu;
    buf.v[j] = vv;
    buf.ok[j] = valid[base + j] != 0;
    if (WEIGHTED) {
      buf.wu[j] = wu[base + j];
      buf.wv[j] = wv[base + j];
    }
    if (W == 1 && masks) {
      buf.mu[j] = ~__ldcg(memb + uu);
      buf.mv[j] = ~__ldcg(memb + vv);
    }
  }
  if (W > 1 && masks) gather_masks(buf, memb, u, v, base, L, W, tid, nthreads);
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// One edge's inputs as warp 0 holds them: the miss-mask words (a lane's
// bit becomes a 0/1 float where the score needs it, so a load is not
// waited for until then), the weights, the endpoints (WINDOW) and valid.
struct Edge {
  uint32_t mu, mv;
  float wu, wv;
  int u, v, ok;
};

template <bool WEIGHTED, bool WINDOW>
__device__ __forceinline__ Edge load_edge(const Buf cur, int j) {
  Edge e{cur.mu[j], cur.mv[j], 0.0f, 0.0f, -1, -1, cur.ok[j]};
  if (WEIGHTED) e.wu = cur.wu[j], e.wv = cur.wv[j];
  if (WINDOW) e.u = cur.u[j], e.v = cur.v[j];
  return e;
}

__device__ __forceinline__ float bit_f(uint32_t word, int lane) {
  return (float)((word >> lane) & 1u);
}

template <bool WEIGHTED, class E>
__device__ __forceinline__ float gain_of(const E& e, uint32_t mu_w, uint32_t mv_w, int lane) {
  const float mu = bit_f(mu_w, lane), mv = bit_f(mv_w, lane);
  return WEIGHTED ? __fadd_rn(__fmul_rn(e.wu, mu), __fmul_rn(e.wv, mv)) : __fadd_rn(mu, mv);
}

__device__ __forceinline__ float score_of(const Coef& cf, float e_c, float v_c, float norm,
                                          float gain) {
  return __fmaf_rn(__fmul_rn(cf.cv, v_c), cf.inv_v, __fmaf_rn(__fmul_rn(cf.ce, e_c), norm, gain));
}

template <bool RANGE>
__device__ __forceinline__ float norm_of(const Coef& cf, float e_c, bool part_lane) {
  if (!RANGE) return cf.inv_e;
  const uint32_t eb = __float_as_uint(e_c);
  const float mx = __uint_as_float(__reduce_max_sync(kFull, part_lane ? eb : 0u));
  const float mn = __uint_as_float(__reduce_min_sync(kFull, part_lane ? eb : kFull));
  return __fdiv_rn(1.0f, __fadd_rn(cf.eps, __fsub_rn(mx, mn)));
}

// K = 0: warp 0's sequential pass over one tile. Per edge the chain is: the
// argmin key -> redux min -> ballot of the lanes at the min -> "this lane
// won" (lowest such lane, valid edge). In static mode each lane computes,
// in the shadow of the redux, both of its keys for the next edge — as it
// stands, and as it would stand after winning this one (counters +1 and
// +mu+mv; WINDOW: its own miss bits of the next edge cleared where the two
// edges share an endpoint) — and the ballot selects one. The edge after
// next is read from shared memory meanwhile. Range mode's normalizer needs
// every counter after the commit, so it computes the next key after it.
template <bool RANGE, bool WEIGHTED, bool WINDOW>
__device__ __forceinline__ void chain(const Buf cur, int B, int p, const Coef& cf, float& e_c,
                                      float& v_c) {
  const int lane = threadIdx.x;
  const bool part_lane = lane < p;
  const unsigned lt = lanemask_lt();
  const uint32_t own = 1u << lane;
  Edge e = load_edge<WEIGHTED, WINDOW>(cur, 0);
  Edge n = load_edge<WEIGHTED, WINDOW>(cur, min(1, B - 1));
  float norm = norm_of<RANGE>(cf, e_c, part_lane);
  uint32_t key = score_key(score_of(cf, e_c, v_c, norm, gain_of<WEIGHTED>(e, e.mu, e.mv, lane)));
  if (!part_lane) key = kFull;
  for (int j = 0; j < B; ++j) {
    // ---- the chain's start: this edge's argmin.
    const uint32_t kmin = __reduce_min_sync(kFull, key);
    // ---- in its shadow: the edge after next, and the next edge's two keys.
    Edge nn = load_edge<WEIGHTED, WINDOW>(cur, min(j + 2, B - 1));
    uint32_t nmu_w = n.mu, nmv_w = n.mv;  // the next edge's masks if this lane wins
    if (WINDOW) {
      if (n.u == e.u || n.u == e.v) nmu_w &= ~own;
      if (n.v == e.u || n.v == e.v) nmv_w &= ~own;
    }
    const float e_w = __fadd_rn(e_c, 1.0f);
    const float v_w = __fadd_rn(v_c, __fadd_rn(bit_f(e.mu, lane), bit_f(e.mv, lane)));
    uint32_t key_stay = 0u, key_won = 0u;
    if (!RANGE) {
      key_stay = score_key(score_of(cf, e_c, v_c, cf.inv_e, gain_of<WEIGHTED>(n, n.mu, n.mv, lane)));
      key_won = score_key(score_of(cf, e_w, v_w, cf.inv_e, gain_of<WEIGHTED>(n, nmu_w, nmv_w, lane)));
    }
    // ---- the chain's end: the lowest lane at the min takes a valid edge.
    const uint32_t at_min = __ballot_sync(kFull, key == kmin);
    const bool won = e.ok && key == kmin && !(at_min & lt);
    if (!RANGE) key = part_lane ? (won ? key_won : key_stay) : kFull;
    if (won) {
      e_c = e_w;
      v_c = v_w;
      n.mu = nmu_w;
      n.mv = nmv_w;
      if (WINDOW) {  // the edge after next, as the replay below leaves it
        if (nn.u == e.u || nn.u == e.v) nn.mu &= ~own;
        if (nn.v == e.u || nn.v == e.v) nn.mv &= ~own;
      }
    }
    // ---- off the chain: the record (the lanes at the min; the lowest won,
    // and 0 marks a pad), and WINDOW's replay onto the later edges (the
    // next two are in registers).
    cur.win[j] = e.ok ? (int)at_min : 0;
    if (WINDOW && e.ok) {
      const uint32_t clear = ~(at_min & (0u - at_min));
      for (int k = j + 3 + lane; k < B; k += 32) {
        const int uk = cur.u[k], vk = cur.v[k];
        if (uk == e.u || uk == e.v) cur.mu[k] &= clear;
        if (vk == e.u || vk == e.v) cur.mv[k] &= clear;
      }
      __syncwarp();
    }
    if (RANGE) {
      norm = norm_of<RANGE>(cf, e_c, part_lane);
      key = score_key(score_of(cf, e_c, v_c, norm, gain_of<WEIGHTED>(n, n.mu, n.mv, lane)));
      if (!part_lane) key = kFull;
    }
    e = n;
    n = nn;
  }
}

// K >= 1: one edge's inputs as a chain warp holds them: its KP mask words
// of each endpoint (words w0 .. w0+KP-1; 0 past W).
template <int KP>
struct EdgeM {
  uint32_t mu[KP], mv[KP];
  float wu, wv;
  int u, v, ok;
};

template <bool WEIGHTED, bool WINDOW, int KP>
__device__ __forceinline__ EdgeM<KP> load_edge_m(const Buf cur, int j, int W, int w0) {
  EdgeM<KP> e;
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const bool in = w0 + k < W;
    e.mu[k] = in ? cur.mu[j * W + w0 + k] : 0u;
    e.mv[k] = in ? cur.mv[j * W + w0 + k] : 0u;
  }
  e.wu = WEIGHTED ? cur.wu[j] : 0.0f;
  e.wv = WEIGHTED ? cur.wv[j] : 0.0f;
  e.u = WINDOW ? cur.u[j] : -1;
  e.v = WINDOW ? cur.v[j] : -1;
  e.ok = cur.ok[j];
  return e;
}

// Range mode's normalizer over every chain warp's parts: each warp's
// max/min of e_c (redux), published behind the chain warps' barrier, and
// reduced again. `red` is one [2][32] half of the scratch; callers alternate.
template <int KP>
__device__ __forceinline__ float norm_multi(const Coef& cf, const float (&e_c)[KP],
                                           const bool (&part)[KP], uint32_t* red, int Wc, int c,
                                           int lane) {
  uint32_t mx = 0u, mn = kFull;
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    if (part[k]) {
      const uint32_t b = __float_as_uint(e_c[k]);
      mx = max(mx, b);
      mn = min(mn, b);
    }
  }
  mx = __reduce_max_sync(kFull, mx);
  mn = __reduce_min_sync(kFull, mn);
  if (lane == 0) {
    red[c] = mx;
    red[32 + c] = mn;
  }
  bar_sync(1, 32 * Wc);
  mx = __reduce_max_sync(kFull, lane < Wc ? red[lane] : 0u);
  mn = __reduce_min_sync(kFull, lane < Wc ? red[32 + lane] : kFull);
  return __fdiv_rn(1.0f, __fadd_rn(cf.eps, __fsub_rn(__uint_as_float(mx), __uint_as_float(mn))));
}

// K >= 1: the chain over Wc warps, KP parts a lane (part 32·(c·KP + k) +
// lane of warp c). Per edge: each warp's redux min over its keys, stored
// for the others; in the barrier's shadow its lanes at that min (one
// ballot a k), the edge after next and, in static mode, both next keys of
// every part; after the barrier one redux over the warps' minima and one
// ballot name the lowest warp at the global min, whose lowest part at it
// (lowest k, then lowest lane) takes a valid edge. That warp also runs
// WINDOW's replay of its winning word onto the tile's later edges.
template <bool RANGE, bool WEIGHTED, bool WINDOW, int KP>
__device__ __forceinline__ void chain_multi(const Buf cur, int L, int p, int W, int Wc,
                                            const Coef& cf, float (&e_c)[KP], float (&v_c)[KP],
                                            uint32_t* scratch) {
  const int lane = threadIdx.x & 31, c = threadIdx.x >> 5, w0 = c * KP;
  const unsigned lt = lanemask_lt();
  const uint32_t own = 1u << lane;
  const int nchain = 32 * Wc;
  uint32_t* const cand = scratch;      // [2][32]
  uint32_t* const red = scratch + 64;  // [2][2][32]
  int rpar = 0;
  bool part[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) part[k] = 32 * (w0 + k) + lane < p;
  EdgeM<KP> e = load_edge_m<WEIGHTED, WINDOW, KP>(cur, 0, W, w0);
  EdgeM<KP> n = load_edge_m<WEIGHTED, WINDOW, KP>(cur, min(1, L - 1), W, w0);
  float norm = cf.inv_e;
  if (RANGE) {
    norm = norm_multi<KP>(cf, e_c, part, red + 64 * rpar, Wc, c, lane);
    rpar ^= 1;
  }
  uint32_t key[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k)
    key[k] = part[k] ? score_key(score_of(cf, e_c[k], v_c[k], norm,
                                          gain_of<WEIGHTED>(e, e.mu[k], e.mv[k], lane)))
                     : kFull;
  for (int j = 0; j < L; ++j) {
    // ---- the chain's start: this warp's min, published.
    uint32_t lmin = key[0];
#pragma unroll
    for (int k = 1; k < KP; ++k) lmin = min(lmin, key[k]);
    const uint32_t kw = __reduce_min_sync(kFull, lmin);
    if (lane == 0) cand[32 * (j & 1) + c] = kw;
    // ---- in the barrier's shadow.
    unsigned at[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) at[k] = __ballot_sync(kFull, key[k] == kw);
    EdgeM<KP> nn = load_edge_m<WEIGHTED, WINDOW, KP>(cur, min(j + 2, L - 1), W, w0);
    uint32_t nmu_w[KP], nmv_w[KP], key_stay[KP], key_won[KP];
    float e_w[KP], v_w[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      nmu_w[k] = n.mu[k];
      nmv_w[k] = n.mv[k];
      if (WINDOW) {
        if (n.u == e.u || n.u == e.v) nmu_w[k] &= ~own;
        if (n.v == e.u || n.v == e.v) nmv_w[k] &= ~own;
      }
      e_w[k] = __fadd_rn(e_c[k], 1.0f);
      v_w[k] = __fadd_rn(v_c[k], __fadd_rn(bit_f(e.mu[k], lane), bit_f(e.mv[k], lane)));
      key_stay[k] = key_won[k] = 0u;
      if (!RANGE) {
        key_stay[k] = score_key(score_of(cf, e_c[k], v_c[k], cf.inv_e,
                                         gain_of<WEIGHTED>(n, n.mu[k], n.mv[k], lane)));
        key_won[k] = score_key(score_of(cf, e_w[k], v_w[k], cf.inv_e,
                                        gain_of<WEIGHTED>(n, nmu_w[k], nmv_w[k], lane)));
      }
    }
    bar_sync(1, nchain);
    // ---- the chain's end: the lowest warp at the global min.
    const uint32_t ck = lane < Wc ? cand[32 * (j & 1) + lane] : kFull;
    const uint32_t kmin = __reduce_min_sync(kFull, ck);
    const unsigned wm = __ballot_sync(kFull, ck == kmin);
    const bool mine = e.ok && (wm & (0u - wm)) == (1u << c);
    bool taken = false;
    unsigned first = 0u;  // the ballot of this warp's first word at its min
    int wk = 0;
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      const bool won = mine && !taken && (at[k] & own) && !(at[k] & lt);
      if (!taken && at[k]) first = at[k], wk = k;
      taken = taken || at[k] != 0u;
      if (!RANGE) key[k] = part[k] ? (won ? key_won[k] : key_stay[k]) : kFull;
      if (won) {
        e_c[k] = e_w[k];
        v_c[k] = v_w[k];
        n.mu[k] = nmu_w[k];
        n.mv[k] = nmv_w[k];
        if (WINDOW) {  // the edge after next, as the replay below leaves it
          if (nn.u == e.u || nn.u == e.v) nn.mu[k] &= ~own;
          if (nn.v == e.u || nn.v == e.v) nn.mv[k] &= ~own;
        }
        cur.win[j] = 32 * (w0 + k) + lane;
      }
    }
    // ---- off the chain: a pad's record, and WINDOW's replay.
    if (!e.ok && threadIdx.x == 0) cur.win[j] = p;
    if (WINDOW && mine) {
      const uint32_t clear = ~(first & (0u - first));
      const int word = w0 + wk;
      for (int q = j + 3 + lane; q < L; q += 32) {
        const int uq = cur.u[q], vq = cur.v[q];
        if (uq == e.u || uq == e.v) cur.mu[q * W + word] &= clear;
        if (vq == e.u || vq == e.v) cur.mv[q * W + word] &= clear;
      }
      __syncwarp();
    }
    if (RANGE) {
      norm = norm_multi<KP>(cf, e_c, part, red + 64 * rpar, Wc, c, lane);
      rpar ^= 1;
#pragma unroll
      for (int k = 0; k < KP; ++k)
        key[k] = part[k] ? score_key(score_of(cf, e_c[k], v_c[k], norm,
                                              gain_of<WEIGHTED>(n, n.mu[k], n.mv[k], lane)))
                         : kFull;
    }
    e = n;
    n = nn;
  }
}

// p <= 32, a frozen block a tile (its double buffer and table fit): warp 0's
// chain over block b while warps 1-7 stage block b+1; block b's commits
// patch block b+1 through the table. The tiled kernel below does the same
// at any p and block; this one is its K = 0 patched frozen case, kept as it
// was first written (with buf_at, buf_bytes and stage, its own helpers),
// since the same loop compiled inside the tiled kernel ran ~7 % slower, and
// the main path's blocks of 256 run it.
template <bool RANGE, bool WEIGHTED>
__global__ void __launch_bounds__(kThreads)
    ebg_commit_pipe_kernel(uint32_t* __restrict__ memb, float* __restrict__ e_count,
                           float* __restrict__ v_count, const int* __restrict__ u,
                           const int* __restrict__ v, const uint8_t* __restrict__ valid,
                           const float* __restrict__ wu, const float* __restrict__ wv,
                           const float* __restrict__ coef, int* __restrict__ parts, int p, int B,
                           int nblocks, int hbits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t bb = buf_bytes(B, WEIGHTED);
  const int H = 1 << hbits;
  int* tkey = reinterpret_cast<int*>(smem_raw + 2 * bb);
  uint32_t* tbits = reinterpret_cast<uint32_t*>(tkey + H);

  const int t = threadIdx.x;
  const int warp = t >> 5;
  const Coef cf = load_coef(coef);
  float e_c = 0.0f, v_c = 0.0f;  // warp 0: part `lane`'s counters
  if (t < p) {
    e_c = e_count[t];
    v_c = v_count[t];
  }
  stage<WEIGHTED>(buf_at(smem_raw, B), memb, u, v, valid, wu, wv, 0, B, t, kThreads);
  for (int i = t; i < H; i += kThreads) tkey[i] = -1, tbits[i] = 0u;
  __syncthreads();

  for (int blk = 0; blk < nblocks; ++blk) {
    const Buf cur = buf_at(smem_raw + (blk & 1) * bb, B);
    const Buf nxt = buf_at(smem_raw + ((blk + 1) & 1) * bb, B);
    const bool has_next = blk + 1 < nblocks;
    const size_t base = (size_t)blk * B;
    // ---- warp 0: block b's chain; warps 1-7: stage block b+1.
    if (warp == 0) {
      chain<RANGE, WEIGHTED, false>(cur, B, p, cf, e_c, v_c);
    } else if (has_next) {
      stage<WEIGHTED>(nxt, memb, u, v, valid, wu, wv, base + B, B, t - 32, kThreads - 32);
    }
    __syncthreads();
    // ---- commit block b: its parts, and a table of the parts each vertex
    // joined (a hub shared by the whole block takes one slot).
    for (int j = t; j < B; j += kThreads) {
      const uint32_t at_min = (uint32_t)cur.win[j];
      const int row = at_min ? __ffs(at_min) - 1 : p;
      parts[base + j] = row;
      if (row < p) {
        table_add(tkey, tbits, hbits, cur.u[j], 1u << row);
        table_add(tkey, tbits, hbits, cur.v[j], 1u << row);
      }
    }
    __syncthreads();
    // ---- patch block b+1's masks with b's commits, and commit them to
    // memb (one atomic a vertex).
    for (int i = t; i < H; i += kThreads) {
      const int x = tkey[i];
      if (x >= 0) atomicOr(memb + x, tbits[i]);
    }
    if (!has_next) break;
    for (int k = t; k < B; k += kThreads) {
      nxt.mu[k] &= ~table_get(tkey, tbits, hbits, nxt.u[k]);
      nxt.mv[k] &= ~table_get(tkey, tbits, hbits, nxt.v[k]);
    }
    __syncthreads();
    if (warp != 0)
      for (int i = t - 32; i < H; i += kThreads - 32) tkey[i] = -1, tbits[i] = 0u;
  }
  if (t < p) {
    e_count[t] = e_c;
    v_count[t] = v_c;
  }
}

template <int K>
__device__ __forceinline__ int row_of(int win, int p) {
  return K == 0 ? (win ? __ffs(win) - 1 : p) : win;
}

// One bit of a memb word from each lane (kEmpty: none): the lanes of one
// word OR their bits and the lowest commits them with one atomic.
__device__ __forceinline__ void commit_bits(uint32_t* memb, uint32_t word, uint32_t bit) {
  const unsigned g = __match_any_sync(kFull, word);
  const uint32_t bits = __reduce_or_sync(g, bit);
  if (word != kEmpty && !(g & lanemask_lt())) atomicOr(memb + word, bits);
}

// Commit stream edges [lo, hi) to memb, warp `wid` of `nw` taking 32 at a
// time. Their parts are read from `parts` (written earlier in the launch),
// except from `sbase` on, where they come from the tile in `buf` and are
// written to `parts` here.
template <int K>
__device__ void commit_range(uint32_t* memb, int* parts, const int* u, const int* v, size_t lo,
                             size_t hi, const Buf buf, size_t sbase, int p, int W, int wid,
                             int nw) {
  const int lane = threadIdx.x & 31;
  for (size_t j0 = lo + (size_t)wid * 32; j0 < hi; j0 += (size_t)nw * 32) {
    const size_t j = j0 + lane;
    uint32_t word_u = kEmpty, word_v = kEmpty, bit = 0u;
    if (j < hi) {
      int row, x, y;
      if (j >= sbase) {
        const int s = (int)(j - sbase);
        row = row_of<K>(buf.win[s], p);
        parts[j] = row;
        x = buf.u[s];
        y = buf.v[s];
      } else {
        row = parts[j];
        x = u[j];
        y = v[j];
      }
      if (row < p) {
        bit = 1u << (row & 31);
        word_u = (uint32_t)x * W + (row >> 5);
        word_v = (uint32_t)y * W + (row >> 5);
      }
    }
    commit_bits(memb, word_u, bit);
    commit_bits(memb, word_v, bit);
  }
}

// The pipelined kernel. Threads: K = 0, warp 0 is the chain and warps 1-7
// stage; K >= 1, warps 0..Wc-1 are the chain (Wc = ⌈W/K⌉) and the 8 after
// them stage. Tiles of T edges (see the top of the file): DEFERRED false,
// patched tiles over the stream (frozen: T = B); true, ⌈B/T⌉ tiles a frozen
// block. hbits: the patch table's 2^hbits slots (patched only).
template <bool RANGE, bool WEIGHTED, bool WINDOW, int K, bool DEFERRED>
__global__ void __launch_bounds__(K == 0 ? kThreads : kMultiThreads)
    ebg_commit_tiled_kernel(uint32_t* __restrict__ memb, float* __restrict__ e_count,
                           float* __restrict__ v_count, const int* __restrict__ u,
                           const int* __restrict__ v, const uint8_t* __restrict__ valid,
                           const float* __restrict__ wu, const float* __restrict__ wv,
                           const float* __restrict__ coef, int* __restrict__ parts, int p, int B,
                           int nblocks, int T, int hbits) {
  constexpr int KP = K == 0 ? 1 : K;  // parts a chain lane holds
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = K == 0 ? 1 : (p + 31) >> 5;
  const int Wc = K == 0 ? 1 : (W + K - 1) / K;
  const int nth = blockDim.x;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const bool chain_warp = warp < Wc;
  const int st = t - 32 * Wc, sth = nth - 32 * Wc;  // the staging threads
  uint32_t* const scratch = reinterpret_cast<uint32_t*>(smem_raw);
  unsigned char* const bufs = smem_raw + (K == 0 ? 0 : kScratch);
  const size_t bb = tile_bytes(T, W, WEIGHTED);
  const int H = DEFERRED ? 0 : 1 << hbits;
  int* const tkey = reinterpret_cast<int*>(bufs + 2 * bb);
  uint32_t* const tbits = reinterpret_cast<uint32_t*>(tkey + H);
  const Coef cf = load_coef(coef);

  const size_t n = (size_t)nblocks * B;
  const int nt = DEFERRED ? (B + T - 1) / T : 1;  // tiles a block (deferred)
  const long long ntiles = DEFERRED ? (long long)nblocks * nt : (long long)((n + T - 1) / T);
  auto tile_start = [&](long long i) -> size_t {
    return DEFERRED ? (size_t)(i / nt) * B + (size_t)(i % nt) * T : (size_t)i * T;
  };
  auto tile_len = [&](long long i) -> int {
    if (DEFERRED) return min(T, B - (int)(i % nt) * T);
    const size_t rest = n - (size_t)i * T;
    return rest < (size_t)T ? (int)rest : T;
  };

  float e_c[KP], v_c[KP];  // chain lanes: their parts' counters
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int i = 32 * (warp * KP + k) + (t & 31);
    e_c[k] = chain_warp && i < p ? e_count[i] : 0.0f;
    v_c[k] = chain_warp && i < p ? v_count[i] : 0.0f;
  }
  stage_tile<WEIGHTED>(tile_at(bufs, T, W), memb, u, v, valid, wu, wv, 0, tile_len(0), W, true, t,
                       nth);
  for (int i = t; i < H; i += nth) tkey[i] = -1, tbits[i] = 0u;
  __syncthreads();

  for (long long i = 0; i < ntiles; ++i) {
    const Buf cur = tile_at(bufs + (i & 1) * bb, T, W);
    const Buf nxt = tile_at(bufs + ((i + 1) & 1) * bb, T, W);
    const size_t start = tile_start(i);
    const int L = tile_len(i);
    const bool has_next = i + 1 < ntiles;
    const int k_in = DEFERRED ? (int)(i % nt) : 0;  // the tile's place in its block
    const bool block_end = DEFERRED && k_in == nt - 1;
    // ---- the chain warps: tile i's chain; the staging warps: tile i+1.
    if (chain_warp) {
      if constexpr (K == 0) {
        chain<RANGE, WEIGHTED, WINDOW>(cur, L, p, cf, e_c[0], v_c[0]);
      } else {
        chain_multi<RANGE, WEIGHTED, WINDOW, KP>(cur, L, p, W, Wc, cf, e_c, v_c, scratch);
      }
    } else {
      if (block_end) {
        // The block's earlier tiles (the last of them still in nxt, its
        // parts written here) commit now: none of its gathers is left.
        commit_range<K>(memb, parts, u, v, start - (size_t)(nt - 1) * T, start, nxt, start - T,
                        p, W, warp - Wc, sth >> 5);
        bar_sync(2, sth);
      } else if (DEFERRED && k_in > 0) {
        // The previous tile's parts (staging does not touch `win`).
        for (int j = st; j < T; j += sth) parts[start - T + j] = row_of<K>(nxt.win[j], p);
      }
      if (has_next)
        stage_tile<WEIGHTED>(nxt, memb, u, v, valid, wu, wv, tile_start(i + 1), tile_len(i + 1),
                             W, !block_end, st, sth);
    }
    __syncthreads();
    if (!DEFERRED) {
      // ---- commit tile i: its parts, and a table of the bits it set in
      // each memb word (a hub shared by the whole tile takes one slot).
      for (int j = t; j < L; j += nth) {
        const int row = row_of<K>(cur.win[j], p);
        parts[start + j] = row;
        if (row < p) {
          const uint32_t bit = 1u << (row & 31);
          table_add(tkey, tbits, hbits, cur.u[j] * W + (row >> 5), bit);
          table_add(tkey, tbits, hbits, cur.v[j] * W + (row >> 5), bit);
        }
      }
      __syncthreads();
      // ---- patch tile i+1's masks with tile i's commits, and commit them
      // to memb (one atomic a word).
      for (int h = t; h < H; h += nth) {
        const int x = tkey[h];
        if (x >= 0) atomicOr(memb + x, tbits[h]);
      }
      if (!has_next) break;
      const int nL = tile_len(i + 1);
      for (int k = t; k < nL * W; k += nth) {
        const int j = k / W, w = k - j * W;
        nxt.mu[k] &= ~table_get(tkey, tbits, hbits, nxt.u[j] * W + w);
        nxt.mv[k] &= ~table_get(tkey, tbits, hbits, nxt.v[j] * W + w);
      }
      __syncthreads();
      if (!chain_warp)
        for (int h = st; h < H; h += sth) tkey[h] = -1, tbits[h] = 0u;
    } else if (block_end) {
      // ---- the gather bubble: the block's last tile commits, then the
      // next block's first tile (staged meanwhile) gathers its masks.
      commit_range<K>(memb, parts, u, v, start, start + L, cur, start, p, W, warp, nth >> 5);
      __syncthreads();
      if (has_next) {
        gather_masks(nxt, memb, u, v, tile_start(i + 1), tile_len(i + 1), W, t, nth);
        __syncthreads();
      }
    }
  }
  if (chain_warp) {
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      const int i = 32 * (warp * KP + k) + (t & 31);
      if (i < p) {
        e_count[i] = e_c[k];
        v_count[i] = v_c[k];
      }
    }
  }
}

// ------------------------------------------------ p > 1,024: the WIDE kernel

struct Smem {
  uint32_t* mu;   // [B * W] miss-u masks, word w covers parts 32w..32w+31
  uint32_t* mv;   // [B * W]
  int* su;        // [B]
  int* sv;        // [B]
  int* sval;      // [B]
  float* swu;     // [B]
  float* swv;     // [B]
  int* swin;      // [B] committed part per edge
  float* red_f;   // [4 * 32] block reductions (max, min, argmin score x2)
  int* red_i;     // [2 * 32] argmin index, double-buffered by edge parity
};

// Bytes of a block's per-edge staging (mu .. swin), in the workspace.
__host__ __device__ __forceinline__ size_t stage_bytes(int p, int B) {
  const size_t W = (size_t)(p + 31) / 32;
  return (size_t)B * (2 * W * 4 + 6 * 4);
}

constexpr size_t kWideSmem = 4 * 32 * 4 + 2 * 32 * 4;  // red_f and red_i

// One CTA of 1,024 threads walks the blocks in order: the per-edge staging
// lives in the global workspace `ws`, thread t scores parts t, t + 1,024,
// ... in turn and folds them into its argmin (and, in range mode, into its
// max/min of e_c) before the warp and CTA reductions, and keeps their
// counters in e_count/v_count, which only it touches.
template <bool RANGE, bool WEIGHTED, bool WINDOW>
__global__ void __launch_bounds__(1024)
    ebg_commit_wide_kernel(uint32_t* __restrict__ memb, float* __restrict__ e_count,
                           float* __restrict__ v_count, const int* __restrict__ u,
                           const int* __restrict__ v, const uint8_t* __restrict__ valid,
                           const float* __restrict__ wu, const float* __restrict__ wv,
                           const float* __restrict__ coef, int* __restrict__ parts, int p, int B,
                           int nblocks, unsigned char* __restrict__ ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = (p + 31) >> 5;
  Smem sm;
  sm.mu = reinterpret_cast<uint32_t*>(ws);
  sm.mv = sm.mu + (size_t)B * W;
  sm.su = reinterpret_cast<int*>(sm.mv + (size_t)B * W);
  sm.sv = sm.su + B;
  sm.sval = sm.sv + B;
  sm.swu = reinterpret_cast<float*>(sm.sval + B);
  sm.swv = sm.swu + B;
  sm.swin = reinterpret_cast<int*>(sm.swv + B);
  sm.red_f = reinterpret_cast<float*>(smem_raw);
  sm.red_i = reinterpret_cast<int*>(sm.red_f + 4 * 32);

  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nw = T >> 5;
  const float kPosInf = __int_as_float(0x7f800000);
  const Coef cf = load_coef(coef);

  for (int blk = 0; blk < nblocks; ++blk) {
    const size_t base = (size_t)blk * B;
    // ---- 1. stage the block and gather block-start miss masks.
    for (int j = t; j < B; j += T) {
      sm.su[j] = u[base + j];
      sm.sv[j] = v[base + j];
      sm.sval[j] = valid[base + j] != 0;
      if (WEIGHTED) {
        sm.swu[j] = wu[base + j];
        sm.swv[j] = wv[base + j];
      }
    }
    __syncthreads();
    for (int k = t; k < B * W; k += T) {
      const int j = k / W, w = k - j * W;
      sm.mu[k] = ~__ldcg(memb + (size_t)sm.su[j] * W + w);
      sm.mv[k] = ~__ldcg(memb + (size_t)sm.sv[j] * W + w);
    }
    __syncthreads();

    // ---- 2. the sequential per-edge argmin + exact counter commit.
    for (int j = 0; j < B; ++j) {
      // The gain of part i on edge j, and its miss bits.
      auto part_gain = [&](int i, float& mu, float& mv) {
        mu = (float)((sm.mu[j * W + (i >> 5)] >> (i & 31)) & 1u);
        mv = (float)((sm.mv[j * W + (i >> 5)] >> (i & 31)) & 1u);
        if (WEIGHTED) return __fadd_rn(__fmul_rn(sm.swu[j], mu), __fmul_rn(sm.swv[j], mv));
        return __fadd_rn(mu, mv);
      };
      float norm = cf.inv_e;
      if (RANGE) {
        float mx = -kPosInf, mn = kPosInf;
        for (int i = t; i < p; i += T) mx = fmaxf(mx, e_count[i]), mn = fminf(mn, e_count[i]);
        warp_maxmin(mx, mn);
        if (lane == 0) {
          sm.red_f[warp] = mx;
          sm.red_f[32 + warp] = mn;
        }
        __syncthreads();
        mx = sm.red_f[0];
        mn = sm.red_f[32];
        for (int w = 1; w < nw; ++w) {
          mx = fmaxf(mx, sm.red_f[w]);
          mn = fminf(mn, sm.red_f[32 + w]);
        }
        norm = __fdiv_rn(1.0f, __fadd_rn(cf.eps, __fsub_rn(mx, mn)));
      }
      float s = kPosInf;
      int win = 0x7fffffff;
      for (int i = t; i < p; i += T) {
        float a, b;
        const float g = part_gain(i, a, b);
        better(s, win, score_of(cf, e_count[i], v_count[i], norm, g), i);
      }
      warp_argmin(s, win);
      const int par = j & 1;
      if (lane == 0) {
        sm.red_f[64 + 32 * par + warp] = s;
        sm.red_i[32 * par + warp] = win;
      }
      __syncthreads();
      s = sm.red_f[64 + 32 * par];
      win = sm.red_i[32 * par];
      for (int w = 1; w < nw; ++w)
        better(s, win, sm.red_f[64 + 32 * par + w], sm.red_i[32 * par + w]);
      const bool ok = sm.sval[j] != 0;
      if (ok && win % T == t) {  // the thread that owns the winner
        float mu, mv;
        part_gain(win, mu, mv);
        e_count[win] = __fadd_rn(e_count[win], 1.0f);
        v_count[win] = __fadd_rn(v_count[win], __fadd_rn(mu, mv));
      }
      if (t == 0) sm.swin[j] = ok ? win : p;
      if (WINDOW && ok) {
        // Replay: later columns touching u_j or v_j no longer miss in `win`.
        const int uj = sm.su[j], vj = sm.sv[j];
        const int word = win >> 5;
        const uint32_t clear = ~(1u << (win & 31));
        for (int k = j + 1 + t; k < B; k += T) {
          const int uk = sm.su[k], vk = sm.sv[k];
          if (uk == uj || uk == vj) sm.mu[k * W + word] &= clear;
          if (vk == uj || vk == vj) sm.mv[k * W + word] &= clear;
        }
        __syncthreads();
      }
    }
    __syncthreads();

    // ---- 3. commit the winners' bits and write the block's parts.
    for (int j = t; j < B; j += T) {
      const int row = sm.swin[j];
      parts[base + j] = row;
      if (row < p) {
        const uint32_t bit = 1u << (row & 31);
        atomicOr(memb + (size_t)sm.su[j] * W + (row >> 5), bit);
        atomicOr(memb + (size_t)sm.sv[j] * W + (row >> 5), bit);
      }
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------ launch

// How a launch of p <= 1,024 parts is laid out.
struct Plan {
  int K;          // 0: one chain warp (p <= 32); 1: W chain warps; 2: ⌈W/2⌉ warps, two parts a lane
  int threads;
  int T;          // tile edges
  int hbits;      // patched: the table's 2^hbits slots
  bool deferred;  // frozen blocks of several tiles
  size_t smem;
};

int table_bits(int T) {  // at least 8T slots: at most 2T keys, load <= 1/4
  int bits = 6;
  while ((1 << bits) < 8 * T) ++bits;
  return bits;
}

size_t patched_smem(int T, int W, size_t scratch, bool weighted) {
  return scratch + 2 * tile_bytes(T, W, weighted) + ((size_t)8 << table_bits(T));
}

// The longest patched tile whose double buffer and table fit.
int patched_tile_max(int W, size_t scratch, bool weighted) {
  long long best = 0;
  for (int bits = 6; bits < 24; ++bits) {
    const long long room = (long long)kMaxSmem - (long long)scratch - (8LL << bits);
    if (room <= 0) break;
    const long long T =
        std::min<long long>((1LL << bits) / 8, room / (long long)(2 * tile_bytes(1, W, weighted)));
    best = std::max(best, T);
  }
  return (int)best;
}

Plan make_plan(int p, int B, bool weighted, bool window) {
  const int W = (p + 31) / 32;
  Plan pl;
  pl.K = W == 1 ? 0 : (W <= 16 ? 1 : 2);
  const int Wc = pl.K == 0 ? 1 : (W + pl.K - 1) / pl.K;
  pl.threads = pl.K == 0 ? kThreads : 32 * (Wc + kStageWarps);
  const size_t scratch = pl.K == 0 ? 0 : kScratch;
  const int tmax = patched_tile_max(W, scratch, weighted);
  if (window || B <= tmax) {
    pl.deferred = false;
    pl.T = std::min(B, window ? kWindowTile : tmax);
    pl.hbits = table_bits(pl.T);
    pl.smem = patched_smem(pl.T, W, scratch, weighted);
  } else {
    const long long room = (long long)(kMaxSmem - scratch);
    const int cap = (int)std::min<long long>(
        kDeferredTile, room / (long long)(2 * tile_bytes(1, W, weighted)));
    const int nt = std::max(2, (B + cap - 1) / cap);
    pl.deferred = true;
    pl.T = (B + nt - 1) / nt;
    pl.hbits = 0;
    pl.smem = scratch + 2 * tile_bytes(pl.T, W, weighted);
  }
  return pl;
}

struct Args {
  uint32_t* memb;
  float* e;
  float* vc;
  const int* u;
  const int* v;
  const uint8_t* valid;
  const float* wu;
  const float* wv;
  const float* coef;
  int* parts;
  unsigned char* ws;
  int p, B, nblocks;
};

template <bool RANGE, bool WEIGHTED, bool WINDOW, int K, bool DEFERRED>
cudaError_t launch_pipe(const Plan& pl, const Args& a, cudaStream_t stream) {
  auto kern = ebg_commit_tiled_kernel<RANGE, WEIGHTED, WINDOW, K, DEFERRED>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return err;
  kern<<<1, pl.threads, pl.smem, stream>>>(a.memb, a.e, a.vc, a.u, a.v, a.valid, a.wu, a.wv,
                                           a.coef, a.parts, a.p, a.B, a.nblocks, pl.T, pl.hbits);
  return cudaGetLastError();
}

template <bool RANGE, bool WEIGHTED, bool WINDOW>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.p > kMaxPipeParts) {
    auto kern = ebg_commit_wide_kernel<RANGE, WEIGHTED, WINDOW>;
    kern<<<1, 1024, kWideSmem, stream>>>(a.memb, a.e, a.vc, a.u, a.v, a.valid, a.wu, a.wv, a.coef,
                                         a.parts, a.p, a.B, a.nblocks, a.ws);
    return cudaGetLastError();
  }
  const size_t block_smem = 2 * buf_bytes(a.B, WEIGHTED) + ((size_t)8 << table_bits(a.B));
  if (!WINDOW && a.p <= 32 && block_smem <= kMaxSmem) {
    auto kern = ebg_commit_pipe_kernel<RANGE, WEIGHTED>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)block_smem);
    if (err != cudaSuccess) return err;
    kern<<<1, kThreads, block_smem, stream>>>(a.memb, a.e, a.vc, a.u, a.v, a.valid, a.wu, a.wv,
                                              a.coef, a.parts, a.p, a.B, a.nblocks,
                                              table_bits(a.B));
    return cudaGetLastError();
  }
  const Plan pl = make_plan(a.p, a.B, WEIGHTED, WINDOW);
  if (pl.deferred) {  // frozen only: WINDOW's tiles are always patched
    if (pl.K == 0) return launch_pipe<RANGE, WEIGHTED, false, 0, true>(pl, a, stream);
    if (pl.K == 1) return launch_pipe<RANGE, WEIGHTED, false, 1, true>(pl, a, stream);
    return launch_pipe<RANGE, WEIGHTED, false, 2, true>(pl, a, stream);
  }
  if (pl.K == 0) {
    if (WINDOW) return launch_pipe<RANGE, WEIGHTED, true, 0, false>(pl, a, stream);
    return cudaErrorInvalidValue;  // frozen p <= 32 blocks that fit run the kernel above
  }
  if (pl.K == 1) return launch_pipe<RANGE, WEIGHTED, WINDOW, 1, false>(pl, a, stream);
  return launch_pipe<RANGE, WEIGHTED, WINDOW, 2, false>(pl, a, stream);
}

}  // namespace

extern "C" {

// keep [p, vw] -> memb [32·vw, ⌈p/32⌉] (to_memb = 1), or back (to_memb = 0;
// rows of keep are overwritten whole). Returns cudaGetLastError.
int ebg_memb_transpose(const void* src, void* dst, int p, int vw, int to_memb, void* stream) {
  return (int)membt::launch_transpose(static_cast<const uint32_t*>(src),
                                      static_cast<uint32_t*>(dst), p, vw, to_memb != 0,
                                      static_cast<cudaStream_t>(stream));
}

// Bytes of the global workspace a launch of p parts and blocks of B edges
// needs: the WIDE kernel's per-edge staging (p > 1,024), else 0.
long long ebg_commit_workspace_bytes(int p, int B, int weighted) {
  (void)weighted;
  return p > kMaxPipeParts ? (long long)stage_bytes(p, B) : 0;
}

// Walk `nblocks` blocks of B edges in order over memb [32·vw, ⌈p/32⌉],
// updating memb/e_count/v_count in place and writing parts[nblocks * B].
// valid is 1 byte per edge. ws: ebg_commit_workspace_bytes(p, B, weighted)
// bytes of device memory, 16-byte aligned (may be null when that is 0).
int ebg_commit_launch(void* memb, void* e_count, void* v_count, const void* u, const void* v,
                      const void* valid, const void* wu, const void* wv, const void* coef,
                      void* parts, void* ws, int p, int B, int nblocks, int range, int weighted,
                      int window, void* stream) {
  if (p < 1 || B < 1 || nblocks < 1) return (int)cudaErrorInvalidValue;
  if (ws == nullptr && ebg_commit_workspace_bytes(p, B, weighted) > 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<uint32_t*>(memb), static_cast<float*>(e_count),
               static_cast<float*>(v_count), static_cast<const int*>(u),
               static_cast<const int*>(v), static_cast<const uint8_t*>(valid),
               static_cast<const float*>(wu), static_cast<const float*>(wv),
               static_cast<const float*>(coef), static_cast<int*>(parts),
               static_cast<unsigned char*>(ws), p, B, nblocks};
#define EBG_CASE(R, WT, WN) \
  if (!!range == R && !!weighted == WT && !!window == WN) return (int)launch<R, WT, WN>(a, s);
  EBG_CASE(false, false, false)
  EBG_CASE(false, false, true)
  EBG_CASE(false, true, false)
  EBG_CASE(false, true, true)
  EBG_CASE(true, false, false)
  EBG_CASE(true, false, true)
  EBG_CASE(true, true, false)
  EBG_CASE(true, true, true)
#undef EBG_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
