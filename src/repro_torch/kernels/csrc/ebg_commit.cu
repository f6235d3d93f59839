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
// gather is 2·W loads (2 at p = 32, where it was 2·p scattered sectors)
// and a commit is one atomicOr. `transpose_kernel` (below; the wrappers
// `keep_bits_to_memb` and `memb_to_keep_bits` of ebg_commit.py) converts
// at the launch's start and end, a 32x32 bit block a warp, by ballots.
//
// What bounds it on an H100: the per-edge chain is strictly sequential
// (edge j+1's argmin needs edge j's counters), so the cost is the latency
// of one score and argmin per edge, not bytes or FLOPs. For p <= 32 (one
// part a lane of warp 0, counters in registers for the whole launch) the
// design keeps that chain short and overlaps everything else with it:
//   * the argmin is one __reduce_min_sync over an order-preserving u32
//     image of the score and one ballot: the lowest lane at the min wins;
//   * static mode: each lane computes both of its keys for edge j+1 (as it
//     stands, and as it would stand after winning edge j) while edge j's
//     argmin runs, so a link of the chain is redux -> ballot -> select.
//     Range mode's normalizer needs every counter after the commit: its
//     max/min of e_c are two more reductions on their bits, after it;
//   * edge j+1's mask words and weights are read from shared memory while
//     edge j is scored;
//   * while warp 0 runs block b's chain, warps 1-7 stage block b+1 into the
//     other half of a double buffer and gather its masks (the state after
//     block b-1). After one barrier, block b's parts are written in one
//     coalesced pass and entered in a small hash table in shared memory
//     (vertex -> parts it joined in b); after another, each vertex's bits
//     are committed to memb with one atomic, and block b+1's masks are
//     patched from the table — the WINDOW replay applied across the block
//     boundary — which gives exactly the block-start state of b+1.
// p > 32, and a block whose double buffer does not fit in shared memory,
// run one CTA with block-wide reductions on the same layout (no overlap).
// Where even that kernel's per-edge staging does not fit in shared memory
// (about 7,240 edges at p <= 32, 4,096 at p > 128) or p > 1024, its WIDE
// build keeps the staging in a global workspace and gives each thread
// several parts; it takes any p and any block, only to be right. A block is
// never split: frozen mode scores the whole block against its start.
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

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kTransposeCols = 8;  // vertex words a warp transposes
constexpr size_t kMaxSmem = 232448;

// ------------------------------------------------------------ layout

// A warp transposes the 32x32 bit blocks (parts 32w.., vertices 32c..) for
// kTransposeCols consecutive c. keep -> memb: lane i holds part 32w+i's
// word; the ballot of bit x over the lanes is vertex 32c+x's word.
// memb -> keep: lane x holds vertex 32c+x's word; the ballot of bit i is
// part 32w+i's word. Parts >= p read 0 and are not written.
template <bool TO_MEMB>
__global__ void transpose_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                                 int p, int vw, int W) {
  const int lane = threadIdx.x & 31;
  const long long groups = (long long)((vw + kTransposeCols - 1) / kTransposeCols) * W;
  const long long nwarps = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long gi = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); gi < groups;
       gi += nwarps) {
    const int w = (int)(gi % W);
    const int c0 = (int)(gi / W) * kTransposeCols;
    const int part = 32 * w + lane;
#pragma unroll
    for (int cc = 0; cc < kTransposeCols; ++cc) {
      const int c = c0 + cc;
      if (c >= vw) break;  // warp-uniform
      uint32_t word;
      if (TO_MEMB) {
        word = part < p ? src[(size_t)part * vw + c] : 0u;
      } else {
        word = src[((size_t)32 * c + lane) * W + w];
      }
      uint32_t mine = 0;
#pragma unroll
      for (int bit = 0; bit < 32; ++bit) {
        const uint32_t col = __ballot_sync(kFull, (word >> bit) & 1u);
        if (lane == bit) mine = col;
      }
      if (TO_MEMB) {
        dst[((size_t)32 * c + lane) * W + w] = mine;
      } else if (part < p) {
        dst[(size_t)part * vw + c] = mine;
      }
    }
  }
}

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

struct Coef {
  float ce, cv, inv_e, inv_v, eps;
};

__device__ __forceinline__ Coef load_coef(const float* coef) {
  return Coef{coef[0], coef[1], coef[2], coef[3], coef[4]};
}

// ------------------------------------------- p <= 32: the pipelined kernel

// One half of the double buffer: a block's edges and miss masks.
struct Buf {
  int* u;
  int* v;
  int* ok;
  float* wu;
  float* wv;
  uint32_t* mu;  // miss-u mask (bit i: part i lacks u)
  uint32_t* mv;
  int* win;  // the chain's ballot of the lanes at the min (lowest = the part), 0 for a pad
};

// The half of the double buffer at `base` (pointers computed, not stored,
// so that they stay shared-memory addresses).
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

// Vertex -> OR of the parts a block committed it to (open addressing).
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

template <bool WEIGHTED>
__device__ __forceinline__ float gain_of(const Edge& e, uint32_t mu_w, uint32_t mv_w, int lane) {
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

// Warp 0's sequential pass over one block. Per edge the chain is: the
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

template <bool RANGE, bool WEIGHTED, bool WINDOW>
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
      chain<RANGE, WEIGHTED, WINDOW>(cur, B, p, cf, e_c, v_c);
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

// ------------------------------------- any p: block-wide reductions, no overlap

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

// Bytes of a block's per-edge staging (mu .. swin).
__host__ __device__ __forceinline__ size_t stage_bytes(int p, int B) {
  const size_t W = (size_t)(p + 31) / 32;
  return (size_t)B * (2 * W * 4 + 6 * 4);
}

// One CTA walks the blocks in order. Thread t owns parts t, t + T, ...:
// one at most (p <= T), its counters in registers, unless WIDE. WIDE takes
// any p and any block: the per-edge staging lives in the global workspace
// `ws` (stage_bytes of it) instead of shared memory, each thread scores
// its parts in turn and folds them into its argmin (and, in range mode,
// into its max/min of e_c) before the warp and CTA reductions, and keeps
// their counters in e_count/v_count, which only it touches until the end.
template <bool RANGE, bool WEIGHTED, bool WINDOW, bool WIDE>
__global__ void __launch_bounds__(1024)
    ebg_commit_block_kernel(uint32_t* __restrict__ memb, float* __restrict__ e_count,
                            float* __restrict__ v_count, const int* __restrict__ u,
                            const int* __restrict__ v, const uint8_t* __restrict__ valid,
                            const float* __restrict__ wu, const float* __restrict__ wv,
                            const float* __restrict__ coef, int* __restrict__ parts, int p, int B,
                            int nblocks, unsigned char* __restrict__ ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = (p + 31) >> 5;
  unsigned char* const stage = WIDE ? ws : smem_raw;
  Smem sm;
  sm.mu = reinterpret_cast<uint32_t*>(stage);
  sm.mv = sm.mu + (size_t)B * W;
  sm.su = reinterpret_cast<int*>(sm.mv + (size_t)B * W);
  sm.sv = sm.su + B;
  sm.sval = sm.sv + B;
  sm.swu = reinterpret_cast<float*>(sm.sval + B);
  sm.swv = sm.swu + B;
  sm.swin = reinterpret_cast<int*>(sm.swv + B);
  sm.red_f = WIDE ? reinterpret_cast<float*>(smem_raw) : reinterpret_cast<float*>(sm.swin + B);
  sm.red_i = reinterpret_cast<int*>(sm.red_f + 4 * 32);

  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nw = T >> 5;
  const bool part_lane = t < p;
  const float kPosInf = __int_as_float(0x7f800000);
  const Coef cf = load_coef(coef);

  float e_c = !WIDE && part_lane ? e_count[t] : 0.0f;
  float v_c = !WIDE && part_lane ? v_count[t] : 0.0f;

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
      float mu = 0.0f, mv = 0.0f;
      float gain = 0.0f;
      if (!WIDE && part_lane) gain = part_gain(t, mu, mv);
      float norm = cf.inv_e;
      if (RANGE) {
        float mx = -kPosInf, mn = kPosInf;
        if (WIDE) {
          for (int i = t; i < p; i += T) mx = fmaxf(mx, e_count[i]), mn = fminf(mn, e_count[i]);
        } else if (part_lane) {
          mx = mn = e_c;
        }
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
      if (WIDE) {
        for (int i = t; i < p; i += T) {
          float a, b;
          const float g = part_gain(i, a, b);
          better(s, win, score_of(cf, e_count[i], v_count[i], norm, g), i);
        }
      } else if (part_lane) {
        s = score_of(cf, e_c, v_c, norm, gain);
        win = t;
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
        if (WIDE) {
          part_gain(win, mu, mv);
          e_count[win] = __fadd_rn(e_count[win], 1.0f);
          v_count[win] = __fadd_rn(v_count[win], __fadd_rn(mu, mv));
        } else {
          e_c = __fadd_rn(e_c, 1.0f);
          v_c = __fadd_rn(v_c, __fadd_rn(mu, mv));
        }
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
  if (!WIDE && part_lane) {
    e_count[t] = e_c;
    v_count[t] = v_c;
  }
}

// ------------------------------------------------------------ launch

// Bytes of dynamic shared memory of the block-wide kernel: the per-edge
// staging (unless WIDE, where it is in the workspace) and the reductions'.
size_t block_smem(int p, int B, bool wide) {
  return (wide ? 0 : stage_bytes(p, B)) + 4 * 32 * 4 + 2 * 32 * 4;
}

// Whether a launch takes the WIDE block-wide kernel: more parts than a CTA
// has threads, or a block whose staging does not fit in shared memory.
bool wide_launch(int p, int B) { return p > 1024 || block_smem(p, B, false) > kMaxSmem; }

int table_bits(int B) {  // at least 8B slots: at most 2B keys, load <= 1/4
  int bits = 6;
  while ((1 << bits) < 8 * B) ++bits;
  return bits;
}

size_t pipe_smem(int B, bool weighted) {
  return 2 * buf_bytes(B, weighted) + ((size_t)8 << table_bits(B));
}

template <bool RANGE, bool WEIGHTED, bool WINDOW, bool WIDE>
cudaError_t launch_block(cudaStream_t stream, uint32_t* memb, float* e, float* vc, const int* u,
                         const int* v, const uint8_t* valid, const float* wu, const float* wv,
                         const float* coef, int* parts, int p, int B, int nblocks,
                         unsigned char* ws) {
  auto kern = ebg_commit_block_kernel<RANGE, WEIGHTED, WINDOW, WIDE>;
  const size_t smem = block_smem(p, B, WIDE);
  const int W = (p + 31) / 32;
  const int threads = 32 * W > 1024 ? 1024 : (32 * W > kThreads ? 32 * W : kThreads);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<1, threads, smem, stream>>>(memb, e, vc, u, v, valid, wu, wv, coef, parts, p, B, nblocks,
                                     ws);
  return cudaGetLastError();
}

template <bool RANGE, bool WEIGHTED, bool WINDOW>
cudaError_t launch(bool pipe, cudaStream_t stream, uint32_t* memb, float* e, float* vc,
                   const int* u, const int* v, const uint8_t* valid, const float* wu,
                   const float* wv, const float* coef, int* parts, int p, int B, int nblocks,
                   unsigned char* ws) {
  if (pipe) {
    auto kern = ebg_commit_pipe_kernel<RANGE, WEIGHTED, WINDOW>;
    const size_t smem = pipe_smem(B, WEIGHTED);
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<1, kThreads, smem, stream>>>(memb, e, vc, u, v, valid, wu, wv, coef, parts, p, B,
                                        nblocks, table_bits(B));
    return cudaGetLastError();
  }
  if (wide_launch(p, B))
    return launch_block<RANGE, WEIGHTED, WINDOW, true>(stream, memb, e, vc, u, v, valid, wu, wv,
                                                        coef, parts, p, B, nblocks, ws);
  return launch_block<RANGE, WEIGHTED, WINDOW, false>(stream, memb, e, vc, u, v, valid, wu, wv,
                                                       coef, parts, p, B, nblocks, ws);
}

}  // namespace

extern "C" {

// keep [p, vw] -> memb [32·vw, ⌈p/32⌉] (to_memb = 1), or back (to_memb = 0;
// rows of keep are overwritten whole). Returns cudaGetLastError.
int ebg_memb_transpose(const void* src, void* dst, int p, int vw, int to_memb, void* stream) {
  if (p < 1 || vw < 1) return (int)cudaErrorInvalidValue;
  const int W = (p + 31) / 32;
  const long long groups = (long long)((vw + kTransposeCols - 1) / kTransposeCols) * W;
  const long long blocks = (groups + 7) / 8;  // 8 warps a block
  const int grid = (int)(blocks < 132 * 16 ? blocks : 132 * 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* in = static_cast<const uint32_t*>(src);
  auto* out = static_cast<uint32_t*>(dst);
  if (to_memb) {
    transpose_kernel<true><<<grid, 256, 0, s>>>(in, out, p, vw, W);
  } else {
    transpose_kernel<false><<<grid, 256, 0, s>>>(in, out, p, vw, W);
  }
  return (int)cudaGetLastError();
}

// Bytes of the global workspace a launch of p parts and blocks of B edges
// needs: the WIDE kernel's per-edge staging, else 0.
long long ebg_commit_workspace_bytes(int p, int B, int weighted) {
  const bool pipe = p <= 32 && pipe_smem(B, weighted != 0) <= kMaxSmem;
  return !pipe && wide_launch(p, B) ? (long long)stage_bytes(p, B) : 0;
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
  const bool pipe = p <= 32 && pipe_smem(B, weighted != 0) <= kMaxSmem;
  if (ws == nullptr && ebg_commit_workspace_bytes(p, B, weighted) > 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* mb = static_cast<uint32_t*>(memb);
  auto* e = static_cast<float*>(e_count);
  auto* vc = static_cast<float*>(v_count);
  auto* uu = static_cast<const int*>(u);
  auto* vv = static_cast<const int*>(v);
  auto* ok = static_cast<const uint8_t*>(valid);
  auto* fu = static_cast<const float*>(wu);
  auto* fv = static_cast<const float*>(wv);
  auto* cf = static_cast<const float*>(coef);
  auto* pt = static_cast<int*>(parts);
  auto* wk = static_cast<unsigned char*>(ws);
#define EBG_CASE(R, WT, WN)                                                                  \
  if (!!range == R && !!weighted == WT && !!window == WN)                                    \
    return (int)launch<R, WT, WN>(pipe, s, mb, e, vc, uu, vv, ok, fu, fv, cf, pt, p, B, \
                                  nblocks, wk);
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
