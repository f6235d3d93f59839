// Single-token grouped-query attention over a KV cache (split-S flash decode).
//
// Replaces the TPU kernel `_decode_attn_kernel` / `decode_attention_pallas`
// in src/repro/kernels/decode_attn.py (oracle `decode_attention_ref` in
// src/repro/kernels/ref.py). Inputs: q [B, Hq, D], k and v [B, S, Hkv, D],
// all f32 or all bf16, Hq = Hkv * G, 1 <= D <= 256; output out [B, Hq, D]
// in q's type.
// Query head h*G + g attends over kv head h:
//   s_j = q . k_j * scale   (scale = 1/sqrt(D)),
//   s_j = softcap * tanh(s_j / softcap)   when softcap != 0,
//   out = sum_j softmax(s)_j v_j,   accumulated in f32.
//
// What bounds it on an H100: bytes. Every K and V row is read once and
// used for the G query rows of its kv head, about 4·G operations a byte in
// bf16, far below the card's balance point. The design keeps the memory
// system busy:
//   * Split S. The grid is (B·Hkv·⌈G/GC⌉, nsplit): a CTA takes one (batch,
//     kv head, group of GC <= 8 query rows) and one contiguous range of
//     whole tiles of S, so K and V are read once for G <= 8, and the
//     wrapper picks nsplit for several waves of CTAs at any batch. Each CTA
//     leaves its partial state (running max m, denominator l, unnormalised
//     f32 accumulator [GC, D]) in a workspace; a second small launch merges
//     a head's partials with the log-sum-exp rule and casts. With
//     nsplit = 1 the first launch writes the output itself.
//   * A ring of NSTAGE tiles of TK keys (K and V rows) in shared memory,
//     ~70 KB a CTA, NSTAGE-1 tiles ahead. A row of a tile is one bulk copy
//     (cp.async.bulk: the TMA engine without a tensor map, a row being one
//     contiguous D·sizeof(T) piece at stride Hkv·D; L2 evict-first),
//     completed on the slot's mbarrier; the rows past the range are zeroed. Rows are padded
//     by 16 bytes, so the score phase's column reads (8 rows a quarter-warp)
//     and the P·V phase's row reads are free of bank conflicts. A CTA is 256
//     threads over 64-key tiles, or 128 over 32-key tiles for rows of 512
//     bytes or more (f32 at D >= 128, bf16 at D = 256).
//   * No warp reduction per key. Score phase: lane j of warp w dots key
//     32·(w/4) + j of the tile with the query rows (held in shared memory
//     as f32, read as broadcasts) over quarter w%4 of D; the quarters are
//     added through shared memory. Softmax phase: one warp a query row
//     takes the tile's max and sum (two warp reductions a tile, not a key).
//     P·V phase: a thread owns one 16-byte column chunk of D and every
//     KP-th key of the tile, and adds p_j v_j into GC·(16/sizeof(T)) f32
//     registers; the KP partial accumulators are added once, at the end.
//   * Products are written as __fmaf_rn (the build's -fmad=false forbids
//     only the compiler's own contraction).
//   * Any head_dim: the kernel is built for DP in {32, 64, 128, 256}; a
//     head_dim D < DP runs on the next one up. Its rows sit in the padded
//     tile with zero columns D..DP (in q and k they add nothing to a dot
//     product; those of P·V are not stored), and scale is 1/sqrt(D) of
//     the true D. Rows whose D·sizeof(T) is not a multiple of 16 (or k, v
//     off a 16-byte boundary) cannot take a bulk copy: they are loaded by
//     element into the tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kQuarters = 4;        // the score phase splits D in four
constexpr int kMergeThreads = 128;
constexpr int kRingBytes = 72 * 1024;  // the ring a CTA aims at
constexpr float kNegInf = -3.0e38f;    // finite: exp(kNegInf - m) is 0, never NaN

// A CTA of THREADS threads takes tiles of TK keys: one a lane of each
// group of four warps in the score phase. Rows of 512 bytes or more take
// 128 threads and 32 keys, so that two stages of the ring fit.
template <typename T, int D>
struct Shape {
  static constexpr int THREADS = D * (int)sizeof(T) >= 512 ? 128 : 256;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int TK = 32 * (WARPS / kQuarters);
  static constexpr int CE = 16 / (int)sizeof(T);   // elements a 16-byte chunk
  static constexpr int NCH = D / CE;               // chunks a row
  static constexpr int ROWB = D * (int)sizeof(T) + 16;  // padded row in shared memory
  static constexpr int TILEB = TK * ROWB;
  static constexpr int STAGEB = 2 * TILEB;  // K tile, then V tile
  static constexpr int NSTAGE =
      kRingBytes / STAGEB < 2 ? 2 : (kRingBytes / STAGEB > 6 ? 6 : kRingBytes / STAGEB);
  static constexpr int WCH = NCH / kQuarters;  // chunks a warp dots in the score phase
  static constexpr int KP = THREADS / NCH;  // key phases of the P·V phase
  static constexpr int KPT = TK / KP;        // keys a thread adds a tile
  static_assert(NCH % kQuarters == 0 && THREADS % NCH == 0 && TK % KP == 0, "shape");
};

template <typename T, int D, int GC>
struct Smem {
  using Sh = Shape<T, D>;
  static constexpr int RING = Sh::NSTAGE * Sh::STAGEB;
  static constexpr int RED = Sh::KP * GC * D * 4;  // the end's partial accumulators (reuse the ring)
  static constexpr int BIG = RING > RED ? RING : RED;
  static constexpr int BARS = (8 * Sh::NSTAGE + 15) / 16 * 16;  // keeps q_s 16-byte aligned
  static constexpr int BYTES =
      BIG + BARS + 4 * (GC * D + kQuarters * GC * Sh::TK + GC * Sh::TK + 3 * GC);
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

// One arrival that also expects `bytes` of bulk copies on the barrier.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// One arrival with no bytes expected (a tile loaded by element).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// One contiguous piece of global memory into shared memory by the bulk
// copy engine (TMA without a tensor map), completed on `bar`. K and V are
// read once: the copy asks L2 to evict them first.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy) : "memory");
}

// One 16-byte chunk as floats.
template <typename T>
__device__ __forceinline__ void chunk_to_f32(const uint4& x, float* f) {
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same_v<T, float>) {
      f[i] = __uint_as_float(w[i]);
    } else {  // bf16: the upper half of an f32; element 2i is word i's low half
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

template <typename T>
__device__ __forceinline__ float to_f32(T x) {
  if constexpr (std::is_same_v<T, float>) {
    return x;
  } else {
    return __bfloat162float(x);
  }
}

template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (std::is_same_v<T, float>) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = __fadd_rn(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// Partial state of split z of CTA row x: acc at ws[((x·nsplit + z)·GC + g)·D + d],
// then (m, l) at ml[((x·nsplit + z)·GC + g)·2 + {0, 1}], ml = ws + rows·nsplit·GC·D.
// D is the built (padded) width, dt <= D the true head_dim; bulk: rows
// load by one bulk copy each, else by element.
template <typename T, int D, int GC>
__global__ void __launch_bounds__(Shape<T, D>::THREADS)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, float* __restrict__ ws,
                        int S, int Hkv, int G, int chunk, float scale, float softcap, int dt,
                        int bulk) {
  using Sh = Shape<T, D>;
  using Sm = Smem<T, D, GC>;
  constexpr int CE = Sh::CE, NCH = Sh::NCH, ROWB = Sh::ROWB, TILEB = Sh::TILEB;
  constexpr int STAGEB = Sh::STAGEB, NSTAGE = Sh::NSTAGE, KP = Sh::KP;
  constexpr int kThreads = Sh::THREADS, kWarps = Sh::WARPS, kTK = Sh::TK;
  constexpr int GW = (GC + kWarps - 1) / kWarps;  // query rows a warp owns in the softmax
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* red = reinterpret_cast<float*>(smem);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + Sm::BIG);  // [NSTAGE] a slot's copies
  float* q_s = reinterpret_cast<float*>(smem + Sm::BIG + Sm::BARS);  // [GC][D]
  float* s_part = q_s + GC * D;                            // [kQuarters][GC][kTK]
  float* p_s = s_part + kQuarters * GC * kTK;              // [GC][kTK]
  float* a_s = p_s + GC * kTK;                             // [GC] this tile's rescale
  float* ml_s = a_s + GC;                                  // [2][GC] final m, l

  const int ngroups = (G + GC - 1) / GC;
  const int x = blockIdx.x;
  const int bh = x / ngroups;
  const int b = bh / Hkv, h = bh % Hkv;
  const int g0 = (x % ngroups) * GC;
  const int ng = min(GC, G - g0);
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int k0 = split * chunk;
  const int kend = min(S, k0 + chunk);
  const int ntiles = kend > k0 ? (kend - k0 + kTK - 1) / kTK : 0;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  const size_t rs = (size_t)Hkv * dt;  // elements from key s to key s+1
  const T* kb = k + ((size_t)b * S * Hkv + h) * dt;
  const T* vb = v + ((size_t)b * S * Hkv + h) * dt;
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < NSTAGE; ++i) mbar_init(bar + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The pad columns dt..D of every row of the ring are zero for good: the
  // loads write columns 0..dt only.
  if (dt < D) {
    for (int i = t; i < NSTAGE * 2 * kTK * (D - dt); i += kThreads) {
      const int row = i / (D - dt), c = dt + i % (D - dt);
      reinterpret_cast<T*>(ring + row * ROWB)[c] = from_f32<T>(0.0f);
    }
  }
  __syncthreads();
  // Tile i into slot i % NSTAGE: one bulk copy a K or V row (threads < 2·kTK),
  // V rows past the range zeroed (their p is 0; stale bits could be NaN).
  auto load_tile = [&](int i) {
    if (i >= ntiles) return;
    unsigned char* st = ring + (i % NSTAGE) * STAGEB;
    const int key0 = k0 + i * kTK;
    const int nv = min(kTK, kend - key0);
    if (!bulk) {
      for (int e = t; e < 2 * nv * dt; e += kThreads) {
        const int kv = e / (nv * dt), r = e / dt % nv, c = e % dt;
        reinterpret_cast<T*>(st + kv * TILEB + r * ROWB)[c] =
            (kv ? vb : kb)[(size_t)(key0 + r) * rs + c];
      }
      if (t == 0) mbar_arrive(bar + i % NSTAGE);  // the barriers before the tile's use order these
    } else if (t == 0) {
      mbar_expect(bar + i % NSTAGE, 2u * nv * dt * (unsigned)sizeof(T));
    }
    if (t < 2 * kTK) {
      const int kv = t / kTK, r = t % kTK;
      if (r < nv) {
        if (bulk)
          bulk_copy(st + kv * TILEB + r * ROWB, (kv ? vb : kb) + (size_t)(key0 + r) * rs,
                    dt * sizeof(T), bar + i % NSTAGE);
      } else if (kv) {
        uint4* row = reinterpret_cast<uint4*>(st + TILEB + r * ROWB);
#pragma unroll
        for (int c = 0; c < NCH; ++c) row[c] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) load_tile(i);
  // The query rows, once the first tiles are on their way.
  const T* qb = q + ((size_t)b * Hkv * G + (size_t)h * G + g0) * dt;
  for (int i = t; i < GC * D; i += kThreads)
    q_s[i] = i / D < ng && i % D < dt ? to_f32(qb[i / D * dt + i % D]) : 0.0f;

  float m_r[GW], l_r[GW];
#pragma unroll
  for (int r = 0; r < GW; ++r) m_r[r] = kNegInf, l_r[r] = 0.0f;
  const int ch = t % NCH, kp = t / NCH;  // this thread's column chunk and key phase
  float acc[GC][CE];
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int e = 0; e < CE; ++e) acc[g][e] = 0.0f;

  for (int i = 0; i < ntiles; ++i) {
    mbar_wait(bar + i % NSTAGE, (i / NSTAGE) & 1);  // tile i has landed
    __syncthreads();            // everyone is done with tile i-1 (and sees the zeroed rows)
    load_tile(i + NSTAGE - 1);  // into tile i-1's slot
    const unsigned char* Ks = ring + (i % NSTAGE) * STAGEB;
    const unsigned char* Vs = Ks + TILEB;
    const int key0 = k0 + i * kTK;

    // Scores: warp w takes keys 32·(w / 4) + lane over quarter w % 4 of D.
    {
      const int quarter = warp % kQuarters;
      const int key = 32 * (warp / kQuarters) + lane;
      float s0[GC], s1[GC];
#pragma unroll
      for (int g = 0; g < GC; ++g) s0[g] = s1[g] = 0.0f;
      const unsigned char* krow = Ks + key * ROWB;
#pragma unroll
      for (int c = 0; c < Sh::WCH; ++c) {
        const int cc = quarter * Sh::WCH + c;
        float kf[CE];
        chunk_to_f32<T>(*reinterpret_cast<const uint4*>(krow + cc * 16), kf);
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          const float4* qv = reinterpret_cast<const float4*>(q_s + g * D + cc * CE);
#pragma unroll
          for (int e4 = 0; e4 < CE / 4; ++e4) {
            const float4 qq = qv[e4];
            s0[g] = __fmaf_rn(qq.x, kf[4 * e4], s0[g]);
            s1[g] = __fmaf_rn(qq.y, kf[4 * e4 + 1], s1[g]);
            s0[g] = __fmaf_rn(qq.z, kf[4 * e4 + 2], s0[g]);
            s1[g] = __fmaf_rn(qq.w, kf[4 * e4 + 3], s1[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GC; ++g)
        s_part[(quarter * GC + g) * kTK + key] = __fadd_rn(s0[g], s1[g]);
    }
    __syncthreads();

    // Online softmax over the tile: warp w owns query rows w, w + kWarps, ...;
    // lane j takes keys j, j + 32, ...
#pragma unroll
    for (int r = 0; r < GW; ++r) {
      const int g = warp + kWarps * r;
      if (g < GC) {
        constexpr int KL = kTK / 32;
        float s[KL];
        float mx = kNegInf;
#pragma unroll
        for (int i = 0; i < KL; ++i) {
          const int j = lane + 32 * i;
          s[i] = kNegInf;
          if (key0 + j < kend) {
            float x = s_part[g * kTK + j];
#pragma unroll
            for (int qq = 1; qq < kQuarters; ++qq) x = __fadd_rn(x, s_part[(qq * GC + g) * kTK + j]);
            x = __fmul_rn(x, scale);
            if (softcap != 0.0f) x = __fmul_rn(softcap, tanhf(__fdiv_rn(x, softcap)));
            s[i] = x;
          }
          mx = fmaxf(mx, s[i]);
        }
        const float m_new = fmaxf(m_r[r], warp_max(mx));
        const float alpha = expf(__fsub_rn(m_r[r], m_new));
        float sum = 0.0f;
#pragma unroll
        for (int i = 0; i < KL; ++i) {
          const float pj = expf(__fsub_rn(s[i], m_new));
          p_s[g * kTK + lane + 32 * i] = pj;
          sum = __fadd_rn(sum, pj);
        }
        l_r[r] = __fadd_rn(__fmul_rn(l_r[r], alpha), warp_sum(sum));
        m_r[r] = m_new;
        if (lane == 0) a_s[g] = alpha;
      }
    }
    __syncthreads();

    // P·V: this thread's column chunk over keys kp, kp + KP, ...
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const float a = a_s[g];
#pragma unroll
      for (int e = 0; e < CE; ++e) acc[g][e] = __fmul_rn(acc[g][e], a);
    }
#pragma unroll
    for (int jj = 0; jj < Sh::KPT; ++jj) {
      const int j = kp + jj * KP;
      float vf[CE];
      chunk_to_f32<T>(*reinterpret_cast<const uint4*>(Vs + j * ROWB + ch * 16), vf);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float pj = p_s[g * kTK + j];
#pragma unroll
        for (int e = 0; e < CE; ++e) acc[g][e] = __fmaf_rn(pj, vf[e], acc[g][e]);
      }
    }
  }

  // Add the KP key phases' accumulators (the ring is free: every copy issued
  // has been waited for).
  __syncthreads();
#pragma unroll
  for (int r = 0; r < GW; ++r) {
    const int g = warp + kWarps * r;
    if (g < GC && lane == 0) {
      ml_s[g] = m_r[r];
      ml_s[GC + g] = l_r[r];
    }
  }
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    float4* dst = reinterpret_cast<float4*>(red + (kp * GC + g) * D + ch * CE);
#pragma unroll
    for (int e4 = 0; e4 < CE / 4; ++e4)
      dst[e4] = make_float4(acc[g][4 * e4], acc[g][4 * e4 + 1], acc[g][4 * e4 + 2],
                            acc[g][4 * e4 + 3]);
  }
  __syncthreads();
  const size_t row0 = ((size_t)x * nsplit + split) * GC;
  for (int idx = t; idx < ng * dt; idx += kThreads) {
    const int g = idx / dt, d = idx % dt;
    float num = red[g * D + d];
#pragma unroll
    for (int p2 = 1; p2 < KP; ++p2) num = __fadd_rn(num, red[(p2 * GC + g) * D + d]);
    if (nsplit == 1) {
      out[((size_t)b * Hkv * G + (size_t)h * G + g0 + g) * dt + d] =
          from_f32<T>(__fdiv_rn(num, ml_s[GC + g]));
    } else {
      ws[(row0 + g) * D + d] = num;
    }
  }
  if (nsplit > 1 && t < ng) {
    float* ml = ws + (size_t)gridDim.x * nsplit * GC * D;
    ml[(row0 + t) * 2] = ml_s[t];
    ml[(row0 + t) * 2 + 1] = ml_s[GC + t];
  }
}

// One CTA a (batch, kv head, group): the nsplit partial states of each of
// its query rows merged with the log-sum-exp rule, divided and cast. D is
// the partial states' (padded) width, dt <= D the output's.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
    decode_merge_kernel(const float* __restrict__ ws, T* __restrict__ out, int Hkv, int G,
                        int GC, int D, int dt, int nsplit) {
  extern __shared__ float f_s[];  // [nsplit][GC] exp(m_z - M), then L [GC]
  float* L_s = f_s + nsplit * GC;
  const int ngroups = (G + GC - 1) / GC;
  const int x = blockIdx.x;
  const int bh = x / ngroups;
  const int b = bh / Hkv, h = bh % Hkv;
  const int g0 = (x % ngroups) * GC;
  const int ng = min(GC, G - g0);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* ml = ws + (size_t)gridDim.x * nsplit * GC * D;
  const size_t row0 = (size_t)x * nsplit * GC;  // + z·GC + g
  for (int g = warp; g < ng; g += kMergeThreads / 32) {
    float M = kNegInf;
    for (int z = lane; z < nsplit; z += 32) M = fmaxf(M, ml[(row0 + z * GC + g) * 2]);
    M = warp_max(M);
    float L = 0.0f;
    for (int z = lane; z < nsplit; z += 32) {
      const float f = expf(__fsub_rn(ml[(row0 + z * GC + g) * 2], M));
      f_s[z * GC + g] = f;
      L = __fadd_rn(L, __fmul_rn(ml[(row0 + z * GC + g) * 2 + 1], f));
    }
    L = warp_sum(L);
    if (lane == 0) L_s[g] = L;
  }
  __syncthreads();
  for (int idx = t; idx < ng * dt; idx += kMergeThreads) {
    const int g = idx / dt, d = idx % dt;
    float num = 0.0f;
    for (int z = 0; z < nsplit; ++z)
      num = __fmaf_rn(ws[(row0 + z * GC + g) * D + d], f_s[z * GC + g], num);
    out[((size_t)b * Hkv * G + (size_t)h * G + g0 + g) * dt + d] =
        from_f32<T>(__fdiv_rn(num, L_s[g]));
  }
}

// Query rows a CTA: the least power of two >= G, at most 8 (decode_attn.py
// sizes the workspace through decode_attn_workspace below).
int group_rows(int G) { return G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8; }

template <typename T, int D, int GC>
cudaError_t launch_split(const void* q, const void* k, const void* v, void* out, float* ws,
                         int rows, int S, int Hkv, int G, int chunk, int nsplit, float scale,
                         float softcap, int dt, int bulk, cudaStream_t stream) {
  auto kern = decode_split_kernel<T, D, GC>;
  constexpr int bytes = Smem<T, D, GC>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kern<<<dim3(rows, nsplit), Shape<T, D>::THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), ws, S, Hkv, G, chunk, scale, softcap, dt, bulk);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out, float* ws, int B,
                     int S, int Hkv, int G, int nsplit, float scale, float softcap, int dt,
                     cudaStream_t s) {
  const int bulk = dt * (int)sizeof(T) % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const int GC = group_rows(G);
  const int rows = B * Hkv * ((G + GC - 1) / GC);
  // Whole tiles a split; the last split takes what is left.
  constexpr int TK = Shape<T, D>::TK;
  const int tiles = (S + TK - 1) / TK;
  const int per = (tiles + nsplit - 1) / nsplit;
  const int chunk = per * TK;
  nsplit = (tiles + per - 1) / per;
  cudaError_t err;
  switch (GC) {
    case 1: err = launch_split<T, D, 1>(q, k, v, out, ws, rows, S, Hkv, G, chunk, nsplit, scale, softcap, dt, bulk, s); break;
    case 2: err = launch_split<T, D, 2>(q, k, v, out, ws, rows, S, Hkv, G, chunk, nsplit, scale, softcap, dt, bulk, s); break;
    case 4: err = launch_split<T, D, 4>(q, k, v, out, ws, rows, S, Hkv, G, chunk, nsplit, scale, softcap, dt, bulk, s); break;
    case 8: err = launch_split<T, D, 8>(q, k, v, out, ws, rows, S, Hkv, G, chunk, nsplit, scale, softcap, dt, bulk, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || nsplit == 1) return err;
  const size_t merge_bytes = (size_t)(nsplit + 1) * GC * sizeof(float);
  decode_merge_kernel<T><<<rows, kMergeThreads, merge_bytes, s>>>(ws, static_cast<T*>(out), Hkv,
                                                                  G, GC, D, dt, nsplit);
  return cudaGetLastError();
}

// The width a head_dim D runs at: the least built width >= D (0: none).
int padded_dim(int D) {
  return D < 1 ? 0 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : D <= 256 ? 256 : 0;
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* out, float* ws, int B,
                     int S, int Hkv, int G, int D, int nsplit, float scale, float softcap,
                     cudaStream_t s) {
  switch (padded_dim(D)) {
    case 32: return launch_d<T, 32>(q, k, v, out, ws, B, S, Hkv, G, nsplit, scale, softcap, D, s);
    case 64: return launch_d<T, 64>(q, k, v, out, ws, B, S, Hkv, G, nsplit, scale, softcap, D, s);
    case 128:
      return launch_d<T, 128>(q, k, v, out, ws, B, S, Hkv, G, nsplit, scale, softcap, D, s);
    case 256:
      return launch_d<T, 256>(q, k, v, out, ws, B, S, Hkv, G, nsplit, scale, softcap, D, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Floats of workspace a launch with `nsplit` splits needs (0 for one split).
long long decode_attn_workspace(int B, int Hkv, int G, int D, int nsplit) {
  if (nsplit <= 1) return 0;
  const int GC = group_rows(G);
  return (long long)B * Hkv * ((G + GC - 1) / GC) * nsplit * GC * (padded_dim(D) + 2);
}

// dtype: 0 = f32, 1 = bf16. 1 <= D <= 256; 1 <= nsplit <=
// 1024 (fewer are used when S has fewer tiles); `ws` holds at least
// decode_attn_workspace(...) floats. Returns cudaGetLastError of the launches.
int decode_attn_launch(const void* q, const void* k, const void* v, void* out, void* ws,
                       long long ws_floats, int B, int S, int Hkv, int G, int D, int dtype,
                       float scale, float softcap, int nsplit, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || G < 1 || nsplit < 1 || nsplit > 1024 || padded_dim(D) == 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * Hkv * G > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (ws_floats < decode_attn_workspace(B, Hkv, G, D, nsplit)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (dtype == 0)
    return (int)launch_t<float>(q, k, v, out, w, B, S, Hkv, G, D, nsplit, scale, softcap, s);
  if (dtype == 1)
    return (int)launch_t<__nv_bfloat16>(q, k, v, out, w, B, S, Hkv, G, D, nsplit, scale,
                                        softcap, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
