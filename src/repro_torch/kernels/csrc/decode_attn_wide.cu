// Single-token grouped-query attention for head_dim above 512: the rows the
// split-S flash kernel (decode_attn.cu, built for D <= 512) does not take.
//
// Replaces the TPU kernel `_decode_attn_kernel` / `decode_attention_pallas`
// in src/repro/kernels/decode_attn.py (oracle `decode_attention_ref` in
// src/repro/kernels/ref.py) at any D > 512, which the reference takes and no
// config of the registry reaches. Inputs and function are decode_attn.cu's:
// q [B, Hq, D], a key range [start, end) of k and v [B, S_max, Hkv, D]
// read in place (batch stride S_max·Hkv·D), q, k, v all f32, all bf16, or q
// f32 over a bf16 k and v; Hq = Hkv·G; out [B, Hq, D] in q's type:
//   s_j = q . k_j * scale,  s_j = softcap * tanh(s_j / softcap) if softcap != 0,
//   out = sum_j softmax(s)_j v_j,   all in f32.
//
// What bounds it on an H100: bytes. Each K and V row is read once and used
// for the G query rows of its kv head (D = 1,024, bf16, B 2 × Hkv 2 × 2,048
// keys: 33.5 MB, 10 µs at 3.35 TB/s). Rows are 1 KB and more, so the
// design of decode_attn.cu (a whole K and V row a stage, an [GC, D]
// accumulator in registers) would leave a stage a handful of keys and run
// out of registers past D ~ 2,048. Instead:
//   * Split S. The grid is B·Hkv·⌈G/GC⌉ × nsplit CTAs: a CTA takes one
//     (batch, kv head, group of GC <= 8 query rows) and one range of whole
//     tiles of 16 keys, at most kMaxKeys (512). The wrapper's rule
//     (decode_attn.py: wide_split_count) asks for a CTA an SM: at the
//     shape above, 4 rows × 32 splits of 64 keys.
//   * Two passes over the split, one read of each byte: first its K rows
//     (the scores of all its keys into shared memory, [GC, <= 512] f32),
//     then its exact softmax (max, exp, sum: no rescaling), then its V
//     rows. The scores need whole rows, the output does not: both passes
//     walk the rows in slices of 2 KB (1,024 bf16 or 512 f32 elements), a
//     slice's keys one after the other, and the scores add up slice by
//     slice. So a thread's P·V accumulator is GC x one 16-byte chunk of the
//     slice, 64 f32 registers at most, at any D: it never moves to shared
//     memory.
//   * A ring of NSTAGE stages, one item a stage: 16 rows × one 2 KB slice
//     of K or V (33 KB, rows padded by 16 bytes), a row one bulk copy
//     (cp.async.bulk: the TMA engine without a tensor map; a 2-D tensor
//     map would take a box of at most 256 elements a row, so no fewer
//     copies), K items straight into V items. Warp specialised: a ninth
//     warp only issues the copies, on a slot's "empty" mbarrier (the 8
//     compute warps' arrivals) into its "full" one (the bytes), so the
//     16 copies an item (each a TMA instruction issued on its own) stay
//     off the compute warps' path. The
//     launcher takes NSTAGE (2 to 6) from the card's shared memory: the
//     most that fit one CTA (an H100: 6 stages, 219 KB at GC <= 4; 5 at
//     GC = 8). No L2 evict-first hint: it was slower at D = 1,024 and
//     faster from D = 1,536 on (scripts/probe_decode_wide.py --variants).
//   * Score phase: a pair of warps takes 4 keys of an item, a lane two
//     16-byte chunks of the slice; it holds its 4 keys' chunks and reads
//     each query row's chunk (the slice of q in shared memory as f32) once
//     for the 4 keys, and
//     the 4·GC sums go across the warp by a reduce-scatter (at most 31
//     shuffles) and across the pair through shared memory. P·V phase: a
//     thread owns one 16-byte column chunk of the slice and every other
//     key of the item; the two key phases are added once a slice.
//   * A second launch merges the splits' partial states (m, l, and the
//     unnormalised [GC, D] rows, B·Hq·nsplit·(D + 2) floats of workspace)
//     with the log-sum-exp rule and casts, a CTA an output row's 256
//     columns, its threads over 4 columns and a quarter of the splits each
//     (many loads in flight: the partials are L2 reads). It is a
//     programmatic dependent launch (griddepcontrol), let in as the split
//     kernel's CTAs finish: faster than a plain launch, and than letting
//     its CTAs in from the start (probe_decode_wide.py --variants). With
//     one split the first launch writes the output itself.
//   * Rows that are not whole 16-byte chunks (or k, v off a 16-byte
//     boundary) are loaded by element, the last chunk zero-filled.
//   * Products are written as __fmaf_rn (the build's -fmad=false forbids
//     only the compiler's own contraction).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kConsumerWarps = 8;          // warps that compute ...
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // ... and one that fills the ring
constexpr int kTK = 16;                     // keys an item
constexpr int kSliceB = 2048;               // bytes of a row an item holds
constexpr int kRowB = kSliceB + 16;         // a row of a stage, padded
constexpr int kStageB = kTK * kRowB;        // 33,024 bytes
constexpr int kNCh = kSliceB / 16;          // 16-byte chunks a slice: 128
constexpr int kGroupKeys = kTK / (kConsumers / 64);  // keys a score warp pair: 4
constexpr int kKP = kConsumers / kNCh;      // key phases of the P·V phase: 2
constexpr int kMaxTiles = 32;               // tiles a split at most ...
constexpr int kMaxKeys = kMaxTiles * kTK;   // ... so its 512 scores a row fit
constexpr int kMinStages = 2, kMaxStages = 6;
constexpr int kBarB = (16 * kMaxStages + 15) / 16 * 16;  // full and empty; keeps q_s aligned
constexpr int kMergeCols = 256;             // columns a merge CTA, 4 a thread ...
constexpr int kMergeZP = 4;                 // ... in each of 4 split phases
constexpr int kMergeThreads = kMergeCols / 4 * kMergeZP;
constexpr int kMergeBatch = 8;              // a merge thread's loads issued together
constexpr int kMergeZ = 256;                // (m, l) pairs a merge CTA stages at a time
constexpr float kNegInf = -3.0e38f;         // finite: exp(kNegInf - m) is 0, never NaN
static_assert(kKP == 2 && kNCh % 64 == 0 && kTK % kKP == 0 && kGroupKeys * 8 <= 32, "shape");

// Shared memory of a CTA besides the ring: barriers, the slice of q (then
// the second key phase's P·V sums), the warp pairs' score sums (two
// items), the scores, m and l.
constexpr int fixed_bytes(int GC, int esize) {
  return kBarB + GC * (kSliceB / esize * 4 + 4 * kTK * 4 + kMaxKeys * 4 + 8);
}

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

// One arrival with no bytes expected (an item loaded by element).
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
// copy engine, completed on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
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

// The compute warps' own barrier (the producer warp never waits on it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
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

// A warp's NV values a lane (NV a power of two, at most 32) summed over
// its 32 lanes, reduce-scatter style: at each halving round a lane keeps
// one half of its values, sends the other half to lane ^ o and adds what
// it gets. Afterwards v[0] of lane l holds the warp's total of value
// l >> (5 - log2 NV), in 31 shuffles or fewer.
template <int NV>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[NV], int lane) {
  int n = NV;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (n > 1) {
      const bool hi = lane & o;
#pragma unroll
      for (int i = 0; i < NV / 2; ++i) {
        if (i < n / 2) {
          const float send = hi ? v[i] : v[i + n / 2];
          const float keep = hi ? v[i + n / 2] : v[i];
          v[i] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, o));
        }
      }
      n /= 2;
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(kFull, v[0], o));
    }
  }
}

// Split z of CTA row x = (b, h, group). Query head qh = h·G + g0 + g of
// batch row b is row qr = b·Hq + qh of the output; its partial state is
// acc at ws[(qr·nsplit + z)·D + d], then (m, l) at ml[(qr·nsplit + z)·2 +
// {0, 1}], ml = ws + B·Hq·nsplit·D. QT is q's and out's type, T the
// cache's; k and v point at key `start` of batch row 0, a batch row is
// `bstride` elements; S is the range's length; `chunk` keys a split.
// Warps 0-7 compute; warp 8 fills the ring.
template <typename QT, typename T, int GC>
__global__ void __launch_bounds__(kThreads)
    wide_split_kernel(const QT* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, QT* __restrict__ out, float* __restrict__ ws,
                      int B, int S, long long bstride, int Hkv, int G, int D, int chunk,
                      int nsplit, int nstage, float scale, float softcap, int bulk) {
  constexpr int CE = 16 / (int)sizeof(T);      // elements a chunk
  constexpr int DS = kSliceB / (int)sizeof(T);  // elements a slice
  constexpr int NV = kGroupKeys * GC;           // a score thread's sums: its keys × rows
  constexpr int NQ = GC * DS / kConsumers;      // a thread's elements of a q slice
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + nstage * kStageB);  // [nstage] landed
  uint64_t* empty = full + kMaxStages;                                     // [nstage] read
  float* q_s = reinterpret_cast<float*>(smem + nstage * kStageB + kBarB);  // [GC][DS]
  float* red = q_s;                             // P·V: the second key phase's sums
  float* s_part = q_s + GC * DS;                // [2 items][2 warps][kTK][GC] warp sums
  float* s_sc = s_part + 4 * kTK * GC;          // [GC][kMaxKeys] scores, then exp(s - m)
  float* ml_s = s_sc + GC * kMaxKeys;           // [2][GC] m, l

  const int ngroups = (G + GC - 1) / GC;
  const int z = blockIdx.x % nsplit;
  const int x = blockIdx.x / nsplit;
  const int bh = x / ngroups;
  const int b = bh / Hkv, h = bh % Hkv;
  const int g0 = (x % ngroups) * GC;
  const int ng = min(GC, G - g0);
  const int k0 = z * chunk;
  const int nk = min(S, k0 + chunk) - k0;  // keys of the split (>= 1)
  const int ntiles = (nk + kTK - 1) / kTK;
  const int nslice = (D + DS - 1) / DS;
  const int nhalf = nslice * ntiles;  // K items, then as many V items
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int Hq = Hkv * G;
  const size_t qr0 = (size_t)b * Hq + (size_t)h * G + g0;  // the group's first output row
  const size_t rs = (size_t)Hkv * D;                        // elements from key s to s+1

  // Element r of this consumer's share of the query rows' slice sl, as
  // f32 (zero past D and past the group); the first slice's loads go out
  // before the ring's copies queue up, and are stored after the barrier.
  auto q_elem = [&](int sl, int r) {
    const int i = t + r * kConsumers, g = i / DS, d = sl * DS + i % DS;
    return g < ng && d < D ? to_f32(q[(qr0 + g) * D + d]) : 0.0f;
  };
  float xq[NQ];
  if (warp < kConsumerWarps) {
#pragma unroll
    for (int r = 0; r < NQ; ++r) xq[r] = q_elem(0, r);
  }
  if (t == 0) {
    for (int i = 0; i < nstage; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // The producer: item i (K for i < nhalf, then V; slice i' / ntiles,
    // tile i' % ntiles) into slot i % nstage once the consumers have read
    // what it held: a bulk copy a row (lanes < 16), or by element.
    const T* kb = k + (size_t)b * bstride + (size_t)h * D + (size_t)k0 * rs;
    const T* vb = v + (size_t)b * bstride + (size_t)h * D + (size_t)k0 * rs;
    for (int i = 0; i < 2 * nhalf; ++i) {
      const int slot = i % nstage;
      if (i >= nstage) mbar_wait(empty + slot, (i / nstage - 1) & 1);
      unsigned char* st = ring + slot * kStageB;
      const int kv = i >= nhalf, it = kv ? i - nhalf : i;
      const int sl = it / ntiles, j0 = it % ntiles * kTK;
      const int nv = min(kTK, nk - j0);
      const int w = min(DS, D - sl * DS);  // elements of the slice
      const T* src = (kv ? vb : kb) + (size_t)j0 * rs + (size_t)sl * DS;
      if (bulk) {
        if (lane == 0) mbar_expect(full + slot, (unsigned)(nv * w * sizeof(T)));
        if (lane < nv)
          bulk_copy(st + lane * kRowB, src + (size_t)lane * rs, w * sizeof(T), full + slot);
      } else {
        const int wc = (w + CE - 1) / CE * CE;  // whole chunks, zero past w
        for (int e = lane; e < nv * wc; e += 32) {
          const int r = e / wc, c = e % wc;
          reinterpret_cast<T*>(st + r * kRowB)[c] =
              c < w ? src[(size_t)r * rs + c] : from_f32<T>(0.0f);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(full + slot);
      }
    }
    return;
  }

  // Consumers. Item i landed, and read: the slot goes back to the producer.
  auto wait_item = [&](int i) {
    mbar_wait(full + i % nstage, (i / nstage) & 1);
    return ring + (i % nstage) * kStageB;
  };
  auto release_item = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + i % nstage);
  };
#pragma unroll
  for (int r = 0; r < NQ; ++r) q_s[t + r * kConsumers] = xq[r];
  consumer_sync();

  // Scores. Warps 2kg and 2kg+1 take keys kg·4.. of an item; lane l of the
  // pair's 64 takes chunks (warp % 2)·32 + l and that + 64 of the slice,
  // holds its query chunk once for the 4 keys, and the pair's sums go
  // through a reduce-scatter and shared memory (two buffers, by item).
  for (int i = 0; i < nhalf; ++i) {
    const int sl = i / ntiles, j0 = i % ntiles * kTK;
    const int nch = (min(DS, D - sl * DS) + CE - 1) / CE;  // chunks of the slice
    if (i % ntiles == 0 && sl > 0) {  // everyone is past the last slice's sums
#pragma unroll
      for (int r = 0; r < NQ; ++r) xq[r] = q_elem(sl, r);  // a thread's loads together
#pragma unroll
      for (int r = 0; r < NQ; ++r) q_s[t + r * kConsumers] = xq[r];
      consumer_sync();
    }
    const unsigned char* st = wait_item(i);
    const int key0 = (warp / 2) * kGroupKeys;
    float sv[NV];  // key kk, row g at kk·GC + g
#pragma unroll
    for (int n = 0; n < NV; ++n) sv[n] = 0.0f;
#pragma unroll
    for (int c = 0; c < kNCh / 64; ++c) {
      const int cc = c * 64 + (warp % 2) * 32 + lane;
      if (cc < nch) {
        float kf[kGroupKeys][CE];  // the 4 keys' chunks, then one query row's at a time
#pragma unroll
        for (int kk = 0; kk < kGroupKeys; ++kk)
          chunk_to_f32<T>(
              *reinterpret_cast<const uint4*>(st + (key0 + kk) * kRowB + cc * 16), kf[kk]);
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          float qf[CE];
#pragma unroll
          for (int e4 = 0; e4 < CE / 4; ++e4) {
            const float4 qq = reinterpret_cast<const float4*>(q_s + g * DS + cc * CE)[e4];
            qf[4 * e4] = qq.x, qf[4 * e4 + 1] = qq.y, qf[4 * e4 + 2] = qq.z;
            qf[4 * e4 + 3] = qq.w;
          }
#pragma unroll
          for (int kk = 0; kk < kGroupKeys; ++kk)
#pragma unroll
            for (int e = 0; e < CE; ++e)
              sv[kk * GC + g] = __fmaf_rn(qf[e], kf[kk][e], sv[kk * GC + g]);
        }
      }
    }
    release_item(i);
    warp_reduce_scatter<NV>(sv, lane);
    float* part = s_part + (i & 1) * 2 * kTK * GC;
    if (lane % (32 / NV) == 0)  // value lane / (32 / NV): key kk, row g
      part[((warp % 2) * kTK + key0) * GC + lane / (32 / NV)] = sv[0];
    consumer_sync();
    // The pair's sums added, and to the earlier slices' sums.
    if (t < kTK * GC) {
      const int j = t / GC, g = t % GC;
      const float sum = __fadd_rn(part[t], part[kTK * GC + t]);
      float* dst = s_sc + g * kMaxKeys + j0 + j;
      *dst = sl > 0 ? __fadd_rn(*dst, sum) : sum;
    }
  }
  consumer_sync();

  // Softmax over the split's keys, exact (all its scores are here): warp g
  // takes query row g.
  if (warp < ng) {
    float* row = s_sc + warp * kMaxKeys;
    float mx = kNegInf;
    for (int j = lane; j < nk; j += 32) {
      float s = __fmul_rn(row[j], scale);
      if (softcap != 0.0f) s = __fmul_rn(softcap, tanhf(__fdiv_rn(s, softcap)));
      row[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float l = 0.0f;
    for (int j = lane; j < nk; j += 32) {
      const float pj = expf(__fsub_rn(row[j], mx));
      row[j] = pj;
      l = __fadd_rn(l, pj);
    }
    l = warp_sum(l);
    if (lane == 0) ml_s[warp] = mx, ml_s[GC + warp] = l;
  }
  consumer_sync();

  // P·V: this thread's chunk of the slice over keys kp, kp + 2, ... of an
  // item; a slice's two key phases added at its last item, and written.
  const int ch = t % kNCh, kp = t / kNCh;
  float acc[GC][CE];
  for (int i = nhalf; i < 2 * nhalf; ++i) {
    const int it = i - nhalf, sl = it / ntiles, tile = it % ntiles, j0 = tile * kTK;
    const int nch = (min(DS, D - sl * DS) + CE - 1) / CE;
    const unsigned char* st = wait_item(i);
    if (tile == 0) {
#pragma unroll
      for (int g = 0; g < GC; ++g)
#pragma unroll
        for (int e = 0; e < CE; ++e) acc[g][e] = 0.0f;
    }
    if (ch < nch) {
#pragma unroll
      for (int jj = 0; jj < kTK / kKP; ++jj) {
        const int j = kp + jj * kKP;
        if (j0 + j < nk) {
          float vf[CE];
          chunk_to_f32<T>(*reinterpret_cast<const uint4*>(st + j * kRowB + ch * 16), vf);
#pragma unroll
          for (int g = 0; g < GC; ++g) {
            const float pj = s_sc[g * kMaxKeys + j0 + j];
#pragma unroll
            for (int e = 0; e < CE; ++e) acc[g][e] = __fmaf_rn(pj, vf[e], acc[g][e]);
          }
        }
      }
    }
    release_item(i);
    if (tile == ntiles - 1) {
      if (kp == 1 && ch < nch) {
#pragma unroll
        for (int g = 0; g < GC; ++g)
#pragma unroll
          for (int e = 0; e < CE; ++e) red[g * DS + ch * CE + e] = acc[g][e];
      }
      consumer_sync();
      if (kp == 0 && ch < nch) {
        for (int g = 0; g < ng; ++g) {
#pragma unroll
          for (int e = 0; e < CE; ++e) {
            const int d = sl * DS + ch * CE + e;
            if (d < D) {
              const float num = __fadd_rn(acc[g][e], red[g * DS + ch * CE + e]);
              if (nsplit == 1)
                out[(qr0 + g) * D + d] = from_f32<QT>(__fdiv_rn(num, ml_s[GC + g]));
              else
                ws[((qr0 + g) * nsplit + z) * D + d] = num;
            }
          }
        }
      }
      consumer_sync();  // red is read before the next slice writes it
    }
  }
  // The merge may place its CTAs now (they wait for this grid's end);
  // earlier, they took the SMs' room from this kernel's last items.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (nsplit > 1 && t < ng) {
    float* ml = ws + (size_t)B * Hq * nsplit * D;
    ml[((qr0 + t) * nsplit + z) * 2] = ml_s[t];
    ml[((qr0 + t) * nsplit + z) * 2 + 1] = ml_s[GC + t];
  }
}

// One CTA a (output row qr = b·Hq + qh, kMergeCols columns): the row's
// nsplit partial states merged with the log-sum-exp rule, divided and
// cast. Launched as a programmatic dependent of the split kernel, so its
// CTAs are placed as that one's CTAs finish and wait here for its end. The
// (m, l) pairs go through shared memory (one round trip), every thread
// weighs the splits from them, the same sums in the same order; thread t
// takes 4 columns and the splits z = t / 64 (mod 4), its loads of the
// partials (L2 reads) kMergeBatch at a time; the 4 phases are added in
// order.
template <typename QT>
__global__ void __launch_bounds__(kMergeThreads)
    wide_merge_kernel(const float* __restrict__ ws, QT* __restrict__ out, int rows, int D,
                      int nsplit, int ncb) {
  __shared__ float ml_s[2 * kMergeZ];
  __shared__ __align__(16) float part_s[kMergeZP][kMergeCols];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t qr = blockIdx.x / ncb;
  const int t = threadIdx.x, zp = t / (kMergeCols / 4);
  const int d0 = (int)(blockIdx.x % ncb) * kMergeCols, c = 4 * (t % (kMergeCols / 4));
  const float* ml = ws + (size_t)rows * nsplit * D + qr * nsplit * 2;  // (m, l) of split z at 2z
  const float* src = ws + qr * nsplit * D + d0 + c;                     // + z·D
  const bool vec = D % 4 == 0 && d0 + c + 4 <= D;
  auto stage = [&](int z0, int nz) {  // (m, l) of splits z0.. into ml_s
    __syncthreads();
    for (int i = t; i < 2 * nz; i += kMergeThreads) ml_s[i] = ml[2 * z0 + i];
    __syncthreads();
  };
  float M = kNegInf;
  for (int z0 = 0; z0 < nsplit; z0 += kMergeZ) {
    const int nz = min(kMergeZ, nsplit - z0);
    stage(z0, nz);
    for (int i = 0; i < nz; ++i) M = fmaxf(M, ml_s[2 * i]);
  }
  float L = 0.0f, num[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int z0 = 0; z0 < nsplit; z0 += kMergeZ) {
    const int nz = min(kMergeZ, nsplit - z0);
    if (nsplit > kMergeZ) stage(z0, nz);  // else still staged
    for (int i = 0; i < nz; ++i) L = __fmaf_rn(ml_s[2 * i + 1], expf(__fsub_rn(ml_s[2 * i], M)), L);
    if (d0 + c >= D) continue;
    for (int i0 = zp; i0 < nz; i0 += kMergeZP * kMergeBatch) {
      float4 x[kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        const int i = i0 + u * kMergeZP;
        x[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (i < nz) {
          const float* p = src + (size_t)(z0 + i) * D;
          if (vec) {
            x[u] = *reinterpret_cast<const float4*>(p);
          } else {
            x[u].x = p[0];
            if (d0 + c + 1 < D) x[u].y = p[1];
            if (d0 + c + 2 < D) x[u].z = p[2];
            if (d0 + c + 3 < D) x[u].w = p[3];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        const int i = i0 + u * kMergeZP;
        if (i < nz) {
          const float f = expf(__fsub_rn(ml_s[2 * i], M));
          num[0] = __fmaf_rn(x[u].x, f, num[0]);
          num[1] = __fmaf_rn(x[u].y, f, num[1]);
          num[2] = __fmaf_rn(x[u].z, f, num[2]);
          num[3] = __fmaf_rn(x[u].w, f, num[3]);
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) part_s[zp][c + e] = num[e];
  __syncthreads();
  const int d = d0 + t;
  if (t < kMergeCols && d < D) {
    float sum = part_s[0][t];
#pragma unroll
    for (int z = 1; z < kMergeZP; ++z) sum = __fadd_rn(sum, part_s[z][t]);
    out[qr * D + d] = from_f32<QT>(__fdiv_rn(sum, L));
  }
}

// Query rows a CTA: the least power of two >= G, at most 8.
int group_rows(int G) { return G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8; }

// Stages of the ring: the most, 2 to kMaxStages, with which a CTA fits
// the shared memory a block may take (0: not even two fit). One CTA an SM
// keeps NSTAGE - 1 items of 33 KB in flight. decode_attn.py mirrors this
// as `wide_stages`.
int pick_stages(int fixed, int budget) {
  for (int n = kMaxStages; n >= kMinStages; --n)
    if (fixed + n * kStageB <= budget) return n;
  return 0;
}

// Stages of a build on this device (read once a build: the first call's
// device), -1 if a query fails.
template <typename QT, typename T, int GC>
int stages() {
  static const int n = [] {
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess ||
        cudaFuncGetAttributes(&attr, wide_split_kernel<QT, T, GC>) != cudaSuccess)
      return -1;
    return pick_stages(fixed_bytes(GC, sizeof(T)), optin - (int)attr.sharedSizeBytes);
  }();
  return n;
}

template <typename QT, typename T, int GC>
cudaError_t launch_gc(const void* q, const T* k, const T* v, void* out, float* ws, int B, int S,
                      long long bstride, int Hkv, int G, int D, int chunk, int nsplit,
                      float scale, float softcap, int bulk, cudaStream_t s) {
  auto kern = wide_split_kernel<QT, T, GC>;
  const int nstage = stages<QT, T, GC>();
  if (nstage < kMinStages) return cudaErrorInvalidValue;
  const int bytes = nstage * kStageB + fixed_bytes(GC, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)B * Hkv * ((G + GC - 1) / GC);
  if (rows * nsplit > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<(unsigned)(rows * nsplit), kThreads, bytes, s>>>(
      static_cast<const QT*>(q), k, v, static_cast<QT*>(out), ws, B, S, bstride, Hkv, G, D,
      chunk, nsplit, nstage, scale, softcap, bulk);
  return cudaGetLastError();
}

template <typename QT, typename T>
cudaError_t launch_t(const void* q, const T* k, const T* v, void* out, float* ws, int B, int S,
                     long long bstride, int Hkv, int G, int D, int nsplit, float scale,
                     float softcap, cudaStream_t s) {
  const int bulk = D * (int)sizeof(T) % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  // Whole tiles a split, at most kMaxTiles; the last split takes what is left.
  const int tiles = (S + kTK - 1) / kTK;
  const int per = (tiles + nsplit - 1) / nsplit;
  if (per > kMaxTiles) return cudaErrorInvalidValue;
  nsplit = (tiles + per - 1) / per;
  const int chunk = per * kTK;
  cudaError_t err;
  switch (group_rows(G)) {
    case 1: err = launch_gc<QT, T, 1>(q, k, v, out, ws, B, S, bstride, Hkv, G, D, chunk, nsplit, scale, softcap, bulk, s); break;
    case 2: err = launch_gc<QT, T, 2>(q, k, v, out, ws, B, S, bstride, Hkv, G, D, chunk, nsplit, scale, softcap, bulk, s); break;
    case 4: err = launch_gc<QT, T, 4>(q, k, v, out, ws, B, S, bstride, Hkv, G, D, chunk, nsplit, scale, softcap, bulk, s); break;
    default: err = launch_gc<QT, T, 8>(q, k, v, out, ws, B, S, bstride, Hkv, G, D, chunk, nsplit, scale, softcap, bulk, s); break;
  }
  if (err != cudaSuccess || nsplit == 1) return err;
  const int rows = B * Hkv * G;
  const long long ncb = (D + kMergeCols - 1) / kMergeCols;
  if (rows * ncb > 0x7fffffffLL) return cudaErrorInvalidValue;
  // A programmatic dependent launch: the merge's CTAs are placed before
  // the split kernel ends, and wait in the kernel (griddepcontrol.wait).
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * ncb));
  cfg.blockDim = dim3(kMergeThreads);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, wide_merge_kernel<QT>, static_cast<const float*>(ws),
                           static_cast<QT*>(out), rows, D, nsplit, (int)ncb);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of workspace a launch with `nsplit` splits needs (0 for one split):
// the splits' unnormalised rows and their (m, l).
long long decode_attn_wide_workspace(int B, int Hkv, int G, int D, int nsplit) {
  if (nsplit <= 1) return 0;
  return (long long)B * Hkv * G * nsplit * ((long long)D + 2);
}

// k and v are [B, s_max, Hkv, D]; the keys [start, end) are read.
// dtype: 0 = all f32, 1 = all bf16, 2 = q and out f32 over bf16 k and v.
// Any D >= 1 (the wrapper sends D > 512 here); nsplit >= 1 splits of whole
// 16-key tiles, at most 32 tiles a split (fewer splits are used when the
// range has fewer tiles); `ws` holds at least decode_attn_wide_workspace(...)
// floats. Returns cudaGetLastError of the launches.
int decode_attn_wide_launch(const void* q, const void* k, const void* v, void* out, void* ws,
                            long long ws_floats, int B, int s_max, int start, int end, int Hkv,
                            int G, int D, int dtype, float scale, float softcap, int nsplit,
                            void* stream) {
  if (B < 1 || start < 0 || end <= start || end > s_max || Hkv < 1 || G < 1 || D < 1 ||
      nsplit < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * Hkv * G > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (ws_floats < decode_attn_wide_workspace(B, Hkv, G, D, nsplit))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  const long long bstride = (long long)s_max * Hkv * D;  // elements a batch row
  const size_t first = (size_t)start * Hkv * D;          // key `start` of batch row 0
  const int S = end - start;
  using bf16 = __nv_bfloat16;
  if (dtype == 0)
    return (int)launch_t<float, float>(q, static_cast<const float*>(k) + first,
                                       static_cast<const float*>(v) + first, out, w, B, S,
                                       bstride, Hkv, G, D, nsplit, scale, softcap, s);
  if (dtype == 1)
    return (int)launch_t<bf16, bf16>(q, static_cast<const bf16*>(k) + first,
                                     static_cast<const bf16*>(v) + first, out, w, B, S, bstride,
                                     Hkv, G, D, nsplit, scale, softcap, s);
  if (dtype == 2)
    return (int)launch_t<float, bf16>(q, static_cast<const bf16*>(k) + first,
                                      static_cast<const bf16*>(v) + first, out, w, B, S, bstride,
                                      Hkv, G, D, nsplit, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
