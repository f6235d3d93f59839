// Streaming-scorer block commit for the chunked vertex-cut partitioners.
//
// Replaces the TPU kernel `_ebg_commit_kernel` / `ebg_commit_block_pallas`
// in src/repro/kernels/ebg_commit.py. For each block of B edges:
//   1. miss bits of u and v against the BLOCK-START packed membership bitset
//      keep[p, vw] (bit k of word w = vertex 32*w + k), for every part;
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
// What bounds it on an H100: the per-edge chain is strictly sequential
// (edge j+1's argmin needs edge j's counters), so the cost is the latency
// of one score + reduction round per edge, not bytes or FLOPs. The design
// keeps that chain as short as the card allows: one CTA; the p <= 32 parts
// live one per lane of warp 0, so the argmin (and the range normalizer's
// max/min) are register shuffles with no block barrier; the counters stay
// in registers for the whole launch; the block's miss bits are gathered
// up front by all threads into shared memory as one 32-bit lane mask per
// edge and endpoint; the bitset (16 MB at 2^22 vertices and p = 32) stays
// in global memory, where L2 holds it, and is read through L2 (ld.cg) so
// that the commits (atomicOr at L2) are seen by the next block's gather.
// p > 32 uses the same loop with block-wide reductions through shared
// memory. One launch walks `nblocks` consecutive blocks, carrying the
// state in place.
//
// Bit parity: the score is the reference's arithmetic as XLA compiles it on
// the CPU, where `gain + ce*e*norm + cv*v*inv_v` becomes two fused
// multiply-adds, fma(cv*v, inv_v, fma(ce*e, norm, gain)) — that is what
// the pinned reference outputs were computed with. The two FMAs are written
// out (__fmaf_rn); everything else is built with -fmad=false and written
// with __fmul_rn/__fadd_rn/__fdiv_rn, so nothing else is contracted and the
// range normalizer's division is IEEE.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Smem {
  uint32_t* mu;   // [B * W] miss-u lane masks, word w covers parts 32w..32w+31
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

template <bool SINGLE_WARP, bool RANGE, bool WEIGHTED, bool WINDOW>
__global__ void ebg_commit_kernel(uint32_t* __restrict__ keep, float* __restrict__ e_count,
                                  float* __restrict__ v_count, const int* __restrict__ u,
                                  const int* __restrict__ v, const uint8_t* __restrict__ valid,
                                  const float* __restrict__ wu, const float* __restrict__ wv,
                                  const float* __restrict__ coef, int* __restrict__ parts, int p,
                                  int vw, int B, int nblocks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = (p + 31) >> 5;
  Smem sm;
  sm.mu = reinterpret_cast<uint32_t*>(smem_raw);
  sm.mv = sm.mu + (size_t)B * W;
  sm.su = reinterpret_cast<int*>(sm.mv + (size_t)B * W);
  sm.sv = sm.su + B;
  sm.sval = sm.sv + B;
  sm.swu = reinterpret_cast<float*>(sm.sval + B);
  sm.swv = sm.swu + B;
  sm.swin = reinterpret_cast<int*>(sm.swv + B);
  sm.red_f = reinterpret_cast<float*>(sm.swin + B);
  sm.red_i = reinterpret_cast<int*>(sm.red_f + 4 * 32);

  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const bool part_lane = t < p;
  const float kPosInf = __int_as_float(0x7f800000);
  const float ce = coef[0], cv = coef[1], inv_e = coef[2], inv_v = coef[3], eps = coef[4];

  // Counters live in the lane registers of their part for the whole launch.
  float e_c = part_lane ? e_count[t] : 0.0f;
  float v_c = part_lane ? v_count[t] : 0.0f;

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
      const int uu = sm.su[j], vv = sm.sv[j];
      const uint32_t* col_u = keep + (uu >> 5);
      const uint32_t* col_v = keep + (vv >> 5);
      const int bu = uu & 31, bv = vv & 31;
      uint32_t mu = 0, mv = 0;
      const int nl = min(32, p - 32 * w);
#pragma unroll 8
      for (int l = 0; l < nl; ++l) {
        const size_t row = (size_t)(32 * w + l) * vw;
        mu |= ((~__ldcg(col_u + row) >> bu) & 1u) << l;
        mv |= ((~__ldcg(col_v + row) >> bv) & 1u) << l;
      }
      sm.mu[k] = mu;
      sm.mv[k] = mv;
    }
    __syncthreads();

    // ---- 2. the sequential per-edge argmin + exact counter commit.
    if (!SINGLE_WARP || warp == 0) {
      const int pw = t >> 5;  // this lane's mask word
      for (int j = 0; j < B; ++j) {
        float mu = 0.0f, mv = 0.0f;
        if (part_lane) {
          mu = (float)((sm.mu[j * W + pw] >> lane) & 1u);
          mv = (float)((sm.mv[j * W + pw] >> lane) & 1u);
        }
        float gain;
        if (WEIGHTED) {
          gain = __fadd_rn(__fmul_rn(sm.swu[j], mu), __fmul_rn(sm.swv[j], mv));
        } else {
          gain = __fadd_rn(mu, mv);
        }
        float norm = inv_e;
        if (RANGE) {
          float mx = part_lane ? e_c : -kPosInf;
          float mn = part_lane ? e_c : kPosInf;
          warp_maxmin(mx, mn);
          if (!SINGLE_WARP) {
            if (lane == 0) {
              sm.red_f[warp] = mx;
              sm.red_f[32 + warp] = mn;
            }
            __syncthreads();
            const int nw = T >> 5;
            mx = sm.red_f[0];
            mn = sm.red_f[32];
            for (int w = 1; w < nw; ++w) {
              mx = fmaxf(mx, sm.red_f[w]);
              mn = fminf(mn, sm.red_f[32 + w]);
            }
          }
          norm = __fdiv_rn(1.0f, __fadd_rn(eps, __fsub_rn(mx, mn)));
        }
        const float score = __fmaf_rn(__fmul_rn(cv, v_c), inv_v,
                                      __fmaf_rn(__fmul_rn(ce, e_c), norm, gain));
        float s = part_lane ? score : kPosInf;
        int win = part_lane ? t : 0x7fffffff;
        warp_argmin(s, win);
        if (!SINGLE_WARP) {
          const int par = j & 1;
          if (lane == 0) {
            sm.red_f[64 + 32 * par + warp] = s;
            sm.red_i[32 * par + warp] = win;
          }
          __syncthreads();
          const int nw = T >> 5;
          s = sm.red_f[64 + 32 * par];
          win = sm.red_i[32 * par];
          for (int w = 1; w < nw; ++w) better(s, win, sm.red_f[64 + 32 * par + w], sm.red_i[32 * par + w]);
        }
        const bool ok = sm.sval[j] != 0;
        if (ok && t == win) {
          e_c = __fadd_rn(e_c, 1.0f);
          v_c = __fadd_rn(v_c, __fadd_rn(mu, mv));
        }
        if (t == 0) {
          const int row = ok ? win : p;
          sm.swin[j] = row;
          parts[base + j] = row;
        }
        if (WINDOW && ok) {
          // Replay: later columns touching u_j or v_j no longer miss in `win`.
          const int uj = sm.su[j], vj = sm.sv[j];
          const int word = win >> 5;
          const uint32_t clear = ~(1u << (win & 31));
          const int stride = SINGLE_WARP ? 32 : T;
          for (int k = j + 1 + t; k < B; k += stride) {
            const int uk = sm.su[k], vk = sm.sv[k];
            if (uk == uj || uk == vj) sm.mu[k * W + word] &= clear;
            if (vk == uj || vk == vj) sm.mv[k * W + word] &= clear;
          }
          if (SINGLE_WARP) {
            __syncwarp();
          } else {
            __syncthreads();
          }
        }
      }
    }
    __syncthreads();

    // ---- 3. commit the winners' membership bits (atomic: u and v, or two
    // edges of the block, may share a word).
    for (int j = t; j < B; j += T) {
      const int row = sm.swin[j];
      if (row < p) {
        const int uu = sm.su[j], vv = sm.sv[j];
        atomicOr(keep + (size_t)row * vw + (uu >> 5), 1u << (uu & 31));
        atomicOr(keep + (size_t)row * vw + (vv >> 5), 1u << (vv & 31));
      }
    }
    __syncthreads();
  }
  if (part_lane) {
    e_count[t] = e_c;
    v_count[t] = v_c;
  }
}

template <bool SINGLE_WARP, bool RANGE, bool WEIGHTED, bool WINDOW>
cudaError_t launch(int threads, size_t smem, cudaStream_t stream, uint32_t* keep, float* e,
                   float* vc, const int* u, const int* v, const uint8_t* valid, const float* wu,
                   const float* wv, const float* coef, int* parts, int p, int vw, int B,
                   int nblocks) {
  auto kern = ebg_commit_kernel<SINGLE_WARP, RANGE, WEIGHTED, WINDOW>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<1, threads, smem, stream>>>(keep, e, vc, u, v, valid, wu, wv, coef, parts, p, vw, B,
                                     nblocks);
  return cudaGetLastError();
}

template <bool SINGLE_WARP>
cudaError_t dispatch(int range, int weighted, int window, int threads, size_t smem,
                     cudaStream_t s, uint32_t* keep, float* e, float* vc, const int* u,
                     const int* v, const uint8_t* valid, const float* wu, const float* wv,
                     const float* coef, int* parts, int p, int vw, int B, int nblocks) {
#define EBG_CASE(R, WT, WN)                                                                   \
  if (!!range == R && !!weighted == WT && !!window == WN)                                     \
    return launch<SINGLE_WARP, R, WT, WN>(threads, smem, s, keep, e, vc, u, v, valid, wu, wv, \
                                          coef, parts, p, vw, B, nblocks);
  EBG_CASE(false, false, false)
  EBG_CASE(false, false, true)
  EBG_CASE(false, true, false)
  EBG_CASE(false, true, true)
  EBG_CASE(true, false, false)
  EBG_CASE(true, false, true)
  EBG_CASE(true, true, false)
  EBG_CASE(true, true, true)
#undef EBG_CASE
  return cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory one launch needs: the Smem layout above
// (ebg_commit.py checks the same sum against the card's limit).
size_t smem_bytes(int p, int B) {
  const size_t W = (size_t)(p + 31) / 32;
  return (size_t)B * (2 * W * 4 + 6 * 4) + 4 * 32 * 4 + 2 * 32 * 4;
}

}  // namespace

extern "C" {

// Walk `nblocks` blocks of B edges in order, updating keep/e_count/v_count
// in place and writing parts[nblocks * B]. valid is 1 byte per edge.
int ebg_commit_launch(void* keep, void* e_count, void* v_count, const void* u, const void* v,
                      const void* valid, const void* wu, const void* wv, const void* coef,
                      void* parts, int p, int vw, int B, int nblocks, int range, int weighted,
                      int window, void* stream) {
  if (p < 1 || p > 1024 || B < 1 || nblocks < 1) return (int)cudaErrorInvalidValue;
  const int W = (p + 31) / 32;
  const bool single = W == 1;
  const int threads = single ? 256 : (32 * W > 256 ? 32 * W : 256);
  const size_t smem = smem_bytes(p, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* kb = static_cast<uint32_t*>(keep);
  auto* e = static_cast<float*>(e_count);
  auto* vc = static_cast<float*>(v_count);
  auto* uu = static_cast<const int*>(u);
  auto* vv = static_cast<const int*>(v);
  auto* ok = static_cast<const uint8_t*>(valid);
  auto* fu = static_cast<const float*>(wu);
  auto* fv = static_cast<const float*>(wv);
  auto* cf = static_cast<const float*>(coef);
  auto* pt = static_cast<int*>(parts);
  cudaError_t err =
      single ? dispatch<true>(range, weighted, window, threads, smem, s, kb, e, vc, uu, vv, ok,
                              fu, fv, cf, pt, p, vw, B, nblocks)
             : dispatch<false>(range, weighted, window, threads, smem, s, kb, e, vc, uu, vv, ok,
                               fu, fv, cf, pt, p, vw, B, nblocks);
  return (int)err;
}

}  // extern "C"
