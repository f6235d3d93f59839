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
// A simple kernel in three launches on one stream, through an f32
// workspace P [B, Hq, L] (L = end - start):
//   1. scores: one warp a (b, kv head, key); the lanes take 16-byte chunks
//      of the key's row (by element when a row is not a whole number of
//      chunks or k is off a 16-byte boundary), dot them with each of the G
//      query rows in f32, and reduce across the warp;
//   2. softmax: one CTA a (b, query head) takes the row's max, then the sum
//      of exp(s - max), and writes the probabilities in place;
//   3. output: one CTA a (b, query head, 256-wide slice of D); a thread owns
//      one column and adds p_j v_j over the range in f32.
// Every product is written as __fmaf_rn or __fmul_rn (the build's
// -fmad=false forbids only the compiler's own contraction).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSoftmaxThreads = 256;
constexpr int kOutCols = 256;   // columns of D a CTA of the output launch takes
constexpr int kScoreWarps = 8;  // warps (keys) a CTA of the score launch

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// 1. Scores. Warp w of the grid takes key j = w % L of (b, h) = w / L;
// VEC: the row is a whole number of 16-byte chunks and k is aligned.
template <typename TQ, typename TK, bool VEC>
__global__ void __launch_bounds__(kScoreWarps * 32)
scores_kernel(const TQ* __restrict__ q, const TK* __restrict__ k, float* __restrict__ p, int B,
              int L, long long bstride, int Hkv, int G, int D, float scale, float softcap) {
  const long long warp = (long long)blockIdx.x * kScoreWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= (long long)B * Hkv * L) return;
  const int j = (int)(warp % L);
  const long long bh = warp / L;
  const int h = (int)(bh % Hkv), b = (int)(bh / Hkv);
  const TK* krow = k + b * bstride + ((long long)j * Hkv + h) * D;
  const int Hq = Hkv * G;
  constexpr int CE = 16 / (int)sizeof(TK);  // elements a 16-byte chunk
  for (int g = 0; g < G; ++g) {
    const TQ* qrow = q + ((long long)b * Hq + h * G + g) * D;
    float acc = 0.0f;
    if (VEC) {
      for (int c = lane; c < D / CE; c += 32) {
        const uint4 raw = reinterpret_cast<const uint4*>(krow)[c];
        const TK* kv = reinterpret_cast<const TK*>(&raw);
#pragma unroll
        for (int e = 0; e < CE; ++e) acc = __fmaf_rn(to_f32(qrow[c * CE + e]), to_f32(kv[e]), acc);
      }
    } else {
      for (int d = lane; d < D; d += 32) acc = __fmaf_rn(to_f32(qrow[d]), to_f32(krow[d]), acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      float s = __fmul_rn(acc, scale);
      if (softcap != 0.0f) s = __fmul_rn(softcap, tanhf(__fdiv_rn(s, softcap)));
      p[((long long)b * Hq + h * G + g) * L + j] = s;
    }
  }
}

// A block-wide reduction of one value a thread (max or sum); every thread
// gets the result.
template <bool MAX>
__device__ float block_reduce(float x, float* red) {
  x = MAX ? warp_max(x) : warp_sum(x);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read from the last call
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < (int)(blockDim.x / 32) ? red[lane] : (MAX ? -3.0e38f : 0.0f);
  return MAX ? warp_max(x) : warp_sum(x);
}

// 2. Softmax, in place, one CTA a row of L scores.
__global__ void __launch_bounds__(kSoftmaxThreads) softmax_kernel(float* __restrict__ p, int L) {
  __shared__ float red[kSoftmaxThreads / 32];
  float* row = p + (long long)blockIdx.x * L;
  float m = -3.0e38f;
  for (int j = threadIdx.x; j < L; j += blockDim.x) m = fmaxf(m, row[j]);
  m = block_reduce<true>(m, red);
  float l = 0.0f;
  for (int j = threadIdx.x; j < L; j += blockDim.x) l = __fadd_rn(l, expf(__fsub_rn(row[j], m)));
  l = block_reduce<false>(l, red);
  for (int j = threadIdx.x; j < L; j += blockDim.x) row[j] = __fdiv_rn(expf(__fsub_rn(row[j], m)), l);
}

// 3. Output: CTA (b·Hq + qh, slice) adds p_j v_j for its kOutCols columns.
template <typename TQ, typename TK>
__global__ void __launch_bounds__(kOutCols)
output_kernel(const float* __restrict__ p, const TK* __restrict__ v, TQ* __restrict__ out, int L,
              long long bstride, int Hkv, int G, int D) {
  const int row = blockIdx.x;  // b·Hq + qh
  const int Hq = Hkv * G;
  const int b = row / Hq, h = (row % Hq) / G;
  const int d = blockIdx.y * kOutCols + threadIdx.x;
  if (d >= D) return;
  const float* prow = p + (long long)row * L;
  const TK* vcol = v + b * bstride + (long long)h * D + d;
  const long long kstride = (long long)Hkv * D;
  float acc = 0.0f;
  for (int j = 0; j < L; ++j) acc = __fmaf_rn(prow[j], to_f32(vcol[j * kstride]), acc);
  out[(long long)row * D + d] = from_f32<TQ>(acc);
}

template <typename TQ, typename TK>
cudaError_t launch_t(const void* q, const TK* k, const TK* v, void* out, float* ws, int B, int L,
                     long long bstride, int Hkv, int G, int D, float scale, float softcap,
                     cudaStream_t s) {
  const long long warps = (long long)B * Hkv * L;
  const long long blocks = (warps + kScoreWarps - 1) / kScoreWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = (D * (int)sizeof(TK)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0;
  const TQ* qt = static_cast<const TQ*>(q);
  if (vec)
    scores_kernel<TQ, TK, true><<<(unsigned)blocks, kScoreWarps * 32, 0, s>>>(
        qt, k, ws, B, L, bstride, Hkv, G, D, scale, softcap);
  else
    scores_kernel<TQ, TK, false><<<(unsigned)blocks, kScoreWarps * 32, 0, s>>>(
        qt, k, ws, B, L, bstride, Hkv, G, D, scale, softcap);
  const int rows = B * Hkv * G;
  softmax_kernel<<<rows, kSoftmaxThreads, 0, s>>>(ws, L);
  const dim3 grid(rows, (D + kOutCols - 1) / kOutCols);
  output_kernel<TQ, TK><<<grid, kOutCols, 0, s>>>(ws, v, static_cast<TQ*>(out), L, bstride, Hkv,
                                                  G, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of workspace a launch over L = end - start keys needs.
long long decode_attn_wide_workspace(int B, int Hkv, int G, int L) {
  return (long long)B * Hkv * G * L;
}

// k and v are [B, s_max, Hkv, D]; the keys [start, end) are read.
// dtype: 0 = all f32, 1 = all bf16, 2 = q and out f32 over bf16 k and v.
// Any D >= 1 (the wrapper sends D > 512 here); `ws` holds at least
// decode_attn_wide_workspace(...) floats. Returns cudaGetLastError of the
// three launches.
int decode_attn_wide_launch(const void* q, const void* k, const void* v, void* out, void* ws,
                            long long ws_floats, int B, int s_max, int start, int end, int Hkv,
                            int G, int D, int dtype, float scale, float softcap, void* stream) {
  if (B < 1 || start < 0 || end <= start || end > s_max || Hkv < 1 || G < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * Hkv * G > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int L = end - start;
  if (ws_floats < decode_attn_wide_workspace(B, Hkv, G, L)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  const long long bstride = (long long)s_max * Hkv * D;  // elements a batch row
  const size_t first = (size_t)start * Hkv * D;          // key `start` of batch row 0
  using bf16 = __nv_bfloat16;
  if (dtype == 0)
    return (int)launch_t<float, float>(q, static_cast<const float*>(k) + first,
                                       static_cast<const float*>(v) + first, out, w, B, L,
                                       bstride, Hkv, G, D, scale, softcap, s);
  if (dtype == 1)
    return (int)launch_t<bf16, bf16>(q, static_cast<const bf16*>(k) + first,
                                     static_cast<const bf16*>(v) + first, out, w, B, L, bstride,
                                     Hkv, G, D, scale, softcap, s);
  if (dtype == 2)
    return (int)launch_t<float, bf16>(q, static_cast<const bf16*>(k) + first,
                                      static_cast<const bf16*>(v) + first, out, w, B, L, bstride,
                                      Hkv, G, D, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
