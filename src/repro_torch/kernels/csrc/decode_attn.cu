// Single-token grouped-query attention over a KV cache (flash decode).
//
// Replaces the TPU kernel `_decode_attn_kernel` / `decode_attention_pallas`
// in src/repro/kernels/decode_attn.py (oracle `decode_attention_ref` in
// src/repro/kernels/ref.py). Inputs: q [B, Hq, D], k and v [B, S, Hkv, D],
// all f32 or all bf16, Hq = Hkv * G; output out [B, Hq, D] in q's type.
// Query head h*G + g attends over kv head h:
//   s_j = q . k_j * scale   (scale = 1/sqrt(D)),
//   s_j = softcap * tanh(s_j / softcap)   when softcap != 0,
//   out = sum_j softmax(s)_j v_j,   accumulated in f32.
//
// What bounds it on an H100: bytes. Every K and V row is read once and
// used for the G query rows of its kv head, about 4·G operations a byte in
// bf16, far below the card's balance point. The design: one CTA per
// (batch, kv head) and group of at most GC query rows (GC >= G for the
// shapes in use, so K and V are read once). Its warps take 32-key chunks
// of S in turn; a warp keeps its own online softmax (running max, running
// denominator, and the f32 accumulator of its GC rows, D/32 columns a
// lane) in registers. For a chunk, each key's row is read by the whole
// warp (D/32 consecutive elements a lane, coalesced) and dotted with the
// query rows, and lane j keeps key j's score; the chunk's max and sum are
// warp reductions; then the warp reads the chunk's V rows and adds p_j v_j.
// At the end the CTA merges its warps' states through shared memory.
// Built with -fmad=false (as every kernel of the port), the dot products
// are separate multiplies and adds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -3.0e38f;  // finite: exp(kNegInf - m) is 0, never NaN

// DL consecutive elements at p (aligned to DL * sizeof(T) bytes) as floats.
template <typename T, int DL>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float (&out)[DL]) {
  constexpr int kBytes = DL * (int)sizeof(T);
  if constexpr (kBytes == 2) {
    const unsigned short h = __ldg(reinterpret_cast<const unsigned short*>(p));
    out[0] = __uint_as_float((unsigned)h << 16);
  } else {
    constexpr int kWords = kBytes / 4;
    unsigned w[kWords];
    if constexpr (kWords % 4 == 0) {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(p) + i);
        w[4 * i] = x.x, w[4 * i + 1] = x.y, w[4 * i + 2] = x.z, w[4 * i + 3] = x.w;
      }
    } else if constexpr (kWords == 2) {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = x.x, w[1] = x.y;
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
    }
#pragma unroll
    for (int j = 0; j < DL; ++j) {
      if constexpr (std::is_same_v<T, float>) {
        out[j] = __uint_as_float(w[j]);
      } else {  // bf16: the upper half of an f32
        out[j] = __uint_as_float((w[j / 2] >> (16 * (j & 1))) << 16);
      }
    }
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

template <typename T, int DL, int GC>
__global__ void __launch_bounds__(kThreads)
    decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S, int Hkv, int G,
                       float scale, float softcap) {
  constexpr int D = 32 * DL;
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int g0 = blockIdx.y * GC;
  const int ng = min(GC, G - g0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // This CTA's query rows: q[b, h*G + g0 + g, :], D/32 columns a lane.
  const T* qb = q + ((size_t)b * Hkv * G + (size_t)h * G + g0) * D + lane * DL;
  float qr[GC][DL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (g < ng) {
      load_row<T, DL>(qb + (size_t)g * D, qr[g]);
    } else {
#pragma unroll
      for (int i = 0; i < DL; ++i) qr[g][i] = 0.0f;
    }
  }
  float m[GC], l[GC], acc[GC][DL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[g][i] = 0.0f;
  }

  const size_t row = (size_t)Hkv * D;  // elements from key j to key j+1
  const T* kb = k + ((size_t)b * S * Hkv + h) * D + lane * DL;
  const T* vb = v + ((size_t)b * S * Hkv + h) * D + lane * DL;
  for (int c0 = warp * 32; c0 < S; c0 += kWarps * 32) {
    const int nk = min(32, S - c0);
    // Raw dot products: lane j keeps key c0+j's.
    float s[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) s[g] = kNegInf;
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      float kr[DL];
      load_row<T, DL>(kb + (size_t)(c0 + j) * row, kr);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float part = 0.0f;
#pragma unroll
        for (int i = 0; i < DL; ++i) part = __fadd_rn(part, __fmul_rn(qr[g][i], kr[i]));
        part = warp_sum(part);
        if (lane == j) s[g] = part;
      }
    }
    // Scale and cap this lane's scores, then the chunk's online softmax.
    float pj[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (lane < nk) {
        s[g] = __fmul_rn(s[g], scale);
        if (softcap != 0.0f) s[g] = __fmul_rn(softcap, tanhf(__fdiv_rn(s[g], softcap)));
      }
      const float m_new = fmaxf(m[g], warp_max(s[g]));
      const float alpha = expf(m[g] - m_new);
      pj[g] = expf(s[g] - m_new);
      l[g] = __fadd_rn(__fmul_rn(l[g], alpha), warp_sum(pj[g]));
      m[g] = m_new;
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[g][i] = __fmul_rn(acc[g][i], alpha);
    }
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      float vr[DL];
      load_row<T, DL>(vb + (size_t)(c0 + j) * row, vr);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float p = __shfl_sync(kFull, pj[g], j);
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[g][i] = __fadd_rn(acc[g][i], __fmul_rn(p, vr[i]));
      }
    }
  }

  // Merge the warps' states.
  __shared__ float sm_m[kWarps][GC];
  __shared__ float sm_l[kWarps][GC];
  __shared__ float sm_acc[kWarps][GC][D];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < DL; ++i) sm_acc[warp][g][lane * DL + i] = acc[g][i];
  }
  __syncthreads();
  T* ob = out + ((size_t)b * Hkv * G + (size_t)h * G + g0) * D;
  for (int idx = threadIdx.x; idx < ng * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float den = 0.0f, num = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][g] - mx);
      den = __fadd_rn(den, __fmul_rn(sm_l[w][g], f));
      num = __fadd_rn(num, __fmul_rn(sm_acc[w][g][d], f));
    }
    ob[(size_t)g * D + d] = from_f32<T>(__fdiv_rn(num, den));
  }
}

template <typename T, int DL, int GC>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int S,
                   int Hkv, int G, float scale, float softcap, cudaStream_t stream) {
  const dim3 grid(B * Hkv, (G + GC - 1) / GC);
  decode_attn_kernel<T, DL, GC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, Hkv, G, scale, softcap);
  return cudaGetLastError();
}

// Query rows a CTA: the least power of two >= G, at most 16 / DL (and 8),
// which keeps q and the accumulator at <= 32 registers a thread each.
template <typename T, int DL>
cudaError_t launch_dl(const void* q, const void* k, const void* v, void* out, int B, int S,
                      int Hkv, int G, float scale, float softcap, cudaStream_t stream) {
  constexpr int kMaxGC = 16 / DL < 8 ? 16 / DL : 8;
  if (G <= 1) return launch<T, DL, 1>(q, k, v, out, B, S, Hkv, G, scale, softcap, stream);
  if (G <= 2 || kMaxGC == 2)
    return launch<T, DL, 2>(q, k, v, out, B, S, Hkv, G, scale, softcap, stream);
  if constexpr (kMaxGC >= 4) {
    if (G <= 4 || kMaxGC == 4)
      return launch<T, DL, 4>(q, k, v, out, B, S, Hkv, G, scale, softcap, stream);
  }
  if constexpr (kMaxGC >= 8) {
    return launch<T, DL, 8>(q, k, v, out, B, S, Hkv, G, scale, softcap, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* out, int B, int S,
                     int Hkv, int G, int D, float scale, float softcap, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_dl<T, 1>(q, k, v, out, B, S, Hkv, G, scale, softcap, stream);
    case 64: return launch_dl<T, 2>(q, k, v, out, B, S, Hkv, G, scale, softcap, stream);
    case 128: return launch_dl<T, 4>(q, k, v, out, B, S, Hkv, G, scale, softcap, stream);
    case 256: return launch_dl<T, 8>(q, k, v, out, B, S, Hkv, G, scale, softcap, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16. D must be 32, 64, 128 or 256. The launch
// returns cudaGetLastError.
int decode_attn_launch(const void* q, const void* k, const void* v, void* out, int B, int S,
                       int Hkv, int G, int D, int dtype, float scale, float softcap,
                       void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || G < 1) return (int)cudaErrorInvalidValue;
  if ((long long)B * Hkv > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_t<float>(q, k, v, out, B, S, Hkv, G, D, scale, softcap, s);
  if (dtype == 1)
    return (int)launch_t<__nv_bfloat16>(q, k, v, out, B, S, Hkv, G, D, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
