// Membership term of the streaming vertex-cut score over a packed bitset.
//
// Replaces the TPU kernel `_ebg_membership_kernel` / `ebg_membership_pallas`
// in src/repro/kernels/ebg_score.py (oracle `ebg_membership_ref` in
// src/repro/kernels/ref.py). Inputs: keep [p, vw] 32-bit words (bit k of
// word w is vertex 32w+k; the port holds them in int32 tensors, read here
// as unsigned), u, v [E] int32. Output out [p, E] f32:
//   out[i, e] = 1[u_e not in keep_i] + 1[v_e not in keep_i]   (0, 1 or 2).
//
// What bounds it on an H100: bytes, the [p, E] f32 output (p times the
// edge ids it reads). Each thread takes four consecutive edges, reads
// their ids once (one 16-byte load each for u and v) and writes one
// 16-byte store per part row, so the writes of a warp are 512 contiguous
// bytes. The bitset gathers are random; a bitset of p=32 parts over 2^22
// vertices is 16 MB and stays in L2.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kEdges = 4;  // edges a thread

__device__ __forceinline__ float miss(const unsigned* __restrict__ row, int id) {
  return (float)(1u - ((__ldg(row + (id >> 5)) >> (id & 31)) & 1u));
}

__global__ void __launch_bounds__(kThreads)
    ebg_membership_kernel(const unsigned* __restrict__ keep, const int* __restrict__ u,
                          const int* __restrict__ v, float* __restrict__ out, int p, int vw,
                          long long E, int vec) {
  const long long e0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * kEdges;
  if (e0 >= E) return;
  if (vec && e0 + kEdges <= E) {
    const int4 uu = *reinterpret_cast<const int4*>(u + e0);
    const int4 vv = *reinterpret_cast<const int4*>(v + e0);
    for (int i = 0; i < p; ++i) {
      const unsigned* row = keep + (size_t)i * vw;
      float4 o;
      o.x = miss(row, uu.x) + miss(row, vv.x);
      o.y = miss(row, uu.y) + miss(row, vv.y);
      o.z = miss(row, uu.z) + miss(row, vv.z);
      o.w = miss(row, uu.w) + miss(row, vv.w);
      *reinterpret_cast<float4*>(out + (size_t)i * E + e0) = o;
    }
    return;
  }
  const long long e1 = e0 + kEdges < E ? e0 + kEdges : E;
  for (long long e = e0; e < e1; ++e) {
    const int a = u[e], b = v[e];
    for (int i = 0; i < p; ++i) {
      const unsigned* row = keep + (size_t)i * vw;
      out[(size_t)i * E + e] = miss(row, a) + miss(row, b);
    }
  }
}

}  // namespace

extern "C" {

// The launch returns cudaGetLastError.
int ebg_membership_launch(const void* keep, const void* u, const void* v, void* out, int p,
                          int vw, long long E, void* stream) {
  if (p < 1 || vw < 1 || E < 0) return (int)cudaErrorInvalidValue;
  if (E == 0) return (int)cudaSuccess;
  // 16-byte accesses need every row of out, and u and v, 16-byte aligned.
  const int vec = E % kEdges == 0 && reinterpret_cast<size_t>(u) % 16 == 0 &&
                  reinterpret_cast<size_t>(v) % 16 == 0 &&
                  reinterpret_cast<size_t>(out) % 16 == 0;
  const long long threads = (E + kEdges - 1) / kEdges;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ebg_membership_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(keep), static_cast<const int*>(u),
      static_cast<const int*>(v), static_cast<float*>(out), p, vw, E, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
