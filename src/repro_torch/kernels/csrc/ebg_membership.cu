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
// edge ids it reads). A part-major gather (one 4-byte word of keep[i] a
// part and endpoint) costs a 32-byte L2 sector for every 4 bytes written:
// at p = 32 that is 16 times the output's bytes in L2 traffic. So the call
// first turns keep into its vertex-major transpose memb [32·vw, W], W =
// ⌈p/32⌉ (memb_transpose.cuh, shared with ebg_commit.cu): one word holds
// a vertex's membership in 32 parts. Then each thread takes kEdges
// consecutive edges, reads their ids with 16-byte loads from u and v,
// gathers 2·W words an edge (16 MB of memb at 2^22 vertices and p = 32
// stays in L2), and writes every part row from registers, one 16-byte
// store a row for each 4 edges, with the streaming hint (st.global.cs) so
// that the output does not push memb out of L2: a warp's store to a row is
// 512 contiguous bytes. (More edges a thread spread a warp's store over
// more bytes and measured slower, as did plain stores:
// scripts/probe_ebg_membership.py.) Parts are taken 32 at a time (one word
// an endpoint), so any p runs; an E that is not a multiple of 4, or u, v
// or out off 16 bytes, take a scalar path, as do a thread's edges that run
// past E.
//
// Id guard: an id outside [0, 32·vw) reads nothing (it counts as absent
// from every part) and ORs bit 0 (u) or bit 1 (v) into a device word
// `err`, which a one-thread kernel after the main one copies to pinned
// host memory (host_flag.cuh); the launch entry waits for it, and the
// wrapper raises. The caller zeroes err.

#include <cuda_runtime.h>
#include <stdint.h>

#include "host_flag.cuh"
#include "memb_transpose.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kEdges = 4;  // edges a thread, a multiple of 4

// memb word w of vertex id, or 0 (and a bit of `bad`) for an id outside
// [0, n).
__device__ __forceinline__ uint32_t memb_word(const uint32_t* __restrict__ memb, int id, int W,
                                              int w, unsigned n, unsigned bit, unsigned& bad) {
  if ((unsigned)id >= n) {
    bad |= bit;
    return 0u;
  }
  return __ldg(memb + (size_t)id * W + w);
}

// 2 - (bit b of mu) - (bit b of mv): the endpoints absent from part b.
__device__ __forceinline__ float absent(uint32_t mu, uint32_t mv, int b) {
  return (float)(2u - ((mu >> b) & 1u) - ((mv >> b) & 1u));
}

// A store that does not stay in L2 ahead of memb (st.global.cs).
__device__ __forceinline__ void store_out(float4* p, float4 x) { __stcs(p, x); }
__device__ __forceinline__ void store_out(float* p, float x) { __stcs(p, x); }

__global__ void __launch_bounds__(kThreads)
    ebg_membership_kernel(const uint32_t* __restrict__ memb, const int* __restrict__ u,
                          const int* __restrict__ v, float* __restrict__ out, int p, int vw,
                          long long E, int vec, unsigned* __restrict__ err) {
  const long long e0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * kEdges;
  const int W = (p + 31) / 32;
  const unsigned n = 32u * (unsigned)vw;
  unsigned bad = 0;
  if (e0 < E && vec && e0 + kEdges <= E) {
    int a[kEdges], c[kEdges];
#pragma unroll
    for (int k = 0; k < kEdges; k += 4) {
      const int4 uu = *reinterpret_cast<const int4*>(u + e0 + k);
      const int4 vv = *reinterpret_cast<const int4*>(v + e0 + k);
      a[k] = uu.x, a[k + 1] = uu.y, a[k + 2] = uu.z, a[k + 3] = uu.w;
      c[k] = vv.x, c[k + 1] = vv.y, c[k + 2] = vv.z, c[k + 3] = vv.w;
    }
    for (int w = 0; w < W; ++w) {
      uint32_t mu[kEdges], mv[kEdges];
#pragma unroll
      for (int k = 0; k < kEdges; ++k) {
        mu[k] = memb_word(memb, a[k], W, w, n, 1u, bad);
        mv[k] = memb_word(memb, c[k], W, w, n, 2u, bad);
      }
      const int nb = p - 32 * w < 32 ? p - 32 * w : 32;
      float* row = out + (size_t)(32 * w) * E + e0;
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        if (b >= nb) break;
#pragma unroll
        for (int k = 0; k < kEdges; k += 4) {
          const float4 o = make_float4(absent(mu[k], mv[k], b), absent(mu[k + 1], mv[k + 1], b),
                                       absent(mu[k + 2], mv[k + 2], b),
                                       absent(mu[k + 3], mv[k + 3], b));
          store_out(reinterpret_cast<float4*>(row + (size_t)b * E + k), o);
        }
      }
    }
  } else if (e0 < E) {
    const long long e1 = e0 + kEdges < E ? e0 + kEdges : E;
    for (long long e = e0; e < e1; ++e) {
      const int a = u[e], c = v[e];
      for (int w = 0; w < W; ++w) {
        const uint32_t mu = memb_word(memb, a, W, w, n, 1u, bad);
        const uint32_t mv = memb_word(memb, c, W, w, n, 2u, bad);
        const int nb = p - 32 * w < 32 ? p - 32 * w : 32;
        for (int b = 0; b < nb; ++b)
          store_out(out + (size_t)(32 * w + b) * E + e, absent(mu, mv, b));
      }
    }
  }
  bad = __reduce_or_sync(kFull, bad);
  if (bad && (threadIdx.x & 31) == 0) atomicOr(err, bad);
}

// The id guard's bits, once the main kernel is done, to the host flag.
__global__ void publish_kernel(const unsigned* __restrict__ err, unsigned* __restrict__ flag) {
  *flag = __ldcg(err);
}

}  // namespace

extern "C" {

// 4 bytes of pinned host memory that the kernels can write (mapped): the
// host pointer into *host, the device's pointer to it into *dev.
int ebg_membership_host_flag(void** host, void** dev) { return (int)hostflag::alloc(host, dev); }

// keep [p, vw] -> memb [32·vw, ⌈p/32⌉], the layout the main kernel reads.
// Returns cudaGetLastError.
int ebg_membership_memb(const void* keep, void* memb, int p, int vw, void* stream) {
  return (int)membt::launch_transpose(static_cast<const uint32_t*>(keep),
                                      static_cast<uint32_t*>(memb), p, vw, true,
                                      static_cast<cudaStream_t>(stream));
}

// out [p, E] from memb [32·vw, ⌈p/32⌉] and u, v [E]. err: a zeroed 4-byte
// device word the id guard ORs into. Given a host flag (from
// ebg_membership_host_flag: flag_host, and flag_dev the device's pointer
// to it), a second launch copies err there after the main kernel, and the
// call waits until it has: the bits are then in *flag_host. Without one,
// nothing waits. Returns the launch's error, or the stream's if it fails
// before the flag comes.
int ebg_membership_launch(const void* memb, const void* u, const void* v, void* out, void* err,
                          void* flag_host, void* flag_dev, int p, int vw, long long E,
                          void* stream) {
  if (p < 1 || vw < 1 || E < 1 || err == nullptr ||
      (flag_host == nullptr) != (flag_dev == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte accesses need every row of out, and u and v, 16-byte aligned
  // (a thread whose edges run past E takes the scalar path).
  const int vec = E % 4 == 0 && reinterpret_cast<size_t>(u) % 16 == 0 &&
                  reinterpret_cast<size_t>(v) % 16 == 0 &&
                  reinterpret_cast<size_t>(out) % 16 == 0;
  const long long threads = (E + kEdges - 1) / kEdges;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  volatile unsigned* fh = static_cast<volatile unsigned*>(flag_host);
  if (fh != nullptr) *fh = hostflag::kPending;
  ebg_membership_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(memb), static_cast<const int*>(u), static_cast<const int*>(v),
      static_cast<float*>(out), p, vw, E, vec, static_cast<unsigned*>(err));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || fh == nullptr) return (int)e;
  publish_kernel<<<1, 1, 0, s>>>(static_cast<const unsigned*>(err),
                                 static_cast<unsigned*>(flag_dev));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return hostflag::wait(fh, s);
}

}  // extern "C"
