// One destination-sorted segmented reduction over an edge stream.
//
// Replaces the TPU kernel `_segment_reduce_kernel` / `segment_reduce_pallas`
// in src/repro/kernels/segment_reduce.py (oracles `segment_min_plus_ref`
// and `segment_sum_ref` in src/repro/kernels/ref.py). Inputs: lsrc, ldst
// [E] int32, w [E] f32, val [V] f32 (V >= n); output out [n] f32.
//   MIN: out[d] = min(val[d], min over edges into d of x_e), with
//        x_e = val[lsrc[e]] + w[e] where w[e] < INF, else INF (3e38): pads
//        carry w = INF and are masked by a select, as the reference does.
//   SUM: out[d] = sum over edges into d of x_e, with x_e = val[lsrc[e]] * w[e]
//        where w[e] != 0, else 0 (pads carry w = 0).
// MIN commits into out, seeded with val[:n]. SUM commits into acc [n] f64,
// seeded with zeros, and a second kernel rounds acc into out once.
//
// What bounds it on an H100: bytes. Each edge is 12 bytes read once, plus
// a gather of one value; the values of one worker fit in L2. Power-law
// hubs make some destination runs very long, so no run is left to one
// thread: each warp reads 32 consecutive edges (coalesced), reduces every
// run of equal destinations among them with a segmented shuffle scan, and
// the last lane of each run commits the run's partial with one atomic.
// A hub of k edges costs about k/32 atomics. The MIN commit is the CAS-loop
// float min shared with bsp_superstep.cu, exact for negative values
// (segment_max runs here through negation) and order-free, so MIN is bit
// for bit the reference's. SUM adds in another order than the reference
// (a scan tree in the warp, atomics across warps), so it adds the f32
// products in f64, scan and atomics both, and rounds once: a hub's ~10^4
// f32 atomics into one sum drift by ~1e-5 of it, and f32 partials of
// terms of both signs lose the digits of a small sum.

#include <cuda_runtime.h>

#include <type_traits>

#include "atomic_min.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr float kInf = 3.0e38f;

template <bool kMin>
__global__ void __launch_bounds__(kThreads)
    segment_reduce_kernel(const int* __restrict__ lsrc, const int* __restrict__ ldst,
                          const float* __restrict__ w, const float* __restrict__ val,
                          float* __restrict__ out, double* __restrict__ acc, long long E) {
  using Acc = std::conditional_t<kMin, float, double>;
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * (kThreads / 32);
  const long long warp = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  for (long long base = warp * 32; base < E; base += nwarps * 32) {
    const long long e = base + lane;
    const bool in = e < E;
    int d = -1 - lane;  // distinct from every other lane's d when out of range
    Acc x = kMin ? kInf : 0.0;
    if (in) {
      d = ldst[e];
      const float wt = w[e];
      if constexpr (kMin) {
        if (wt < kInf) x = __fadd_rn(__ldg(val + lsrc[e]), wt);
      } else {
        if (wt != 0.0f) x = __fmul_rn(__ldg(val + lsrc[e]), wt);
      }
    }
    // Segmented inclusive scan: lane l combines only lanes of its own run,
    // which starts at the nearest run head at or below l.
    const int dp = __shfl_up_sync(kFull, d, 1);
    const unsigned heads = __ballot_sync(kFull, lane == 0 || dp != d);
    const int start = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const Acc y = __shfl_up_sync(kFull, x, off);
      if (lane - off >= start) {
        if constexpr (kMin) {
          x = fminf(x, y);
        } else {
          x = __dadd_rn(x, y);
        }
      }
    }
    const int dn = __shfl_down_sync(kFull, d, 1);
    if (in && (lane == 31 || dn != d)) {
      if constexpr (kMin) {
        atomic_min_f32(out + d, x);
      } else if (x != 0.0) {
        atomicAdd(acc + d, x);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    round_kernel(const double* __restrict__ acc, float* __restrict__ out, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) out[i] = __double2float_rn(acc[i]);
}

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

}  // namespace

extern "C" {

// op: 0 = min (out seeded with val[:n]; acc unused), 1 = sum (acc, n
// doubles, seeded with 0 and rounded into out). The launch returns
// cudaGetLastError (or the seeding copy's error).
int segment_reduce_launch(const void* lsrc, const void* ldst, const void* w, const void* val,
                          void* out, void* acc, long long E, int n, int op, void* stream) {
  if (E < 0 || n < 1 || (op != 0 && op != 1) || (op == 1 && acc == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = op == 0 ? cudaMemcpyAsync(out, val, (size_t)n * sizeof(float),
                                              cudaMemcpyDeviceToDevice, s)
                            : cudaMemsetAsync(acc, 0, (size_t)n * sizeof(double), s);
  if (err != cudaSuccess) return (int)err;
  if (E > 0) {
    // One edge a thread, grid-strided over at most 8 resident blocks an SM.
    const long long want = (E + kThreads - 1) / kThreads;
    const long long cap = 8LL * num_sms();
    const int blocks = (int)(want < cap ? want : cap);
    const int* ls = static_cast<const int*>(lsrc);
    const int* ld = static_cast<const int*>(ldst);
    const float* wt = static_cast<const float*>(w);
    const float* v = static_cast<const float*>(val);
    float* o = static_cast<float*>(out);
    double* a = static_cast<double*>(acc);
    if (op == 0) {
      segment_reduce_kernel<true><<<blocks, kThreads, 0, s>>>(ls, ld, wt, v, o, a, E);
    } else {
      segment_reduce_kernel<false><<<blocks, kThreads, 0, s>>>(ls, ld, wt, v, o, a, E);
    }
  }
  if (op == 1) {
    round_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        static_cast<const double*>(acc), static_cast<float*>(out), n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
