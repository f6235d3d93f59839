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
// seeded with zeros, and rounds acc into out once. Both guard their ids:
// an edge with lsrc outside [0, V) or ldst outside [0, n) reads and
// commits nothing and sets bit 0 (lsrc) or bit 1 (ldst) of a 4-byte device
// flag, which the kernel copies to pinned host memory once it is final.
// Each is one cooperative launch (seed; edges; flag and round, between
// grid barriers), so a call costs the host one launch and a wait for the
// flag, not for the stream.
//
// What bounds it on an H100: bytes. Each edge is 12 bytes read once, plus
// a gather of one value; the values of one worker fit in L2. Power-law
// hubs make some destination runs very long, so no run is left to one
// thread. MIN: each warp reads 32 consecutive edges (coalesced), reduces
// every run of equal destinations among them with a segmented shuffle
// scan, and the last lane of each run commits the run's partial with a
// CAS-loop float min (exact for negative values, as segment_max needs,
// and order-free: bit for bit the reference's). SUM is the segmented sum of segmented_sum.cuh (4 edges a
// thread in 16-byte loads, a CTA-wide scan, one f64 atomic per run per
// 1024-edge tile); it adds in another order than the reference, so it adds
// the f32 products in f64 and rounds once: a hub's ~10^4 f32 atomics into
// one sum drift by ~1e-5 of it, and f32 partials of terms of both signs
// lose the digits of a small sum.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "host_flag.cuh"
#include "segmented_sum.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr float kInf = 3.0e38f;

// *addr = min(*addr, x) as one atomic step. The CAS loop compares floats,
// so it is exact for negative values too (negated labels under
// segment_max), where an integer atomicMin on the bit patterns would not
// be. *addr is read through L2 (other CTAs write it).
__device__ __forceinline__ void atomic_min_f32(float* addr, float x) {
  unsigned* a = reinterpret_cast<unsigned*>(addr);
  unsigned old = __float_as_uint(__ldcg(addr));
  while (x < __uint_as_float(old)) {
    const unsigned assumed = old;
    old = atomicCAS(a, assumed, __float_as_uint(x));
    if (old == assumed) return;
  }
}

// MIN, one cooperative launch: out = val[:n] and the flag zeroed; a grid
// barrier; the edges, one a thread, grid-strided; a grid barrier; the flag
// to the host.
__global__ void __launch_bounds__(kThreads)
    segment_min_kernel(const int* __restrict__ lsrc, const int* __restrict__ ldst,
                       const float* __restrict__ w, const float* __restrict__ val,
                       float* __restrict__ out, long long E, int V, int n,
                       unsigned* __restrict__ err, unsigned* __restrict__ flag_host) {
  cg::grid_group grid = cg::this_grid();
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * kThreads;
  for (long long i = tid; i < n; i += nthreads) out[i] = val[i];
  if (tid == 0) *err = 0;
  grid.sync();
  const int lane = threadIdx.x & 31;
  for (long long base = tid - lane; base < E; base += nthreads) {
    const long long e = base + lane;
    bool in = e < E;
    int d = -1 - lane;  // distinct from every other lane's d when out of range
    float x = kInf;
    unsigned bad = 0;
    if (in) {
      const int s = lsrc[e], dd = ldst[e];
      bad = segsum::id_error(s, dd, V, n);
      in = !(bad & segsum::kBadDst);
      if (in) d = dd;
      const float wt = w[e];
      if (!(bad & segsum::kBadSrc) && wt < kInf) x = __fadd_rn(__ldg(val + s), wt);
    }
    bad = __reduce_or_sync(kFull, bad);
    if (bad && lane == 0) atomicOr(err, bad);
    // Segmented inclusive scan: lane l combines only lanes of its own run,
    // which starts at the nearest run head at or below l.
    const int dp = __shfl_up_sync(kFull, d, 1);
    const unsigned heads = __ballot_sync(kFull, lane == 0 || dp != d);
    const int start = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(kFull, x, off);
      if (lane - off >= start) x = fminf(x, y);
    }
    const int dn = __shfl_down_sync(kFull, d, 1);
    if (in && (lane == 31 || dn != d)) atomic_min_f32(out + d, x);
  }
  grid.sync();
  if (tid == 0 && flag_host != nullptr) *flag_host = __ldcg(err);  // through L2: other CTAs set it
}

// SUM, one cooperative launch: the f64 accumulator and the flag zeroed; a
// grid barrier; the segmented sum of segmented_sum.cuh, the grid walking
// the tiles; a grid barrier; the flag to the host, and the accumulator
// rounded into out once.
__global__ void __launch_bounds__(segsum::kThreads, 4)
    segment_sum_kernel(const int* __restrict__ lsrc, const int* __restrict__ ldst,
                       const float* __restrict__ w, const float* __restrict__ val,
                       double* __restrict__ acc, float* __restrict__ out, long long E, int V,
                       int n, int vec, unsigned* __restrict__ err,
                       unsigned* __restrict__ flag_host) {
  cg::grid_group grid = cg::this_grid();
  const long long tid = (long long)blockIdx.x * segsum::kThreads + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * segsum::kThreads;
  for (long long i = tid; i < n; i += nthreads) acc[i] = 0.0;
  if (tid == 0) *err = 0;
  grid.sync();
  // The stream may be in any order of destinations: every run goes into
  // the accumulator by an f64 atomic.
  segsum::for_tiles(lsrc, ldst, w, 1, E, vec != 0,
                    [&](const segsum::Edges& edges, long long, long long, long long e0) {
                      segsum::tile_sum<true>(edges, val, E, e0, V, n, err,
                                             [&](int d, double v, int, int) {
                                               if (v != 0.0) atomicAdd(acc + d, v);
                                             });
                    });
  grid.sync();
  // Read through L2: other CTAs' atomics wrote err and acc. The flag is
  // final here: the host may go on while the grid rounds.
  if (tid == 0 && flag_host != nullptr) *flag_host = __ldcg(err);
  for (long long i = tid; i < n; i += nthreads) out[i] = __double2float_rn(__ldcg(acc + i));
}

}  // namespace

extern "C" {

// 4 bytes of pinned host memory that the kernels can write (mapped): the
// host pointer into *host, the device's pointer to it into *dev.
int segment_reduce_host_flag(void** host, void** dev) { return (int)hostflag::alloc(host, dev); }

// op: 0 = min (out seeded with val[:n]), 1 = sum (accumulated in f64 and
// rounded into out). ws is the device workspace, 8-byte aligned: min, 8
// bytes (the error flag); sum, 8 * (n + 1) bytes (the accumulator, then
// the flag). One cooperative launch does it all. Given a host flag (from
// segment_reduce_host_flag: flag_host, and flag_dev the device's pointer
// to it), the kernel writes its error bits there once they are final,
// and the call waits until it has: the bits are then in *flag_host, and
// the rest of the kernel (the sum's rounding) runs on behind the return,
// in stream order like any launch. Without one, nothing waits. Returns
// the launch's error, or the stream's if it fails before the flag comes.
int segment_reduce_launch(const void* lsrc, const void* ldst, const void* w, const void* val,
                          void* out, void* ws, void* flag_host, void* flag_dev, long long E,
                          int V, int n, int op, void* stream) {
  if (E < 0 || n < 1 || V < n || (op != 0 && op != 1) || ws == nullptr ||
      (flag_host == nullptr) != (flag_dev == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ls = static_cast<const int*>(lsrc);
  const int* ld = static_cast<const int*>(ldst);
  const float* wt = static_cast<const float*>(w);
  const float* v = static_cast<const float*>(val);
  float* o = static_cast<float*>(out);
  double* acc = static_cast<double*>(ws);
  unsigned* err = reinterpret_cast<unsigned*>(acc + (op == 1 ? n : 0));
  unsigned* fd = static_cast<unsigned*>(flag_dev);
  volatile unsigned* fh = static_cast<volatile unsigned*>(flag_host);
  if (fh != nullptr) *fh = hostflag::kPending;
  // The grid: at most the resident CTAs (a cooperative launch), enough for
  // one edge (min) or one tile (sum) a thread or CTA, and one output a thread.
  const long long outs = (n + kThreads - 1) / kThreads;
  cudaError_t e;
  if (op == 0) {
    static const long long resident =
        segsum::resident_ctas(reinterpret_cast<const void*>(segment_min_kernel));
    const long long want = (E + kThreads - 1) / kThreads;
    const int blocks = segsum::persistent_grid(resident, want > outs ? want : outs);
    void* args[] = {&ls, &ld, &wt, &v, &o, &E, &V, &n, &err, &fd};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(segment_min_kernel), blocks,
                                    kThreads, args, 0, s);
  } else {
    static const long long resident =
        segsum::resident_ctas(reinterpret_cast<const void*>(segment_sum_kernel));
    const long long tiles = (E + segsum::kTile - 1) / segsum::kTile;
    const int blocks = segsum::persistent_grid(resident, tiles > outs ? tiles : outs);
    int vec = segsum::aligned16(ls) && segsum::aligned16(ld) && segsum::aligned16(wt);
    void* args[] = {&ls, &ld, &wt, &v, &acc, &o, &E, &V, &n, &vec, &err, &fd};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(segment_sum_kernel), blocks,
                                    segsum::kThreads, args, 0, s);
  }
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess || fh == nullptr) return (int)e;
  return hostflag::wait(fh, s);
}

}  // extern "C"
