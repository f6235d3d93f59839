// Whole local stage of one BSP superstep, per worker.
//
// Replaces the TPU kernel `_bsp_superstep_kernel` / `bsp_superstep_pallas`
// in src/repro/kernels/bsp_superstep.py. Inputs per worker w: an edge
// stream lsrc/ldst/weight [p, E] and values val [p, n] (n = num_out).
//   MIN: Jacobi min-plus passes to the local fixpoint, at most inner_cap
//        of them. A pass gathers from the values as they were at its start
//        (prev), combines into acc seeded with prev,
//          acc[d] = min(acc[d], prev[s] + w)   for every edge with w < INF,
//        and changed = any(acc != prev). iters[w] = the number of passes
//        that changed something. Pads carry w = INF (3e38) and are masked
//        by a select, never by arithmetic.
//   SUM: one push-sum sweep, out[d] = sum over edges into d, in edge order,
//        of share[s] * w with share = val/outdeg (0 where outdeg == 0);
//        edges with w == 0 (pads) add nothing. iters[w] = 1.
//
// What bounds it on an H100: bytes. A min pass reads the edge stream
// (12 bytes an edge) and gathers one value per edge; the values of a
// worker (4 bytes x n, about 2 MB at 2^22 vertices over 32 workers) do not
// fit in shared memory, so they live in global memory and L2 serves the
// gathers. The design spreads each worker over C CTAs (as many as fit on
// the card at once, launched cooperatively so that all are resident) and
// joins them with a per-worker barrier in global memory between the
// phases of a pass; the workers run their own pass loops. Each warp reads
// 32 consecutive edges (coalesced), reduces equal destinations with a
// shuffle scan (streams are dst-sorted within each direction half), and
// commits one CAS-loop min per run; the CAS loop compares floats, so
// negative values (negated REACH labels under flat addressing, or
// combine="max") are exact. Value buffers are read through L2 (ld.cg):
// other CTAs write them. SUM gives each destination run to the thread that
// holds its first edge, which sums the run in edge order, so the result is
// the sequential sum.

#include <cuda_runtime.h>
#include <stdint.h>

#include "atomic_min.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;

struct WorkerSync {
  unsigned count;
  unsigned gen;
  int changed_pass;
  int pad;
};

// Barrier across the C CTAs of one worker (all resident: cooperative launch).
__device__ void worker_barrier(WorkerSync* ws, unsigned nctas) {
  __syncthreads();
  if (nctas > 1 && threadIdx.x == 0) {
    volatile unsigned* vgen = &ws->gen;
    const unsigned g = *vgen;
    __threadfence();
    if (atomicAdd(&ws->count, 1u) == nctas - 1) {
      atomicExch(&ws->count, 0u);
      __threadfence();
      atomicAdd(&ws->gen, 1u);
    } else {
      while (*vgen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    bsp_min_kernel(const int* __restrict__ lsrc, const int* __restrict__ ldst,
                   const float* __restrict__ weight, const float* __restrict__ val,
                   float* __restrict__ out, float* __restrict__ scratch, int* __restrict__ iters,
                   WorkerSync* __restrict__ sync, int E, int n, int inner_cap) {
  const float INF = 3.0e38f;
  const int worker = blockIdx.y;
  const int c = blockIdx.x;
  const unsigned C = gridDim.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t eoff = (size_t)worker * E;
  const int* ls = lsrc + eoff;
  const int* ld = ldst + eoff;
  const float* wt = weight + eoff;
  float* const buf0 = out + (size_t)worker * n;
  float* const buf1 = scratch + (size_t)worker * n;
  const float* v0 = val + (size_t)worker * n;
  WorkerSync* ws = sync + worker;
  __shared__ int s_changed;

  // This CTA's slices of the vertex range and of the edge stream.
  const int vchunk = (n + C - 1) / C;
  const int vbeg = min(n, (int)(c * vchunk)), vend = min(n, vbeg + vchunk);
  const int echunk = ((E + C - 1) / C + 31) & ~31;
  const int ebeg = min(E, (int)(c * echunk)), eend = min(E, ebeg + echunk);

  for (int k = vbeg + t; k < vend; k += blockDim.x) buf0[k] = v0[k];
  worker_barrier(ws, C);

  int it = 0;
  int pass = 0;
  bool changed = true;
  while (changed && it < inner_cap) {
    const float* prev = (pass & 1) ? buf1 : buf0;
    float* acc = (pass & 1) ? buf0 : buf1;
    for (int k = vbeg + t; k < vend; k += blockDim.x) acc[k] = __ldcg(prev + k);
    worker_barrier(ws, C);

    bool lowered = false;
    for (int base = ebeg + warp * 32; base < eend; base += nwarps * 32) {
      const int e = base + lane;
      const bool in = e < eend;
      int d = -1 - lane;  // distinct from every other lane's d when out of range
      float x = INF;
      if (in) {
        d = ld[e];
        const float w = wt[e];
        if (w < INF) x = __fadd_rn(__ldcg(prev + ls[e]), w);
      }
      // Segmented min over lanes that share d (runs are contiguous within
      // a direction half; combining any same-d lanes is exact for min).
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(kFull, x, off);
        const int dy = __shfl_up_sync(kFull, d, off);
        if (lane >= off && dy == d) x = fminf(x, y);
      }
      const int dn = __shfl_down_sync(kFull, d, 1);
      const bool tail = lane == 31 || dn != d;
      if (in && tail && x < INF) lowered |= atomic_min_f32(acc + d, x);
    }
    const int any = __syncthreads_or(lowered);
    if (t == 0 && any) atomicMax(&ws->changed_pass, pass + 1);
    worker_barrier(ws, C);
    if (t == 0) s_changed = atomicAdd(&ws->changed_pass, 0) == pass + 1;
    __syncthreads();
    changed = s_changed != 0;
    if (changed) ++it;
    ++pass;
  }
  if (pass & 1) {
    for (int k = vbeg + t; k < vend; k += blockDim.x) buf0[k] = __ldcg(buf1 + k);
  }
  if (c == 0 && t == 0) iters[worker] = it;
}

__global__ void __launch_bounds__(kThreads)
    bsp_sum_kernel(const int* __restrict__ lsrc, const int* __restrict__ ldst,
                   const float* __restrict__ weight, const float* __restrict__ val,
                   const float* __restrict__ out_degree, float* __restrict__ out,
                   int* __restrict__ iters, WorkerSync* __restrict__ sync, int E, int n) {
  const int worker = blockIdx.y;
  const int c = blockIdx.x;
  const unsigned C = gridDim.x;
  const int t = threadIdx.x;
  const size_t eoff = (size_t)worker * E;
  const int* ls = lsrc + eoff;
  const int* ld = ldst + eoff;
  const float* wt = weight + eoff;
  const float* v0 = val + (size_t)worker * n;
  const float* deg = out_degree + (size_t)worker * n;
  float* o = out + (size_t)worker * n;

  const int vchunk = (n + C - 1) / C;
  const int vbeg = min(n, (int)(c * vchunk)), vend = min(n, vbeg + vchunk);
  for (int k = vbeg + t; k < vend; k += blockDim.x) o[k] = 0.0f;
  worker_barrier(sync + worker, C);

  const int echunk = (E + C - 1) / C;
  const int ebeg = min(E, (int)(c * echunk)), eend = min(E, ebeg + echunk);
  for (int e = ebeg + t; e < eend; e += blockDim.x) {
    const int d = ld[e];
    if (e > 0 && ld[e - 1] == d) continue;  // not the first edge of its run
    // This thread owns the run starting at e: sum it in edge order, a few
    // edges' loads in flight at a time.
    float acc = 0.0f;
    int f = e;
    constexpr int kBatch = 8;
    while (true) {
      int dq[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) dq[q] = f + q < E ? ld[f + q] : -1;
      int cnt = 0;
#pragma unroll
      for (int q = 0; q < kBatch; ++q) cnt = (cnt == q && dq[q] == d) ? q + 1 : cnt;
      float contrib[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        contrib[q] = 0.0f;
        if (q < cnt) {
          const float w = wt[f + q];
          if (w != 0.0f) {
            const int s = ls[f + q];
            const float dg = deg[s];
            const float share = dg > 0.0f ? __fdiv_rn(v0[s], dg) : 0.0f;
            contrib[q] = __fmul_rn(share, w);
          }
        }
      }
      for (int q = 0; q < cnt; ++q) acc = __fadd_rn(acc, contrib[q]);
      f += cnt;
      if (cnt < kBatch) break;
    }
    atomicAdd(o + d, acc);  // o[d] is 0 and d has one owner: the store is exact
  }
  if (c == 0 && t == 0) iters[worker] = 1;
}

// CTAs per worker: as many as can be resident at once, and no more than
// the stream needs (one CTA per 8 edges a thread).
int ctas_per_worker(const void* kern, int p, int E, int* coop) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, 0);
  int coop_ok = 0;
  cudaDeviceGetAttribute(&coop_ok, cudaDevAttrCooperativeLaunch, dev);
  const long long resident = (long long)sms * per_sm;
  long long want = ((long long)E + kThreads * 8 - 1) / (kThreads * 8);
  if (want < 1) want = 1;
  long long cap = coop_ok ? resident / p : 1;
  if (cap < 1) cap = 1;
  const int C = (int)(want < cap ? want : cap);
  *coop = C > 1;
  return C;
}

cudaError_t launch(const void* kern, int C, int p, void** args, cudaStream_t stream, int coop) {
  const dim3 grid(C, p), block(kThreads);
  if (coop) return cudaLaunchCooperativeKernel(kern, grid, block, args, 0, stream);
  return cudaLaunchKernel(kern, grid, block, args, 0, stream);
}

}  // namespace

extern "C" {

// combine: 0 = min (fixpoint), 1 = sum (one sweep). out_degree is read by
// sum only; scratch ([p, n] f32) by min only. sync must be p zeroed
// WorkerSync records (16 bytes each). The launch returns cudaGetLastError.
int bsp_superstep_launch(const void* lsrc, const void* ldst, const void* weight, const void* val,
                         const void* out_degree, void* out, void* scratch, void* iters,
                         void* sync, int p, int E, int n, int combine, int inner_cap,
                         void* stream) {
  if (p < 1 || E < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ls = static_cast<const int*>(lsrc);
  const int* ld = static_cast<const int*>(ldst);
  const float* w = static_cast<const float*>(weight);
  const float* v = static_cast<const float*>(val);
  const float* deg = static_cast<const float*>(out_degree);
  float* o = static_cast<float*>(out);
  float* sc = static_cast<float*>(scratch);
  int* it = static_cast<int*>(iters);
  WorkerSync* ws = static_cast<WorkerSync*>(sync);
  int coop = 0;
  cudaError_t err;
  if (combine == 0) {
    const void* kern = reinterpret_cast<const void*>(bsp_min_kernel);
    const int C = ctas_per_worker(kern, p, E, &coop);
    void* args[] = {&ls, &ld, &w, &v, &o, &sc, &it, &ws, &E, &n, &inner_cap};
    err = launch(kern, C, p, args, s, coop);
  } else if (combine == 1) {
    const void* kern = reinterpret_cast<const void*>(bsp_sum_kernel);
    const int C = ctas_per_worker(kern, p, E, &coop);
    void* args[] = {&ls, &ld, &w, &v, &deg, &o, &it, &ws, &E, &n};
    err = launch(kern, C, p, args, s, coop);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
