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
//   SUM: one push-sum sweep, out[d] = sum over edges into d of share[s] * w
//        with share = val/outdeg (0 where outdeg == 0); edges with w == 0
//        (pads) add nothing. The f32 products are added in f64 and the sum
//        rounded to f32 once. Each worker's stream must be dst-sorted.
//        iters[w] = 1.
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
// other CTAs write them.
//
// SUM is three ordinary launches, no barrier: a pass that divides once a
// vertex (share = val/outdeg, in place of a division and a second gather
// an edge); the segmented sum of segmented_sum.cuh over every worker's
// edge tiles (a persistent grid), which zeroes out tile by tile, stores
// each run that lies inside a tile, rounded once, and leaves each tile's
// first and last run in two carry slots; and a pass that adds up the runs
// that cross tiles. The stream being dst-sorted (the reference requires it), a
// destination is one run, so no atomic is needed, and no f64 accumulator
// of [p, n] is zeroed, updated and rounded.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "atomic_min.cuh"
#include "segmented_sum.cuh"

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

// SUM, first pass: share = val / outdeg once a vertex (0 where outdeg is
// 0; the same IEEE division the plain version takes), and iters = 1. Four
// elements a thread, in 16-byte accesses where the buffers allow.
__device__ __forceinline__ float share_of(float v, float dg) {
  return dg > 0.0f ? __fdiv_rn(v, dg) : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
    bsp_share_kernel(const float* __restrict__ val, const float* __restrict__ out_degree,
                     float* __restrict__ share, int* __restrict__ iters, long long total, int p,
                     int vec) {
  const long long i0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (i0 < p) {
    for (long long i = i0; i < i0 + 4 && i < p; ++i) iters[i] = 1;
  }
  if (vec && i0 + 4 <= total) {
    const float4 v = *reinterpret_cast<const float4*>(val + i0);
    const float4 dg = *reinterpret_cast<const float4*>(out_degree + i0);
    *reinterpret_cast<float4*>(share + i0) = make_float4(
        share_of(v.x, dg.x), share_of(v.y, dg.y), share_of(v.z, dg.z), share_of(v.w, dg.w));
    return;
  }
  for (long long i = i0; i < i0 + 4 && i < total; ++i) share[i] = share_of(val[i], out_degree[i]);
}

// SUM, second pass: the workers' dst-sorted streams, tile by tile (a
// persistent grid). A destination's edges are one run of its worker's
// row, so a run that starts and ends inside a tile is the whole sum: it is
// rounded and stored. The tile's first and last runs may go on in the
// tiles beside it: they go to the tile's two carry slots (2j, 2j + 1;
// destination -1 when empty) for the last pass. Each tile first zeroes
// its part of out, the destinations after the previous tile's last edge's
// up to its own last edge's (the row's first tile from 0, its last to
// n - 1): whole sectors, written before the tile's stores of its sums.
__global__ void __launch_bounds__(segsum::kThreads)
    bsp_sum_kernel(const int* __restrict__ lsrc, const int* __restrict__ ldst,
                   const float* __restrict__ weight, const float* __restrict__ share,
                   float* __restrict__ out, int* __restrict__ carry_d,
                   double* __restrict__ carry_v, int p, int E, int n, int vec) {
  segsum::for_tiles(
      lsrc, ldst, weight, p, E, vec != 0,
      [&](const segsum::Edges& edges, long long r, long long j, long long e0) {
        int* const cd = carry_d + 2 * j;
        double* const cv = carry_v + 2 * j;
        float* const o = out + r * n;
        const int* const ld = ldst + r * E;
        const long long begin = e0 - (long long)threadIdx.x * segsum::kEdges;
        const long long end = begin + segsum::kTile;
        const int lo = begin == 0 ? 0 : __ldg(ld + begin - 1) + 1;
        const int hi = end >= E ? n - 1 : __ldg(ld + end - 1);
        for (int x = lo + threadIdx.x; x <= hi; x += segsum::kThreads) o[x] = 0.0f;
        if (threadIdx.x == 0) cd[0] = cd[1] = -1;
        // tile_sum's barriers order the stores above before its sums'.
        segsum::tile_sum<false>(edges, share + r * n, E, e0, 0, 0, nullptr,
                                [&](int d, double v, int first, int last) {
                                  if (d == first) {
                                    cd[0] = d, cv[0] = v;
                                  } else if (d == last) {
                                    cd[1] = d, cv[1] = v;
                                  } else if (v != 0.0) {
                                    o[d] = __double2float_rn(v);
                                  }
                                });
      });
}

// SUM, last pass: the runs that cross tiles. Each row's carry slots are in
// stream order, so a destination's partials are consecutive slots (empty
// slots, only ever odd ones, between them). The slot that holds a
// destination's first partial adds them all in f64 and rounds once,
// reading kBatch slots at a time (a hub's run crosses many tiles).
__global__ void __launch_bounds__(kThreads)
    bsp_carry_kernel(const int* __restrict__ carry_d, const double* __restrict__ carry_v,
                     float* __restrict__ out, int p, long long slots, int n) {
  constexpr int kBatch = 8;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= p * slots) return;
  const int d = carry_d[i];
  if (d < 0) return;
  const long long r = i / slots, k0 = i - r * slots;
  const int* const cd = carry_d + r * slots;
  const double* const cv = carry_v + r * slots;
  long long k = k0 - 1;
  if (k >= 0 && cd[k] < 0) --k;
  if (k >= 0 && cd[k] == d) return;  // not the destination's first partial
  double sum = 0.0;
  bool more = true;
  for (k = k0; more && k < slots; k += kBatch) {
    int dk[kBatch];
    double vk[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      dk[q] = k + q < slots ? cd[k + q] : INT_MAX;
      vk[q] = dk[q] == d ? cv[k + q] : 0.0;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      more = more && (dk[q] == d || dk[q] < 0);
      if (more) sum += vk[q];
    }
  }
  if (sum != 0.0) out[r * n + d] = __double2float_rn(sum);
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

// Bytes of the scratch buffer bsp_superstep_launch needs.
long long bsp_superstep_scratch_bytes(int p, int E, int n, int combine) {
  if (combine == 0) return 4LL * p * n;
  const long long slots = 2 * (((long long)E + segsum::kTile - 1) / segsum::kTile);
  return 12LL * p * slots + 4LL * p * n;
}

// combine: 0 = min (fixpoint), 1 = sum (one sweep; each worker's stream
// dst-sorted). out_degree is read by sum only. scratch: 8-byte aligned,
// bsp_superstep_scratch_bytes(p, E, n, combine) of it (min: [p, n] f32;
// sum: the carry sums, the shares, the carry destinations). sync (min
// only) must be p zeroed WorkerSync records (16 bytes each). The launch
// returns cudaGetLastError.
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
  int* it = static_cast<int*>(iters);
  WorkerSync* ws = static_cast<WorkerSync*>(sync);
  int coop = 0;
  cudaError_t err;
  if (combine == 0) {
    const void* kern = reinterpret_cast<const void*>(bsp_min_kernel);
    const int C = ctas_per_worker(kern, p, E, &coop);
    float* sc = static_cast<float*>(scratch);
    void* args[] = {&ls, &ld, &w, &v, &o, &sc, &it, &ws, &E, &n, &inner_cap};
    err = launch(kern, C, p, args, s, coop);
  } else if (combine == 1) {
    double* carry_v = static_cast<double*>(scratch);
    const long long slots = 2 * ((E + segsum::kTile - 1) / segsum::kTile);
    float* share = reinterpret_cast<float*>(carry_v + p * slots);
    int* carry_d = reinterpret_cast<int*>(share + (size_t)p * n);
    const long long total = (long long)p * n;
    const int vec = E % segsum::kEdges == 0 && segsum::aligned16(ls) &&
                    segsum::aligned16(ld) && segsum::aligned16(w);
    const int vec4 = segsum::aligned16(v) && segsum::aligned16(deg) && segsum::aligned16(share);
    bsp_share_kernel<<<(total + 4 * kThreads - 1) / (4 * kThreads), kThreads, 0, s>>>(
        v, deg, share, it, total, p, vec4);
    static const long long resident =
        segsum::resident_ctas(reinterpret_cast<const void*>(bsp_sum_kernel));
    const int grid = segsum::persistent_grid(resident, p * slots / 2);
    bsp_sum_kernel<<<grid, segsum::kThreads, 0, s>>>(ls, ld, w, share, o, carry_d, carry_v, p, E,
                                                     n, vec);
    bsp_carry_kernel<<<(p * slots + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        carry_d, carry_v, o, p, slots, n);
    err = cudaGetLastError();
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
