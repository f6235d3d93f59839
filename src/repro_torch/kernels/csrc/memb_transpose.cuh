// The membership bitset's two layouts and the kernel that converts them.
//
// keep[p, vw] is part-major (bit k of word c: vertex 32c+k is in part r);
// memb[32·vw, W], W = ⌈p/32⌉, is vertex-major (bit i of word w: part 32w+i
// holds the vertex), so an endpoint's parts are W consecutive words.
// ebg_commit.cu and ebg_membership.cu both work on memb and include this
// header for the conversion. keep -> memb writes every memb word (parts
// >= p read 0); memb -> keep overwrites whole rows of keep and writes no
// row >= p.
//
// What bounds it on an H100: bytes. Each word is read once and written
// once (33.5 MB at the full width's keep [32, 131,072], 10 µs at 3.35
// TB/s). The design keeps both sides of the copy coalesced:
//   * A CTA takes a tile of WT memb words (32·WT part rows) × T vertex
//     words: 256 32x32 bit blocks, T = 256 / WT, WT = W up to 2, then 4 or
//     8. The grid is ⌈vw/T⌉ × ⌈W/WT⌉ CTAs (512 at the full width), the
//     memb words of one vertex tile next to each other in launch order.
//   * Both sides go through 32 KB of shared memory, with 16-byte loads and
//     stores where the rows allow: keep rows when vw % 4 == 0, memb when
//     the tile spans all of W (its rows are then one contiguous run).
//   * The tiles are swizzled, not padded, so that the 16-byte accesses stay
//     whole: word c of keep row r sits at column c ^ (r mod 32), word w of
//     memb row x at w ^ (x mod 32)·WT/32. A warp reading one 32x32 block
//     of either, a word a lane, then meets 32 banks; a 16-byte access
//     lands on one 16-byte unit, its four words in an XOR order.
//   * A block is transposed in registers by the five-round butterfly: at
//     distance j = 16, 8, 4, 2, 1 a lane trades with lane ^ j the j-bit
//     halves of each 2j-bit group that the other one needs (masks
//     0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333, 0x55555555): one
//     shuffle, two shifts and a select a round, where ballots took 32 a word.
//   * Ragged edges are masked: words past vw, parts >= p, memb words >= W.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace membt {

constexpr int kThreads = 256;
constexpr int kBlocks = 256;              // 32x32 bit blocks a CTA
constexpr int kWords = 32 * kBlocks;      // words a tile
constexpr int kPerThread = kWords / kThreads;  // a tile's words a thread moves
constexpr int kPerWarp = kBlocks / (kThreads / 32);  // blocks a warp transposes

// The memb tile's swizzle of row x (WT words a row).
template <int WT>
__device__ __forceinline__ int swz(int x) {
  return (x & 31) / (32 / WT);
}

// The 32x32 bit matrix whose row i is lane i's word, transposed: lane x
// gets the word whose bit i is bit x of lane i's. Round mask m keeps the
// low j bits of each 2j-bit group: 0xFFFFFFFF / (2^j + 1).
__device__ __forceinline__ uint32_t transpose32(uint32_t a, int lane) {
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const uint32_t m = 0xFFFFFFFFu / ((1u << j) + 1u);
    const uint32_t b = __shfl_xor_sync(0xffffffffu, a, j);
    a = (lane & j) ? (a & ~m) | ((b >> j) & m) : (a & m) | ((b << j) & ~m);
  }
  return a;
}

// A 16-byte unit of shared memory whose word i holds x's word i ^ q.
__device__ __forceinline__ void store_xor(uint32_t* unit, uint4 x, int q) {
  if (q & 1) x = make_uint4(x.y, x.x, x.w, x.z);
  if (q & 2) x = make_uint4(x.z, x.w, x.x, x.y);
  *reinterpret_cast<uint4*>(unit) = x;
}

// The inverse: word i of the result is word i ^ q of the unit.
__device__ __forceinline__ uint4 load_xor(const uint32_t* unit, int q) {
  uint4 x = *reinterpret_cast<const uint4*>(unit);
  if (q & 1) x = make_uint4(x.y, x.x, x.w, x.z);
  if (q & 2) x = make_uint4(x.z, x.w, x.x, x.y);
  return x;
}

// One tile. vec_keep: keep rows are whole 16-byte chunks (vw % 4 == 0, an
// aligned pointer); vec_memb: the memb pointer is 16-byte aligned.
template <int WT, bool TO_MEMB>
__global__ void __launch_bounds__(kThreads)
    transpose_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst, int p,
                     int vw, int W, int nwb, int vec_keep, int vec_memb) {
  constexpr int T = kBlocks / WT;  // vertex words a tile
  __shared__ __align__(16) uint32_t s[kWords];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int w0 = (int)(blockIdx.x % nwb) * WT;
  const int c0 = (int)(blockIdx.x / nwb) * T;
  const int ncols = min(T, vw - c0);  // vertex words of the tile
  const int nw = min(WT, W - w0);     // memb words of the tile
  const int prows = p - 32 * w0;      // part rows of the tile below p (may pass 32·WT)
  uint32_t* const keep =  // part row 32·w0, vertex word c0
      const_cast<uint32_t*>(TO_MEMB ? src : dst) + (size_t)32 * w0 * vw + c0;
  uint32_t* const memb = const_cast<uint32_t*>(TO_MEMB ? dst : src);
  // The tile's memb rows are one contiguous run when it spans all of W.
  const bool mvec = WT == W && vec_memb && ncols == T;
  const bool kvec = vec_keep && ncols == T;

  // Keep tile (part row r, vertex word c) <-> global, 16 bytes a thread.
  auto keep_vec = [&](auto&& move) {
#pragma unroll
    for (int i = 0; i < kPerThread / 4; ++i) {
      const int e4 = t + i * kThreads, r = e4 / (T / 4), c = 4 * (e4 % (T / 4));
      move(r, c, s + r * T + (c ^ (r & 28)), r & 3);
    }
  };
  // Memb tile (4 consecutive words of its flat order) <-> global.
  auto memb_vec = [&](auto&& move) {
    uint4* g = reinterpret_cast<uint4*>(memb + (size_t)32 * c0 * WT);
#pragma unroll
    for (int i = 0; i < kPerThread / 4; ++i) {
      const int e4 = t + i * kThreads, sw = swz<WT>(4 * e4 / WT);
      move(g + e4, s + ((4 * e4) ^ (sw & ~3)), sw & 3);
    }
  };

  // 1. The source tile into shared memory.
  if (TO_MEMB) {
    if (kvec) {
      keep_vec([&](int r, int c, uint32_t* unit, int q) {
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (r < prows) x = *reinterpret_cast<const uint4*>(keep + (size_t)r * vw + c);
        store_xor(unit, x, q);
      });
    } else {
#pragma unroll 8
      for (int i = 0; i < kPerThread; ++i) {
        const int e = t + i * kThreads, r = e / T, c = e % T;
        s[r * T + (c ^ (r & 31))] = r < prows && c < ncols ? keep[(size_t)r * vw + c] : 0u;
      }
    }
  } else {
    if (mvec) {
      memb_vec([&](uint4* g, uint32_t* unit, int q) { store_xor(unit, *g, q); });
    } else {
#pragma unroll 8
      for (int i = 0; i < kPerThread; ++i) {
        const int e = t + i * kThreads, row = e / WT, col = e % WT;
        s[row * WT + (col ^ swz<WT>(row))] =
            row < 32 * ncols && col < nw ? memb[((size_t)32 * c0 + row) * W + w0 + col] : 0u;
      }
    }
  }
  __syncthreads();

  // 2. Warp w transposes blocks w·kPerWarp.. (memb word wi = b / T of the
  // tile, vertex word c = b % T) into registers, then writes them back in
  // the other layout.
  uint32_t u[kPerWarp];
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    const int b = warp * kPerWarp + r, wi = b / T, c = b % T;
    const uint32_t a = TO_MEMB ? s[(32 * wi + lane) * T + (c ^ lane)]
                               : s[(32 * c + lane) * WT + (wi ^ swz<WT>(lane))];
    u[r] = transpose32(a, lane);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    const int b = warp * kPerWarp + r, wi = b / T, c = b % T;
    if (TO_MEMB)
      s[(32 * c + lane) * WT + (wi ^ swz<WT>(lane))] = u[r];
    else
      s[(32 * wi + lane) * T + (c ^ lane)] = u[r];
  }
  __syncthreads();

  // 3. The other layout out of shared memory.
  if (TO_MEMB) {
    if (mvec) {
      memb_vec([&](uint4* g, uint32_t* unit, int q) { *g = load_xor(unit, q); });
    } else {
#pragma unroll 8
      for (int i = 0; i < kPerThread; ++i) {
        const int e = t + i * kThreads, row = e / WT, col = e % WT;
        if (row < 32 * ncols && col < nw)
          memb[((size_t)32 * c0 + row) * W + w0 + col] = s[row * WT + (col ^ swz<WT>(row))];
      }
    }
  } else {
    if (kvec) {
      keep_vec([&](int r, int c, uint32_t* unit, int q) {
        if (r < prows) *reinterpret_cast<uint4*>(keep + (size_t)r * vw + c) = load_xor(unit, q);
      });
    } else {
#pragma unroll 8
      for (int i = 0; i < kPerThread; ++i) {
        const int e = t + i * kThreads, r = e / T, c = e % T;
        if (r < prows && c < ncols) keep[(size_t)r * vw + c] = s[r * T + (c ^ (r & 31))];
      }
    }
  }
}

template <int WT>
cudaError_t launch_wt(const uint32_t* src, uint32_t* dst, int p, int vw, int W, bool to_memb,
                      cudaStream_t s) {
  const long long nwb = (W + WT - 1) / WT;
  const long long tiles = ((long long)vw + kBlocks / WT - 1) / (kBlocks / WT) * nwb;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const uintptr_t keep = reinterpret_cast<uintptr_t>(to_memb ? src : dst);
  const uintptr_t memb = reinterpret_cast<uintptr_t>(to_memb ? dst : src);
  const int vec_keep = vw % 4 == 0 && keep % 16 == 0;
  const int vec_memb = memb % 16 == 0;
  if (to_memb)
    transpose_kernel<WT, true><<<(unsigned)tiles, kThreads, 0, s>>>(src, dst, p, vw, W, (int)nwb,
                                                                    vec_keep, vec_memb);
  else
    transpose_kernel<WT, false><<<(unsigned)tiles, kThreads, 0, s>>>(src, dst, p, vw, W,
                                                                     (int)nwb, vec_keep, vec_memb);
  return cudaGetLastError();
}

// keep -> memb (to_memb), or memb -> keep (rows of keep are overwritten
// whole). Returns cudaGetLastError.
inline cudaError_t launch_transpose(const uint32_t* src, uint32_t* dst, int p, int vw,
                                    bool to_memb, cudaStream_t s) {
  if (p < 1 || vw < 1) return cudaErrorInvalidValue;
  const int W = (p + 31) / 32;
  if (W == 1) return launch_wt<1>(src, dst, p, vw, W, to_memb, s);
  if (W == 2) return launch_wt<2>(src, dst, p, vw, W, to_memb, s);
  if (W <= 4) return launch_wt<4>(src, dst, p, vw, W, to_memb, s);
  return launch_wt<8>(src, dst, p, vw, W, to_memb, s);
}

}  // namespace membt
