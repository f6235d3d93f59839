// The membership bitset's two layouts and the kernel that converts them.
//
// keep[p, vw] is part-major (bit k of word c: vertex 32c+k is in part r);
// memb[32·vw, W], W = ⌈p/32⌉, is vertex-major (bit i of word w: part 32w+i
// holds the vertex), so an endpoint's parts are W consecutive words.
// ebg_commit.cu and ebg_membership.cu both work on memb and include this
// header for the conversion.
//
// A warp transposes the 32x32 bit blocks (parts 32w.., vertices 32c..) for
// kCols consecutive c. keep -> memb: lane i holds part 32w+i's word; the
// ballot of bit x over the lanes is vertex 32c+x's word. memb -> keep:
// lane x holds vertex 32c+x's word; the ballot of bit i is part 32w+i's
// word. Parts >= p read 0 and are not written. Bound by bytes: each word
// is read and written once.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace membt {

constexpr int kCols = 8;  // vertex words a warp transposes

template <bool TO_MEMB>
__global__ void transpose_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                                 int p, int vw, int W) {
  const int lane = threadIdx.x & 31;
  const long long groups = (long long)((vw + kCols - 1) / kCols) * W;
  const long long nwarps = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long gi = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); gi < groups;
       gi += nwarps) {
    const int w = (int)(gi % W);
    const int c0 = (int)(gi / W) * kCols;
    const int part = 32 * w + lane;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const int c = c0 + cc;
      if (c >= vw) break;  // warp-uniform
      uint32_t word;
      if (TO_MEMB) {
        word = part < p ? src[(size_t)part * vw + c] : 0u;
      } else {
        word = src[((size_t)32 * c + lane) * W + w];
      }
      uint32_t mine = 0;
#pragma unroll
      for (int bit = 0; bit < 32; ++bit) {
        const uint32_t col = __ballot_sync(0xffffffffu, (word >> bit) & 1u);
        if (lane == bit) mine = col;
      }
      if (TO_MEMB) {
        dst[((size_t)32 * c + lane) * W + w] = mine;
      } else if (part < p) {
        dst[(size_t)part * vw + c] = mine;
      }
    }
  }
}

// keep -> memb (to_memb), or memb -> keep (rows of keep are overwritten
// whole). Returns cudaGetLastError.
inline cudaError_t launch_transpose(const uint32_t* src, uint32_t* dst, int p, int vw,
                                    bool to_memb, cudaStream_t s) {
  if (p < 1 || vw < 1) return cudaErrorInvalidValue;
  const int W = (p + 31) / 32;
  const long long groups = (long long)((vw + kCols - 1) / kCols) * W;
  const long long blocks = (groups + 7) / 8;  // 8 warps a block
  const int grid = (int)(blocks < 132 * 16 ? blocks : 132 * 16);
  if (to_memb) {
    transpose_kernel<true><<<grid, 256, 0, s>>>(src, dst, p, vw, W);
  } else {
    transpose_kernel<false><<<grid, 256, 0, s>>>(src, dst, p, vw, W);
  }
  return cudaGetLastError();
}

}  // namespace membt
