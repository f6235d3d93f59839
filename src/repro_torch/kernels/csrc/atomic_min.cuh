// The float min commit shared by the min-plus kernels (bsp_superstep.cu,
// segment_reduce.cu).
#pragma once

#include <cuda_runtime.h>

// *addr = min(*addr, x) as one atomic step; returns true if it lowered the
// value. The CAS loop compares floats, so it is exact for negative values
// too (negated labels under combine="max"), where an integer atomicMin on
// the bit patterns would not be. *addr is read through L2 (other CTAs
// write it).
__device__ __forceinline__ bool atomic_min_f32(float* addr, float x) {
  unsigned* a = reinterpret_cast<unsigned*>(addr);
  unsigned old = __float_as_uint(__ldcg(addr));
  while (x < __uint_as_float(old)) {
    const unsigned assumed = old;
    old = atomicCAS(a, assumed, __float_as_uint(x));
    if (old == assumed) return true;
  }
  return false;
}
