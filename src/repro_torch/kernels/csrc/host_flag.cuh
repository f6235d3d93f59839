// A kernel's error flag in pinned host memory: the launch entry sets it to
// kPending, the kernel (or a kernel after it on the stream) writes the
// final bits through the device's pointer to it, and the entry spins until
// they arrive. A call then costs the host a wait for the flag, not a copy
// and a stream synchronize. segment_reduce.cu and ebg_membership.cu use it.

#pragma once

#include <cuda_runtime.h>

namespace hostflag {

constexpr unsigned kPending = 0xffffffffu;  // the host flag until the kernel writes it

// 4 bytes of pinned host memory that kernels can write (mapped): the host
// pointer into *host, the device's pointer to it into *dev.
inline cudaError_t alloc(void** host, void** dev) {
  cudaError_t err = cudaHostAlloc(host, sizeof(unsigned), cudaHostAllocMapped);
  if (err == cudaSuccess) err = cudaHostGetDevicePointer(dev, *host, 0);
  return err;
}

// Spin on the flag; now and then ask the stream, so that a fault (or a
// stream that ended without the flag) returns an error, not a hang.
inline int wait(volatile unsigned* fh, cudaStream_t s) {
  for (unsigned spins = 1; *fh == kPending; ++spins) {
    if (spins % 4096 == 0) {
      const cudaError_t e = cudaStreamQuery(s);
      if (e == cudaSuccess) return *fh == kPending ? (int)cudaErrorUnknown : 0;
      if (e != cudaErrorNotReady) return (int)e;
    }
  }
  return 0;
}

}  // namespace hostflag
