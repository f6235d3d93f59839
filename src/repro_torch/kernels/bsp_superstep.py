"""Whole local stage of one BSP superstep per worker: the CUDA kernel
`csrc/bsp_superstep.cu` and its plain PyTorch version.

Port of the TPU kernel `repro.kernels.bsp_superstep.bsp_superstep_pallas`
(oracle `repro.kernels.ref.bsp_superstep_ref`). Inputs are [p, E] edge
streams lsrc/ldst (int32) and weight (f32), and values val [p, num_out]
(f32); the result is (new_val [p, num_out] f32, iters [p] int32).

  combine="min": Jacobi min-plus passes to the local fixpoint, capped at
      `inner_cap`; each pass gathers from the values at its start and
      `iters` counts, per worker, the passes that changed something. Pads
      carry weight INF (3e38) and are masked by a select. Streams may
      concatenate direction halves, each dst-sorted.
  combine="sum": one push-sum sweep of `val/out_degree` (`out_degree`
      [p, num_out] f32); pads carry weight 0. The f32 products are added
      in float64 and each sum rounded to f32 once (the reference adds in
      f32). Each worker's stream must be dst-sorted, as the reference
      requires: the kernel stores each destination's sum once.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel, and anything else raises. The two combines are counted apart in
`LAUNCHES` as "bsp_superstep.min" (`bsp_min_kernel`, one cooperative
launch) and "bsp_superstep.sum" (`bsp_share_kernel`, `bsp_sum_kernel` and
`bsp_carry_kernel`, three ordinary launches counted as one call).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.dispatch import (
    LAUNCHES,
    c_function,
    check_launch,
    check_tensor,
    cuda_stream_handle,
)

INF = 3.0e38  # the min identity pads carry (f32-representable)
COMBINES = ("min", "sum")
SYNC_BYTES_PER_WORKER = 16  # sizeof(WorkerSync) in csrc/bsp_superstep.cu


def bsp_superstep_plain(lsrc, ldst, weight, val, num_out: int, *, combine: str = "min",
                        inner_cap: int = 1, out_degree=None):
    """Plain PyTorch version (any device), term for term the reference
    oracle: a batched any-worker pass loop whose per-worker change counts
    equal the per-worker loop's."""
    p = val.shape[0]
    src = lsrc.long()
    dst = ldst.long()
    if combine == "sum":
        # The f32 products are added in float64 and rounded once, as the
        # kernel adds them: an f32 sum in edge order drifts with the length
        # of a run (by about 2e-4 over a power-law hub's 10^6 terms).
        share = torch.where(out_degree > 0, val / out_degree, 0.0)
        data = torch.gather(share, 1, src) * weight
        data = torch.where(weight != 0.0, data, 0.0)
        new = torch.zeros((p, num_out), dtype=torch.float64, device=val.device)
        new.scatter_add_(1, dst, data.double())
        return new.float(), torch.ones((p,), dtype=torch.int32, device=val.device)
    mask = weight < INF
    v = val
    iters = torch.zeros((p,), dtype=torch.int32, device=val.device)
    it = 0
    while it < inner_cap:
        data = torch.where(mask, torch.gather(v, 1, src) + weight, INF)
        new = v.scatter_reduce(1, dst, data, "amin", include_self=True)
        ch = (new != v).any(dim=1)
        it += 1
        iters += ch.to(torch.int32)
        v = new
        if not bool(ch.any()):
            break
    return v, iters


def bsp_superstep(lsrc, ldst, weight, val, *, num_out: int, combine: str = "min",
                  inner_cap: int = 1, out_degree=None):
    """One superstep's local stage; see the module docstring."""
    if combine not in COMBINES:
        raise ValueError(f"combine must be one of {COMBINES}, got {combine!r}")
    if (combine == "sum") != (out_degree is not None):
        raise ValueError("out_degree is required for combine='sum' and only then")
    if lsrc.ndim != 2:
        raise ValueError(f"lsrc must be [p, E], got shape {tuple(lsrc.shape)}")
    p, E = lsrc.shape
    dev = lsrc.device
    check_tensor("lsrc", lsrc, torch.int32, (p, E), dev)
    check_tensor("ldst", ldst, torch.int32, (p, E), dev)
    check_tensor("weight", weight, torch.float32, (p, E), dev)
    check_tensor("val", val, torch.float32, (p, num_out), dev)
    if out_degree is not None:
        check_tensor("out_degree", out_degree, torch.float32, (p, num_out), dev)
    if dev.type == "cpu":
        return bsp_superstep_plain(lsrc, ldst, weight, val, num_out, combine=combine,
                                   inner_cap=inner_cap, out_degree=out_degree)
    if dev.type != "cuda":
        raise ValueError(f"bsp_superstep runs on CPU or CUDA tensors, got {dev}")
    if E == 0:
        raise ValueError("the CUDA superstep kernel needs a non-empty edge stream")
    out = torch.empty((p, num_out), dtype=torch.float32, device=dev)
    iters = torch.empty((p,), dtype=torch.int32, device=dev)
    scratch_bytes = c_function("bsp_superstep", "bsp_superstep_scratch_bytes",
                               [ctypes.c_int] * 4, restype=ctypes.c_longlong)
    nbytes = scratch_bytes(p, E, num_out, COMBINES.index(combine))
    scratch = torch.empty(((nbytes + 7) // 8,), dtype=torch.float64, device=dev)
    sync = (torch.zeros((p * SYNC_BYTES_PER_WORKER // 4,), dtype=torch.int32, device=dev)
            if combine == "min" else None)
    fn = c_function("bsp_superstep", "bsp_superstep_launch",
                    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    err = fn(
        lsrc.data_ptr(), ldst.data_ptr(), weight.data_ptr(), val.data_ptr(),
        None if out_degree is None else out_degree.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), iters.data_ptr(),
        None if sync is None else sync.data_ptr(),
        p, E, num_out, COMBINES.index(combine), int(inner_cap), cuda_stream_handle(),
    )
    check_launch("bsp_superstep", err)
    LAUNCHES[f"bsp_superstep.{combine}"] += 1
    return out, iters
