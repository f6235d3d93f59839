"""One destination-sorted segmented reduction over an edge stream: the CUDA
kernel `csrc/segment_reduce.cu` and its plain PyTorch version.

Port of the TPU kernel `repro.kernels.segment_reduce.segment_reduce_pallas`
(oracles `repro.kernels.ref.segment_min_plus_ref` and `segment_sum_ref`).
Inputs are an edge stream lsrc/ldst [E] (int32, 0 <= lsrc < V and
0 <= ldst < num_out, else ValueError) and weight [E] (f32), and values val [V] (f32, V >= num_out); the result is
out [num_out] f32.

  op="min": out[d] = min(val[d], min over edges into d of val[src] + w);
      pads carry w = INF (3e38) and are masked by a select.
  op="sum": out[d] = sum over edges into d of val[src] * w; pads carry
      w = 0 and add nothing. The f32 products are added in float64 and
      the sum rounded to f32 once (the reference adds in f32).

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel, and anything else raises. Launches are counted in `LAUNCHES` as
"segment_reduce.min" and "segment_reduce.sum".
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.bsp_superstep import INF
from repro_torch.kernels.dispatch import (
    LAUNCHES,
    check_ids,
    check_launch,
    check_tensor,
    cuda_stream_handle,
    load_library,
)

OPS = ("min", "sum")


def segment_reduce_plain(lsrc, ldst, weight, val, num_out: int, *, op: str = "min"):
    """Plain PyTorch version (any device), term for term the reference
    oracles: masked contributions, then a scatter-min seeded with
    val[:num_out] or a scatter-add into zeros.

    The sum adds the f32 contributions in float64 and rounds once, as the
    kernel does: an f32 sum in edge order drifts with the length of a run
    (by about 2e-4 over a power-law hub's 10^6 terms)."""
    src = lsrc.long()
    dst = ldst.long()
    gathered = val[src]
    if op == "min":
        data = torch.where(weight < INF, gathered + weight, INF)
        return val[:num_out].scatter_reduce(0, dst, data, "amin", include_self=True)
    data = torch.where(weight != 0.0, gathered * weight, 0.0)
    out = torch.zeros((num_out,), dtype=torch.float64, device=val.device)
    return out.index_add_(0, dst, data.double()).float()


def segment_reduce(lsrc, ldst, weight, val, *, num_out: int, op: str = "min"):
    """One segmented reduction; see the module docstring."""
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    if lsrc.ndim != 1 or val.ndim != 1:
        raise ValueError(f"lsrc and val must be 1-D, got {tuple(lsrc.shape)} and "
                         f"{tuple(val.shape)}")
    (E,), (V,) = lsrc.shape, val.shape
    if not 1 <= num_out <= V:
        raise ValueError(f"num_out must be in [1, len(val)={V}], got {num_out}")
    dev = lsrc.device
    check_tensor("lsrc", lsrc, torch.int32, (E,), dev)
    check_tensor("ldst", ldst, torch.int32, (E,), dev)
    check_tensor("weight", weight, torch.float32, (E,), dev)
    check_tensor("val", val, torch.float32, (V,), dev)
    # Out-of-range ids would make the kernel read and write outside its
    # tensors; the plain version would raise an IndexError.
    check_ids(("lsrc", lsrc, V), ("ldst", ldst, num_out))
    if dev.type == "cpu":
        return segment_reduce_plain(lsrc, ldst, weight, val, num_out, op=op)
    if dev.type != "cuda":
        raise ValueError(f"segment_reduce runs on CPU or CUDA tensors, got {dev}")
    out = torch.empty((num_out,), dtype=torch.float32, device=dev)
    # The sum's f64 accumulator, rounded into `out` once.
    acc = torch.empty((num_out,), dtype=torch.float64, device=dev) if op == "sum" else None
    lib = load_library("segment_reduce")
    fn = lib.segment_reduce_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(lsrc.data_ptr(), ldst.data_ptr(), weight.data_ptr(), val.data_ptr(),
             out.data_ptr(), None if acc is None else acc.data_ptr(), E, num_out,
             OPS.index(op), cuda_stream_handle())
    check_launch("segment_reduce", err)
    LAUNCHES[f"segment_reduce.{op}"] += 1
    return out
