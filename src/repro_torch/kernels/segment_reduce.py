"""One destination-sorted segmented reduction over an edge stream: the CUDA
kernel `csrc/segment_reduce.cu` and its plain PyTorch version.

Port of the TPU kernel `repro.kernels.segment_reduce.segment_reduce_pallas`
(oracles `repro.kernels.ref.segment_min_plus_ref` and `segment_sum_ref`).
Inputs are an edge stream lsrc/ldst [E] (int32, 0 <= lsrc < V and
0 <= ldst < num_out, else ValueError) and weight [E] (f32), and values
val [V] (f32, V >= num_out); the result is out [num_out] f32.

  op="min": out[d] = min(val[d], min over edges into d of val[src] + w);
      pads carry w = INF (3e38) and are masked by a select.
  op="sum": out[d] = sum over edges into d of val[src] * w; pads carry
      w = 0 and add nothing. The f32 products are added in float64 and
      the sum rounded to f32 once (the reference adds in f32).

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel, and anything else raises. Launches are counted in `LAUNCHES` as
"segment_reduce.min" and "segment_reduce.sum". On the CPU the ids are
checked before the plain version runs; on the card the kernel guards them
and raises a flag, which it writes to 4 bytes of pinned host memory once
it is final; the wrapper waits for it and reads it once a call before it
returns (the rest of the kernel runs on in stream order).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.bsp_superstep import INF
from repro_torch.kernels.dispatch import (
    LAUNCHES,
    c_function,
    check_ids,
    check_launch,
    check_tensor,
    cuda_stream_handle,
    host_flag,
)

OPS = ("min", "sum")
_COUNTS = {op: f"segment_reduce.{op}" for op in OPS}  # the LAUNCHES keys


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


def _check_arguments(lsrc, ldst, weight, val, num_out: int, op: str) -> None:
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
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"segment_reduce runs on CPU or CUDA tensors, got {dev}")


def launch_unchecked(lsrc, ldst, weight, val, num_out: int, op: str, flag=None):
    """Launch the kernel on CUDA tensors and return `out`. Given `flag`
    (`dispatch.host_flag("segment_reduce")`), the kernel writes its error
    bits there and the call waits until it has; the result is good only if
    they read 0, which `segment_reduce` checks. Without it nothing waits and nothing is
    checked: that times the kernel without the host read."""
    E, V = lsrc.shape[0], val.shape[0]
    dev = lsrc.device
    out = torch.empty((num_out,), dtype=torch.float32, device=dev)
    # The device workspace: the sum's f64 accumulator, then the error flag.
    ws = torch.empty((num_out + 1 if op == "sum" else 1,), dtype=torch.float64, device=dev)
    fn = c_function("segment_reduce", "segment_reduce_launch",
                    [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                    + [ctypes.c_void_p])
    flag_host, flag_dev = (None, None) if flag is None else flag[:2]
    err = fn(lsrc.data_ptr(), ldst.data_ptr(), weight.data_ptr(), val.data_ptr(),
             out.data_ptr(), ws.data_ptr(), flag_host, flag_dev, E, V, num_out, OPS.index(op),
             cuda_stream_handle())
    check_launch("segment_reduce", err)
    LAUNCHES[_COUNTS[op]] += 1
    return out


def segment_reduce(lsrc, ldst, weight, val, *, num_out: int, op: str = "min"):
    """One segmented reduction; see the module docstring."""
    _check_arguments(lsrc, ldst, weight, val, num_out, op)
    # Out-of-range ids would make the kernel read and write outside its
    # tensors (it guards them) and the plain version raise an IndexError.
    ids = (("lsrc", lsrc, val.shape[0]), ("ldst", ldst, num_out))
    if lsrc.device.type == "cpu":
        check_ids(*ids)
        return segment_reduce_plain(lsrc, ldst, weight, val, num_out, op=op)
    flag = host_flag("segment_reduce")
    out = launch_unchecked(lsrc, ldst, weight, val, num_out, op, flag)
    bits = flag[2].value
    if bits:
        check_ids(*ids)  # raises, with the ids' bounds
        raise RuntimeError(f"segment_reduce flagged out-of-range ids (bits {bits})")
    return out
