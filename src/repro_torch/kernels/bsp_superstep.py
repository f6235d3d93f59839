"""Whole local stage of one BSP superstep per worker: the CUDA kernel
`csrc/bsp_superstep.cu` and its plain PyTorch version.

Port of the TPU kernel `repro.kernels.bsp_superstep.bsp_superstep_pallas`
(oracle `repro.kernels.ref.bsp_superstep_ref`). Inputs are [p, E] edge
streams lsrc/ldst (int32) and weight (f32), and values val [R, num_out]
(f32) with R = B·p: value row r runs on stream row r % p, so a batch of B
queries over one partition shares the streams (the reference's batched
driver vmaps the kernel); the stream is never copied. The result is
(new_val [R, num_out] f32, iters [R] int32); a batch's rows are bitwise
the rows of the same values launched alone.

  combine="min": Jacobi min-plus passes to the local fixpoint, capped at
      `inner_cap`; each pass gathers from the values at its start and
      `iters` counts, per worker, the passes that changed something. Pads
      carry weight INF (3e38) and are masked by a select. Streams may
      concatenate direction halves, each dst-sorted. The kernel's values
      and iters equal the plain version's bit for bit, except where -0 and
      +0 candidates tie below a positive value: the kernel keeps -0, the
      plain version the first in edge order (equal as floats). A -0
      candidate needs a -0 weight, which no program's stream holds.
  A `live` mask (min only; bool [B], one a query) leaves the rows of a
      query that is not live as they are: no pass, 0 iterations (the
      engine's masked steps cost no pass of the kernel).
  combine="sum": one push-sum sweep of `val/out_degree` (`out_degree`
      [p, num_out] f32); pads carry weight 0. The f32 products are added
      in float64 and each sum rounded to f32 once (the reference adds in
      f32). Each worker's stream must be dst-sorted, as the reference
      requires: the kernel stores each destination's sum once.

Ids must lie in [0, num_out); `bsp_superstep` raises the ValueError of
`dispatch.check_ids` for one that does not. On the CPU the ids are checked
before the plain version runs; on the card both kernels guard them (an edge
with a bad id reads and commits nothing) and OR error bits into a 4-byte
device flag, which `bsp_superstep` reads once a call. `launch_flagged`
leaves the flag to its caller: the engine gathers a run's bits in one flag
and reads it with the host syncs it makes anyway.

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
    check_ids,
    check_launch,
    check_tensor,
    cuda_stream_handle,
)

INF = 3.0e38  # the min identity pads carry (f32-representable)
COMBINES = ("min", "sum")


def bsp_superstep_plain(lsrc, ldst, weight, val, num_out: int, *, combine: str = "min",
                        inner_cap: int = 1, out_degree=None, live=None):
    """Plain PyTorch version (any device), term for term the reference
    oracle: a batched any-worker pass loop whose per-worker change counts
    equal the per-worker loop's. A batch of value rows (R = B·p) runs
    query by query, each on the shared streams; a query that is not live
    (`live`, min only) keeps its values with 0 iterations."""
    p = lsrc.shape[0]
    if val.shape[0] != p or live is not None:
        lives = [True] * (val.shape[0] // p) if live is None else live.tolist()
        outs = [bsp_superstep_plain(lsrc, ldst, weight, v, num_out, combine=combine,
                                    inner_cap=inner_cap, out_degree=out_degree) if on
                else (v.clone(), torch.zeros((p,), dtype=torch.int32, device=v.device))
                for v, on in zip(val.split(p), lives)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
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


def _check_arguments(lsrc, ldst, weight, val, num_out, combine, out_degree, live=None):
    if combine not in COMBINES:
        raise ValueError(f"combine must be one of {COMBINES}, got {combine!r}")
    if live is not None and combine != "min":
        raise ValueError("live is taken by combine='min' only")
    if (combine == "sum") != (out_degree is not None):
        raise ValueError("out_degree is required for combine='sum' and only then")
    if lsrc.ndim != 2:
        raise ValueError(f"lsrc must be [p, E], got shape {tuple(lsrc.shape)}")
    p, E = lsrc.shape
    dev = lsrc.device
    check_tensor("lsrc", lsrc, torch.int32, (p, E), dev)
    check_tensor("ldst", ldst, torch.int32, (p, E), dev)
    check_tensor("weight", weight, torch.float32, (p, E), dev)
    rows = val.shape[0] if val.ndim == 2 and p and val.shape[0] % p == 0 else p
    check_tensor("val", val, torch.float32, (rows, num_out), dev)
    if out_degree is not None:
        check_tensor("out_degree", out_degree, torch.float32, (p, num_out), dev)
    if live is not None:
        check_tensor("live", live, torch.bool, (rows // p,), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"bsp_superstep runs on CPU or CUDA tensors, got {dev}")
    if dev.type == "cuda" and E == 0:
        raise ValueError("the CUDA superstep kernel needs a non-empty edge stream")


def check_flag(err: torch.Tensor, lsrc, ldst, num_out: int) -> None:
    """Raise the ValueError of `dispatch.check_ids` if the kernels' error
    flag `err` (a host or device int32 scalar tensor, or its value) holds
    any bit; this reads it."""
    bits = int(err)
    if bits:
        check_ids(("lsrc", lsrc, num_out), ("ldst", ldst, num_out))  # raises, with the bounds
        raise RuntimeError(f"bsp_superstep flagged out-of-range ids (bits {bits})")


def launch_flagged(lsrc, ldst, weight, val, *, num_out: int, combine: str = "min",
                   inner_cap: int = 1, out_degree=None, err=None, taken=None, live=None):
    """The superstep without the read of the error flag: on the card the
    kernels OR the id guard's bits into `err` (an int32 [1] device tensor
    the caller zeroed, and reads when it syncs: `check_flag`); an edge with
    a bad id has read and committed nothing. On the CPU the ids are checked
    here, before the plain version. `taken` (min on the card only): a
    zeroed int64 [k] device tensor, to which pass i < k of the kernel adds
    the edges that took part in it (the others' sources kept their values).
    `live`: see the module docstring. Returns (new_val, iters)."""
    _check_arguments(lsrc, ldst, weight, val, num_out, combine, out_degree, live)
    return _run(lsrc, ldst, weight, val, num_out, combine, inner_cap, out_degree, err, taken,
                live)


def _run(lsrc, ldst, weight, val, num_out, combine, inner_cap, out_degree, err, taken=None,
         live=None):
    if lsrc.device.type == "cpu":
        check_ids(("lsrc", lsrc, num_out), ("ldst", ldst, num_out))
        return bsp_superstep_plain(lsrc, ldst, weight, val, num_out, combine=combine,
                                   inner_cap=inner_cap, out_degree=out_degree, live=live)
    p, E = lsrc.shape
    rows = val.shape[0]
    dev = lsrc.device
    check_tensor("err", err, torch.int32, (1,), dev)
    if taken is not None:
        check_tensor("taken", taken, torch.int64, (taken.numel(),), dev)
    out = torch.empty((rows, num_out), dtype=torch.float32, device=dev)
    iters = torch.empty((rows,), dtype=torch.int32, device=dev)
    scratch_bytes = c_function("bsp_superstep", "bsp_superstep_scratch_bytes",
                               [ctypes.c_int] * 4, restype=ctypes.c_longlong)
    nbytes = scratch_bytes(rows, E, num_out, COMBINES.index(combine))
    scratch = torch.empty(((nbytes + 7) // 8,), dtype=torch.float64, device=dev)
    fn = c_function("bsp_superstep", "bsp_superstep_launch",
                    [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_void_p]
                    + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    code = fn(
        lsrc.data_ptr(), ldst.data_ptr(), weight.data_ptr(), val.data_ptr(),
        None if out_degree is None else out_degree.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), iters.data_ptr(), err.data_ptr(),
        None if taken is None else taken.data_ptr(), 0 if taken is None else taken.numel(),
        None if live is None else live.data_ptr(),
        p, rows, E, num_out, COMBINES.index(combine), int(inner_cap), cuda_stream_handle(),
    )
    check_launch("bsp_superstep", code)
    LAUNCHES[f"bsp_superstep.{combine}"] += 1
    return out, iters


def bsp_superstep(lsrc, ldst, weight, val, *, num_out: int, combine: str = "min",
                  inner_cap: int = 1, out_degree=None, live=None):
    """One superstep's local stage; see the module docstring."""
    _check_arguments(lsrc, ldst, weight, val, num_out, combine, out_degree, live)
    err = None
    if lsrc.device.type == "cuda":
        err = torch.zeros((1,), dtype=torch.int32, device=lsrc.device)
    out = _run(lsrc, ldst, weight, val, num_out, combine, inner_cap, out_degree, err,
               live=live)
    if err is not None:
        check_flag(err, lsrc, ldst, num_out)
    return out
