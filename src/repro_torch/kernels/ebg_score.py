"""Membership term of the streaming vertex-cut score: the CUDA kernel
`csrc/ebg_membership.cu` and its plain PyTorch version.

Port of the TPU kernel `repro.kernels.ebg_score.ebg_membership_pallas`
(oracle `repro.kernels.ref.ebg_membership_ref`). Inputs are the packed
membership bitset keep_bits [p, Vw] (32-bit words held in an int32 tensor,
as `ops.pack_keep_bits` makes them: bit k of word w is vertex 32w+k) and
edge endpoints u, v [E] (int32, each in [0, 32·Vw), else ValueError); the
result is [p, E] f32,

    memb[i, e] = 1[u_e not in keep_i] + 1[v_e not in keep_i]   (0, 1 or 2).

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel, and anything else raises. Launches are counted in `LAUNCHES` as
"ebg_membership".
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.dispatch import (
    LAUNCHES,
    check_ids,
    check_launch,
    check_tensor,
    cuda_stream_handle,
    load_library,
)
from repro_torch.kernels.ebg_commit import _miss


def ebg_membership_plain(keep_bits, u, v):
    """Plain PyTorch version (any device)."""
    return _miss(keep_bits, u) + _miss(keep_bits, v)


def ebg_membership(keep_bits, u, v):
    """[p, E] membership counts; see the module docstring."""
    if keep_bits.ndim != 2 or u.ndim != 1:
        raise ValueError(f"keep_bits must be [p, Vw] and u [E], got {tuple(keep_bits.shape)} "
                         f"and {tuple(u.shape)}")
    (p, vw), (E,) = keep_bits.shape, u.shape
    dev = keep_bits.device
    check_tensor("keep_bits", keep_bits, torch.int32, (p, vw), dev)
    check_tensor("u", u, torch.int32, (E,), dev)
    check_tensor("v", v, torch.int32, (E,), dev)
    # An id past the bitset would make the kernel read outside it.
    check_ids(("u", u, 32 * vw), ("v", v, 32 * vw))
    if dev.type == "cpu":
        return ebg_membership_plain(keep_bits, u, v)
    if dev.type != "cuda":
        raise ValueError(f"ebg_membership runs on CPU or CUDA tensors, got {dev}")
    out = torch.empty((p, E), dtype=torch.float32, device=dev)
    lib = load_library("ebg_membership")
    fn = lib.ebg_membership_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(keep_bits.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(), p, vw, E,
             cuda_stream_handle())
    check_launch("ebg_membership", err)
    LAUNCHES["ebg_membership"] += 1
    return out
