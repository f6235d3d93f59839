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
"ebg_membership", one a call that launches. On the CPU the ids are checked
before the plain version runs. On the card a call is two launches and a
wait: the bitset's vertex-major transpose (`ebg_commit.keep_bits_to_memb`'s
kernel), then the main kernel, which guards its ids and raises a flag that
reaches 4 bytes of pinned host memory once the kernel is done; the wrapper
reads it and raises the ValueError of `dispatch.check_ids`.
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
    host_flag,
)
from repro_torch.kernels.ebg_commit import _miss


def ebg_membership_plain(keep_bits, u, v):
    """Plain PyTorch version (any device)."""
    return _miss(keep_bits, u) + _miss(keep_bits, v)


def keep_to_memb(keep_bits):
    """The vertex-major transpose the main kernel reads (CUDA tensors):
    memb [32·vw, ⌈p/32⌉], as `ebg_commit.keep_bits_to_memb` makes it."""
    p, vw = keep_bits.shape
    memb = torch.empty((32 * vw, (p + 31) // 32), dtype=torch.int32, device=keep_bits.device)
    fn = c_function("ebg_membership", "ebg_membership_memb",
                    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    check_launch("ebg_membership_memb",
                 fn(keep_bits.data_ptr(), memb.data_ptr(), p, vw, cuda_stream_handle()))
    return memb


def launch_main(memb, u, v, num_parts: int, flag=None):
    """The main kernel on CUDA tensors: (out [num_parts, E], err). Given
    `flag` (`dispatch.host_flag("ebg_membership")`), the call waits until
    the id guard's bits have reached it; the result is good only if they
    read 0, which `ebg_membership` checks. Without it nothing waits and
    nothing is checked: that times the kernel without the host read."""
    E = u.shape[0]
    out = torch.empty((num_parts, E), dtype=torch.float32, device=u.device)
    err = torch.zeros((1,), dtype=torch.int32, device=u.device)
    fn = c_function("ebg_membership", "ebg_membership_launch",
                    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_longlong,
                                                                 ctypes.c_void_p])
    flag_host, flag_dev = (None, None) if flag is None else flag[:2]
    status = fn(memb.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(), err.data_ptr(),
                flag_host, flag_dev, num_parts, memb.shape[0] // 32, E, cuda_stream_handle())
    check_launch("ebg_membership", status)
    LAUNCHES["ebg_membership"] += 1
    return out, err


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
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"ebg_membership runs on CPU or CUDA tensors, got {dev}")
    # An id past the bitset would make the plain version's gather fail and
    # the kernel read outside memb (it guards them).
    ids = (("u", u, 32 * vw), ("v", v, 32 * vw))
    if dev.type == "cpu":
        check_ids(*ids)
        return ebg_membership_plain(keep_bits, u, v)
    if p == 0 or vw == 0 or E == 0:  # nothing to compute; vw == 0 takes no id
        check_ids(*ids)
        return torch.empty((p, E), dtype=torch.float32, device=dev)
    flag = host_flag("ebg_membership")
    out, _ = launch_main(keep_to_memb(keep_bits), u, v, p, flag)
    bits = flag[2].value
    if bits:
        check_ids(*ids)  # raises, with the ids' bounds
        raise RuntimeError(f"ebg_membership flagged out-of-range ids (bits {bits})")
    return out
