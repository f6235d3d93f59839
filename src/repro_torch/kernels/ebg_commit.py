"""Streaming-scorer block commit (score + argmin + commit) for the chunked
vertex-cut partitioners: the CUDA kernel `csrc/ebg_commit.cu` and its plain
PyTorch version.

Port of the TPU kernel `repro.kernels.ebg_commit.ebg_commit_block_pallas`
(oracle `repro.kernels.ref.ebg_commit_block_ref`). For one block of B
edges: the miss bits of u and v against the block-start packed bitset
(`keep_bits` [p, ⌈V/32⌉], 32-bit words held in an int32 tensor: bit k of
word w is vertex 32w+k), then for each edge in turn the argmin over the p
parts of `gain + ce·e_c·norm + cv·v_c·inv_v` (ties -> lowest id) and the
exact commit of the counters and bits. Pad edges (valid False) are scored
but commit nothing; their part is p. `window=True` clears the winner's
miss rows on later edges that share an endpoint (bit-identical to the scan).

The coefficient vector `coef` [5] f32 is (ce, cv, inv_e, inv_v, eps); it
is computed in f32 by the caller. Both versions compute the score as the
reference does once XLA has compiled it on the CPU, with two fused
multiply-adds: fma(cv·v_c, inv_v, fma(ce·e_c, norm, gain)), every other
operation rounded on its own (the kernel writes the FMAs out and builds
with -fmad=false; the plain version emulates them exactly in float64).

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel, and anything else raises. On the card a launch works on the
bitset's vertex-major transpose `memb` [32·⌈V/32⌉, ⌈p/32⌉] (bit i of word
w: part 32w+i holds the vertex), made by `keep_bits_to_memb` before it and
turned back by `memb_to_keep_bits` after it — two small kernels, counted
as "ebg_commit.keep_to_memb" and "ebg_commit.memb_to_keep" beside the
commit's "ebg_commit". Their plain versions serve the tests.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.dispatch import (
    LAUNCHES,
    c_function,
    check_ids,
    check_launch,
    check_tensor,
    cuda_stream_handle,
)

BALANCE_MODES = ("static", "range")


def _bit(b: int) -> int:
    """int32 value of a word with only bit b set."""
    return (1 << b) if b < 31 else -(1 << 31)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a*b + c rounded once, as a fused multiply-add rounds it.

    The f32 product is exact in float64; the float64 sum is made
    round-to-odd (its error comes from TwoSum), and a round-to-odd value
    with 29 spare bits rounds to f32 exactly as the exact sum would."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.nextafter(s, err * math.inf)  # NaN where err == 0: not taken
    return torch.where((err != 0) & even, away, s).float()


def _unpack(words: torch.Tensor) -> torch.Tensor:
    """[r, n] int32 words -> [r, 32n] bool: bit k of word c is column 32c+k."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[..., None] >> shifts) & 1).bool().reshape(words.shape[0], -1)


def pack_keep_bits(keep_bool: torch.Tensor) -> torch.Tensor:
    """[p, V] bool -> [p, ceil(V/32)] packed bitset in int32 words (the
    inverse of `_unpack`; also `ops.pack_keep_bits`)."""
    p, V = keep_bool.shape
    pad = (-V) % 32
    kb = torch.nn.functional.pad(keep_bool.to(torch.int64), (0, pad))
    words = kb.reshape(p, -1, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=keep_bool.device)
    packed = (words << shifts).sum(dim=-1)
    packed = torch.where(packed >= 1 << 31, packed - (1 << 32), packed)
    return packed.to(torch.int32)


def keep_bits_to_memb_plain(keep_bits: torch.Tensor) -> torch.Tensor:
    """keep [p, vw] -> memb [32·vw, ⌈p/32⌉]: bit i of memb[x, w] is bit
    (x mod 32) of keep[32w+i, x // 32]; parts past p read 0."""
    p = keep_bits.shape[0]
    bits = _unpack(keep_bits)  # [p, 32·vw]
    pad = torch.zeros(((-p) % 32, bits.shape[1]), dtype=torch.bool, device=bits.device)
    return pack_keep_bits(torch.cat([bits, pad]).T)


def memb_to_keep_bits_plain(memb: torch.Tensor, num_parts: int) -> torch.Tensor:
    """memb [32·vw, W] -> keep [num_parts, vw], the inverse of
    `keep_bits_to_memb_plain` (bits of parts past num_parts are dropped)."""
    return pack_keep_bits(_unpack(memb)[:, :num_parts].T)


def _transpose(src, dst, p: int, vw: int, to_memb: bool) -> None:
    fn = c_function("ebg_commit", "ebg_memb_transpose",
                    [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    check_launch("ebg_memb_transpose", fn(src.data_ptr(), dst.data_ptr(), p, vw, int(to_memb),
                                          cuda_stream_handle()))


def keep_bits_to_memb(keep_bits: torch.Tensor) -> torch.Tensor:
    """The vertex-major transpose of a packed bitset; see
    `keep_bits_to_memb_plain`. A CUDA tensor launches the transpose kernel."""
    if keep_bits.ndim != 2:
        raise ValueError(f"keep_bits must be [p, words], got shape {tuple(keep_bits.shape)}")
    p, vw = keep_bits.shape
    check_tensor("keep_bits", keep_bits, torch.int32, (p, vw))
    if keep_bits.device.type == "cpu":
        return keep_bits_to_memb_plain(keep_bits)
    if keep_bits.device.type != "cuda":
        raise ValueError(f"keep_bits_to_memb runs on CPU or CUDA tensors, got {keep_bits.device}")
    memb = torch.empty((32 * vw, (p + 31) // 32), dtype=torch.int32, device=keep_bits.device)
    _transpose(keep_bits, memb, p, vw, True)
    LAUNCHES["ebg_commit.keep_to_memb"] += 1
    return memb


def memb_to_keep_bits(memb: torch.Tensor, num_parts: int, out=None) -> torch.Tensor:
    """The packed bitset [num_parts, ⌈V/32⌉] of a vertex-major `memb`,
    written into `out` when it is given; see `memb_to_keep_bits_plain`. A
    CUDA tensor launches the transpose kernel."""
    if memb.ndim != 2 or memb.shape[0] % 32 or memb.shape[1] != (num_parts + 31) // 32:
        raise ValueError(f"memb of {num_parts} parts must be [32·vw, {(num_parts + 31) // 32}], "
                         f"got shape {tuple(memb.shape)}")
    vw = memb.shape[0] // 32
    check_tensor("memb", memb, torch.int32, tuple(memb.shape))
    if out is not None:
        check_tensor("out", out, torch.int32, (num_parts, vw), memb.device)
    if memb.device.type == "cpu":
        keep = memb_to_keep_bits_plain(memb, num_parts)
        return keep if out is None else out.copy_(keep)
    if memb.device.type != "cuda":
        raise ValueError(f"memb_to_keep_bits runs on CPU or CUDA tensors, got {memb.device}")
    if out is None:
        out = torch.empty((num_parts, vw), dtype=torch.int32, device=memb.device)
    _transpose(memb, out, num_parts, vw, False)
    LAUNCHES["ebg_commit.memb_to_keep"] += 1
    return out


def _miss(keep_bits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """[B] vertex ids -> [p, B] f32: 1 where the id is absent from keep[i]."""
    ids = ids.long()
    word = keep_bits[:, ids >> 5]
    bit = (word >> (ids & 31).to(torch.int32)) & 1
    return (1 - bit).to(torch.float32)


def ebg_commit_block_plain(
    keep_bits, e_count, v_count, u, v, valid, coef, *,
    balance: str = "static", wu=None, wv=None, window: bool = False,
):
    """Plain PyTorch version (any device); returns new
    (keep_bits, e_count, v_count, parts) and leaves its inputs as they were."""
    p = keep_bits.shape[0]
    B = u.shape[0]
    mu = _miss(keep_bits, u)  # [p, B] against the block-start bitset
    mv = _miss(keep_bits, v)
    kb = keep_bits.clone()
    e_c = e_count.clone()
    v_c = v_count.clone()
    ce, cv, inv_e, inv_v, eps = coef.unbind(0)  # 0-d f32 tensors
    one = torch.ones((), dtype=torch.float32, device=coef.device)
    u_l, v_l, ok_l = u.tolist(), v.tolist(), valid.tolist()
    parts = [p] * B
    for j in range(B):
        if not ok_l[j]:
            continue  # pads are scored but commit nothing: skip the scoring
        if balance == "static":
            norm = inv_e
        else:
            norm = one / (eps + (e_c.max() - e_c.min()))
        if wu is not None:
            gain = wu[j] * mu[:, j] + wv[j] * mv[:, j]
        else:
            gain = mu[:, j] + mv[:, j]
        score = fma_f32(cv * v_c, inv_v, fma_f32(ce * e_c, norm, gain))
        i = int(torch.argmin(score))  # first minimum: ties -> lowest id
        parts[j] = i
        e_c[i] += 1.0
        v_c[i] += mu[i, j] + mv[i, j]
        uu, vv = u_l[j], v_l[j]
        kb[i, uu >> 5] |= _bit(uu & 31)
        kb[i, vv >> 5] |= _bit(vv & 31)  # after u's: they may share a word
        if window:
            hit_u = (u == uu) | (u == vv)
            hit_v = (v == uu) | (v == vv)
            mu[i] = torch.where(hit_u, 0.0, mu[i])
            mv[i] = torch.where(hit_v, 0.0, mv[i])
    parts_t = torch.tensor(parts, dtype=torch.int32, device=u.device)
    return kb, e_c, v_c, parts_t


def _check_args(keep_bits, e_count, v_count, u, v, valid, coef, wu, wv, balance, n):
    if balance not in BALANCE_MODES:
        raise ValueError(f"balance must be one of {BALANCE_MODES}, got {balance!r}")
    if (wu is None) != (wv is None):
        raise ValueError("wu and wv must be given together")
    if keep_bits.ndim != 2:
        raise ValueError(f"keep_bits must be [p, words], got shape {tuple(keep_bits.shape)}")
    p, vw = keep_bits.shape
    dev = keep_bits.device
    check_tensor("keep_bits", keep_bits, torch.int32, (p, vw), dev)
    check_tensor("e_count", e_count, torch.float32, (p,), dev)
    check_tensor("v_count", v_count, torch.float32, (p,), dev)
    check_tensor("u", u, torch.int32, (n,), dev)
    check_tensor("v", v, torch.int32, (n,), dev)
    check_tensor("valid", valid, torch.bool, (n,), dev)
    check_tensor("coef", coef, torch.float32, (5,), dev)
    if wu is not None:
        check_tensor("wu", wu, torch.float32, (n,), dev)
        check_tensor("wv", wv, torch.float32, (n,), dev)
    return p, vw


def _launch_cuda(keep_bits, e_count, v_count, u, v, valid, coef, wu, wv, parts, *,
                 p, vw, block, nblocks, balance, window, keep_out):
    """Transpose the bitset, walk the blocks on it, and transpose it back
    into `keep_out` (which may be `keep_bits`)."""
    check_ids(("u", u, 32 * vw), ("v", v, 32 * vw))
    memb = keep_bits_to_memb(keep_bits)
    weighted = wu is not None
    # Shapes whose per-edge staging does not fit in shared memory stage it
    # in a global workspace (the kernel says how much it needs).
    ws_bytes = c_function("ebg_commit", "ebg_commit_workspace_bytes", [ctypes.c_int] * 3,
                          ctypes.c_longlong)(p, block, int(weighted))
    ws = (torch.empty(((ws_bytes + 15) // 16, 4), dtype=torch.int32, device=memb.device)
          if ws_bytes else None)
    fn = c_function("ebg_commit", "ebg_commit_launch",
                    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    err = fn(
        memb.data_ptr(), e_count.data_ptr(), v_count.data_ptr(),
        u.data_ptr(), v.data_ptr(), valid.data_ptr(),
        wu.data_ptr() if weighted else None, wv.data_ptr() if weighted else None,
        coef.data_ptr(), parts.data_ptr(), None if ws is None else ws.data_ptr(),
        p, block, nblocks, int(balance == "range"), int(weighted), int(window),
        cuda_stream_handle(),
    )
    check_launch("ebg_commit", err)
    LAUNCHES["ebg_commit"] += 1
    return memb_to_keep_bits(memb, p, out=keep_out)


def ebg_commit_block(
    keep_bits, e_count, v_count, u, v, valid, coef, *,
    balance: str = "static", wu=None, wv=None, window: bool = False,
):
    """One block of B edges; returns new (keep_bits, e_count, v_count, parts)
    [parts: B int32] and leaves its inputs as they were."""
    B = u.shape[0]
    p, vw = _check_args(keep_bits, e_count, v_count, u, v, valid, coef, wu, wv, balance, B)
    dev = keep_bits.device
    if dev.type == "cpu":
        return ebg_commit_block_plain(
            keep_bits, e_count, v_count, u, v, valid, coef,
            balance=balance, wu=wu, wv=wv, window=window,
        )
    if dev.type != "cuda":
        raise ValueError(f"ebg_commit_block runs on CPU or CUDA tensors, got {dev}")
    e_c, v_c = e_count.clone(), v_count.clone()
    parts = torch.empty((B,), dtype=torch.int32, device=dev)
    kb = _launch_cuda(keep_bits, e_c, v_c, u, v, valid, coef, wu, wv, parts, p=p, vw=vw,
                      block=B, nblocks=1, balance=balance, window=window, keep_out=None)
    return kb, e_c, v_c, parts


def ebg_commit_stream(
    keep_bits, e_count, v_count, u, v, valid, coef, *, block: int,
    balance: str = "static", wu=None, wv=None, window: bool = False,
) -> torch.Tensor:
    """Every block of a stream of nblocks·block edges, in order, updating
    keep_bits/e_count/v_count IN PLACE; returns parts [nblocks·block] int32.
    The CUDA path walks them all in one launch; its result equals
    `ebg_commit_block` applied block after block."""
    n = u.shape[0]
    if block < 1 or n % block:
        raise ValueError(f"stream length {n} is not a multiple of block={block}")
    p, vw = _check_args(keep_bits, e_count, v_count, u, v, valid, coef, wu, wv, balance, n)
    dev = keep_bits.device
    parts = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return parts
    if dev.type == "cpu":
        for lo in range(0, n, block):
            hi = lo + block
            kb, e_c, v_c, parts[lo:hi] = ebg_commit_block_plain(
                keep_bits, e_count, v_count, u[lo:hi], v[lo:hi], valid[lo:hi], coef,
                balance=balance, window=window,
                wu=None if wu is None else wu[lo:hi], wv=None if wv is None else wv[lo:hi],
            )
            keep_bits.copy_(kb)
            e_count.copy_(e_c)
            v_count.copy_(v_c)
        return parts
    if dev.type != "cuda":
        raise ValueError(f"ebg_commit_stream runs on CPU or CUDA tensors, got {dev}")
    _launch_cuda(keep_bits, e_count, v_count, u, v, valid, coef, wu, wv, parts, p=p, vw=vw,
                 block=block, nblocks=n // block, balance=balance, window=window,
                 keep_out=keep_bits)
    return parts
