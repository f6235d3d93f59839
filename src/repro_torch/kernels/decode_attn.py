"""Single-token grouped-query attention over a KV cache (flash decode): the
CUDA kernel `csrc/decode_attn.cu` and its plain PyTorch version.

Port of the TPU kernel `repro.kernels.decode_attn.decode_attention_pallas`
(oracle `repro.kernels.ref.decode_attention_ref`). Inputs are q [B, Hq, D]
and k, v [B, S, Hkv, D], all f32 or all bf16, with Hq a multiple of Hkv;
query head h·G + g (G = Hq/Hkv) attends over kv head h. The scores are
q·k/√D, capped as softcap·tanh(s/softcap) when softcap is non-zero; the
softmax and the weighted sum of v are taken in f32, and the result
[B, Hq, D] is cast to q's dtype.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel (head_dim 1 to 256: a width outside HEAD_DIMS runs on the next one
up, its rows zero-padded in shared memory), and anything else raises. The kernel
splits S across CTAs (`split_count`) and merges the splits' partial states
in a second launch on the same stream; each call counts once in `LAUNCHES`
as "decode_attention".
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.dispatch import (
    LAUNCHES,
    c_function,
    check_launch,
    check_tensor,
    cuda_stream_handle,
)

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64, 128, 256)  # the CUDA kernel's builds: 16-byte chunks, four warps a row
SPLIT_KEYS = 1024  # a split streams at most this many keys ...
WAVE_CTAS = 2 * 3  # ... and the grid fills at least two waves of three CTAs an SM
MAX_SPLITS = 1024


def padded_dim(D: int) -> int:
    """The built width a head_dim D runs at: the least of HEAD_DIMS >= D."""
    for width in HEAD_DIMS:
        if D <= width:
            return width
    raise ValueError(f"the CUDA kernel takes head_dim up to {HEAD_DIMS[-1]}, got {D}")


def tile_keys(D: int, dtype: torch.dtype) -> int:
    """Keys a tile of the kernel's ring (`Shape<T, D>::TK` in the source, at
    the padded width): rows of 512 bytes or more take 32-key tiles, shorter
    rows 64."""
    return 32 if padded_dim(D) * torch.finfo(dtype).bits // 8 >= 512 else 64


def split_count(B: int, S: int, Hkv: int, G: int, sms: int, tile: int = 64) -> int:
    """How many ranges of S the kernel splits the cache into: ranges of at
    most SPLIT_KEYS keys, and enough CTAs for WAVE_CTAS per SM, in whole
    tiles of `tile` keys and at most MAX_SPLITS."""
    gc = min(8, 1 << (G - 1).bit_length())  # query rows a CTA (the kernel's rule)
    rows = B * Hkv * -(-G // gc)
    tiles = -(-S // tile)
    want = max(-(-S // SPLIT_KEYS), -(-WAVE_CTAS * sms // rows))
    per = -(-tiles // min(want, tiles, MAX_SPLITS))  # tiles a split
    return -(-tiles // per)


_SMS: dict = {}


def _sm_count(dev: torch.device) -> int:
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


def decode_attention_plain(q, k, v, *, softcap: float = 0.0):
    """Plain PyTorch version (any device), term for term the reference
    oracle: f32 einsum, optional tanh cap, softmax, f32 einsum, cast."""
    B, Hq, D = q.shape
    Hkv = k.shape[2]
    qf = q.float().reshape(B, Hkv, Hq // Hkv, D)
    scores = torch.einsum("bhgd,bshd->bhgs", qf, k.float()) / math.sqrt(D)
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", w, v.float())
    return out.reshape(B, Hq, D).to(q.dtype)


def decode_attention(q, k, v, *, softcap: float = 0.0):
    """[B, Hq, D] attention output; see the module docstring."""
    if q.ndim != 3 or k.ndim != 4:
        raise ValueError(f"q must be [B, Hq, D] and k [B, S, Hkv, D], got {tuple(q.shape)} "
                         f"and {tuple(k.shape)}")
    (B, Hq, D), (S, Hkv) = q.shape, k.shape[1:3]
    if q.dtype not in DTYPES:
        raise TypeError(f"decode_attention takes f32 or bf16, got {q.dtype}")
    if S < 1 or Hkv < 1 or Hq % Hkv:
        raise ValueError(f"need S >= 1 and Hq % Hkv == 0, got S={S}, Hq={Hq}, Hkv={Hkv}")
    dev = q.device
    check_tensor("q", q, q.dtype, (B, Hq, D), dev)
    check_tensor("k", k, q.dtype, (B, S, Hkv, D), dev)
    check_tensor("v", v, q.dtype, (B, S, Hkv, D), dev)
    if dev.type == "cpu":
        return decode_attention_plain(q, k, v, softcap=softcap)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention runs on CPU or CUDA tensors, got {dev}")
    padded_dim(D)  # raises above 256
    G = Hq // Hkv
    nsplit = split_count(B, S, Hkv, G, _sm_count(dev), tile_keys(D, q.dtype))
    workspace = c_function("decode_attn", "decode_attn_workspace", [ctypes.c_int] * 5,
                           ctypes.c_longlong)(B, Hkv, G, D, nsplit)
    ws = torch.empty((max(workspace, 1),), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    fn = c_function("decode_attn", "decode_attn_launch",
                    [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 6
                    + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ws.data_ptr(),
             ws.numel(), B, S, Hkv, G, D, DTYPES.index(q.dtype), 1.0 / math.sqrt(D),
             float(softcap), nsplit, cuda_stream_handle())
    check_launch("decode_attn", err)
    LAUNCHES["decode_attention"] += 1
    return out
