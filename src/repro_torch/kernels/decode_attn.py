"""Single-token grouped-query attention over a KV cache (flash decode): the
CUDA kernel `csrc/decode_attn.cu` and its plain PyTorch version.

Port of the TPU kernel `repro.kernels.decode_attn.decode_attention_pallas`
(oracle `repro.kernels.ref.decode_attention_ref`). Inputs are q [B, Hq, D]
and k, v [B, S, Hkv, D], with Hq a multiple of Hkv, all f32, all bf16, or
q in f32 over a bf16 k and v (the TPU kernel casts each input to f32 on
its own; an f32 model decodes over a bf16 cache so). Query head h·G + g
(G = Hq/Hkv) attends over kv head h, at keys [start, end) of k and v
(default: all S), which the kernel reads in place: the decode step hands
it the whole preallocated cache and the range written so far. The scores
are q·k/√D, capped as softcap·tanh(s/softcap) when softcap is non-zero; the
softmax and the weighted sum of v are taken in f32, and the result
[B, Hq, D] is cast to q's dtype.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches a
kernel, and anything else raises. head_dim 1 to 512 runs on
`csrc/decode_attn.cu` (a width outside HEAD_DIMS runs on the next one up,
its rows zero-padded in shared memory), which splits S across CTAs
(`split_count`) and merges the splits' partial states in a second launch
on the same stream. A wider head_dim runs on `csrc/decode_attn_wide.cu`
(`kernel_source`), also split-S with a merge launch, but over rows of
1 KB and more: a split's keys (whole tiles of WIDE_TILE_KEYS, at most
WIDE_MAX_TILES tiles: `wide_split_count`) are read K first, then V, in
2 KB slices of a row, through a ring of `wide_stages` stages; no size is
refused. Each call counts once in `LAUNCHES` as "decode_attention".

The wrapper calls the custom op `torch.ops.repro_torch.decode_attention`
(`torch.library.custom_op`), whose implementation is the dispatch above;
on plain tensors with no dispatch mode active it calls that implementation
itself and skips the op's own dispatch. Through the op, it also takes what
a ctypes call cannot: fake tensors (its
`register_fake`: an output shaped as q, in q's dtype), a `FlopCounterMode`
(4·B·Hq·(end − start)·D: the two products), and DTensors, through its
sharding rule (`_sharding`): the batch over any mesh dimension, or the kv
heads with the query heads following them (query head h·G + g sits with
kv head h, so a contiguous split of Hq matches one of Hkv when Hkv divides
evenly: `_whole_head_groups` drops every layout whose head shards do not).
Any other layout (a cache sharded on its sequence dim, heads that do not
divide) is gathered to one of those first, by DTensor, as a collective of
the run.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch.kernels.dispatch import (
    LAUNCHES,
    c_function,
    check_launch,
    check_tensor,
    cuda_stream_handle,
)

# (q's dtype, k's and v's dtype) → the C entry's dtype code.
DTYPE_CODES = {(torch.float32, torch.float32): 0, (torch.bfloat16, torch.bfloat16): 1,
               (torch.float32, torch.bfloat16): 2}
HEAD_DIMS = (32, 64, 128, 256, 512)  # the CUDA kernel's builds: 16-byte chunks, four warps a row
SPLIT_KEYS = 1024  # a split streams at most this many keys ...
WAVE_CTAS = 2 * 3  # ... and the grid fills at least two waves of three CTAs an SM
MAX_SPLITS = 1024
# decode_attn_wide.cu's shape (its k-prefixed constants): items of 16 keys
# × a 2 KB slice of a row (rows padded by 16 bytes), splits of at most 32
# such tiles, a CTA an SM wanted, 2 to 6 stages a ring.
WIDE_TILE_KEYS = 16
WIDE_MAX_TILES = 32
WIDE_SLICE_BYTES = 2048
WIDE_STAGE_BYTES = WIDE_TILE_KEYS * (WIDE_SLICE_BYTES + 16)
WIDE_WAVE_CTAS = 1
WIDE_STAGES = (2, 6)
H100_SMEM_OPTIN = 232_448  # an H100's cudaDevAttrMaxSharedMemoryPerBlockOptin


def kernel_source(D: int) -> str:
    """The CUDA source a head_dim D runs on: `decode_attn` (the split-S
    flash kernel) up to HEAD_DIMS[-1], `decode_attn_wide` above."""
    return "decode_attn" if D <= HEAD_DIMS[-1] else "decode_attn_wide"


def padded_dim(D: int) -> int:
    """The built width of `decode_attn.cu` a head_dim D runs at: the least
    of HEAD_DIMS >= D (a wider D runs on `decode_attn_wide.cu`)."""
    for width in HEAD_DIMS:
        if D <= width:
            return width
    raise ValueError(f"decode_attn.cu's builds take head_dim up to {HEAD_DIMS[-1]}, got {D}; "
                     f"wider rows run on decode_attn_wide.cu")


def tile_keys(D: int, dtype: torch.dtype) -> int:
    """Keys a tile of the kernel's ring (`Shape<T, D, TK>::TK` in the
    source, at the padded width): rows under 512 bytes take 64-key tiles,
    longer rows 32, and rows of 2 KB (f32 at 512) 16: the most keys a stage
    whose CTA fits the 227 KB an H100 gives a block, which the kernel reads
    from the card (`pick_tk`)."""
    row = padded_dim(D) * torch.finfo(dtype).bits // 8
    return 64 if row < 512 else 32 if row < 2048 else 16


def split_count(B: int, S: int, Hkv: int, G: int, sms: int, tile: int = 64) -> int:
    """How many ranges of S the kernel splits the cache into: ranges of at
    most SPLIT_KEYS keys, and enough CTAs for WAVE_CTAS per SM, in whole
    tiles of `tile` keys and at most MAX_SPLITS."""
    rows = B * Hkv * -(-G // group_rows(G))
    tiles = -(-S // tile)
    want = max(-(-S // SPLIT_KEYS), -(-WAVE_CTAS * sms // rows))
    per = -(-tiles // min(want, tiles, MAX_SPLITS))  # tiles a split
    return -(-tiles // per)


def group_rows(G: int) -> int:
    """Query rows a CTA of either kernel takes: the least power of two >= G,
    at most 8."""
    return min(8, 1 << (G - 1).bit_length())


def wide_split_count(B: int, S: int, Hkv: int, G: int, sms: int) -> int:
    """How many ranges of S `decode_attn_wide.cu` splits the keys into:
    whole tiles of WIDE_TILE_KEYS, at most WIDE_MAX_TILES tiles a split (a
    split's scores sit in shared memory), and enough CTAs for
    WIDE_WAVE_CTAS per SM. The kernel re-derives the same count."""
    rows = B * Hkv * -(-G // group_rows(G))
    tiles = -(-S // WIDE_TILE_KEYS)
    want = max(-(-tiles // WIDE_MAX_TILES), -(-WIDE_WAVE_CTAS * sms // rows))
    per = -(-tiles // min(want, tiles))  # tiles a split
    return -(-tiles // per)


def wide_stages(G: int, dtype: torch.dtype, optin: int = H100_SMEM_OPTIN) -> int:
    """Stages of `decode_attn_wide.cu`'s ring for a cache of `dtype` (its
    `pick_stages`): the most, 2 to 6, with which a CTA fits the shared
    memory a block may take (the kernel reads the card's); 0 if two do not."""
    gc, esize = group_rows(G), torch.finfo(dtype).bits // 8
    # full and empty barriers; a row's q slice in f32, two items' score sums
    # of two warps, the scores, (m, l)
    fixed = 16 * WIDE_STAGES[1] + gc * (WIDE_SLICE_BYTES // esize * 4 + 16 * WIDE_TILE_KEYS
                                        + 4 * WIDE_MAX_TILES * WIDE_TILE_KEYS + 8)
    for n in range(WIDE_STAGES[1], WIDE_STAGES[0] - 1, -1):
        if fixed + n * WIDE_STAGE_BYTES <= optin:
            return n
    return 0


def wide_workspace_floats(B: int, Hkv: int, G: int, D: int, nsplit: int) -> int:
    """f32 workspace of a `decode_attn_wide.cu` launch (its
    `decode_attn_wide_workspace`): each split's unnormalised [D] row and
    (m, l) for every query head; none for one split."""
    return 0 if nsplit <= 1 else B * Hkv * G * nsplit * (D + 2)


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


def decode_attention(q, k, v, *, softcap: float = 0.0, start: int = 0, end=None):
    """[B, Hq, D] attention output over keys [start, end) of k and v (end
    None: S); see the module docstring."""
    if q.ndim != 3 or k.ndim != 4:
        raise ValueError(f"q must be [B, Hq, D] and k [B, S, Hkv, D], got {tuple(q.shape)} "
                         f"and {tuple(k.shape)}")
    (B, Hq, D), (S, Hkv) = q.shape, k.shape[1:3]
    if (q.dtype, k.dtype) not in DTYPE_CODES:
        raise TypeError(f"decode_attention takes f32 or bf16 (q, k and v of one dtype, or q "
                        f"f32 over bf16 k and v); got q {q.dtype}, k {k.dtype}")
    end = S if end is None else int(end)
    start = int(start)
    if not 0 <= start < end <= S or Hkv < 1 or Hq % Hkv:
        raise ValueError(f"need 0 <= start < end <= S and Hq % Hkv == 0, got start={start}, "
                         f"end={end}, S={S}, Hq={Hq}, Hkv={Hkv}")
    dev = q.device
    check_tensor("q", q, q.dtype, (B, Hq, D), dev)
    check_tensor("k", k, k.dtype, (B, S, Hkv, D), dev)
    check_tensor("v", v, k.dtype, (B, S, Hkv, D), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_attention runs on CPU or CUDA tensors, got {dev}")
    if type(q) is torch.Tensor and _get_current_dispatch_mode() is None:
        # Plain tensors and no dispatch mode: the op's body without the op's
        # dispatch (tens of µs a call, on a decode step bound by the host).
        return _decode_attention_impl(q, k, v, float(softcap), start, end)
    return torch.ops.repro_torch.decode_attention(q, k, v, float(softcap), start, end)


def _decode_attention_impl(q, k, v, softcap: float, start: int, end: int) -> torch.Tensor:
    """The op on checked arguments: the plain version on the CPU, the CUDA
    kernel on the card."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k[:, start:end], v[:, start:end], softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on CPU or CUDA tensors, got {q.device}")
    return _decode_attention_cuda(q, k, v, softcap, start, end)


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def _decode_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, softcap: float,
                         start: int, end: int) -> torch.Tensor:
    return _decode_attention_impl(q, k, v, softcap, start, end)


@_decode_attention_op.register_fake
def _(q, k, v, softcap, start, end):
    return torch.empty_like(q)


def _flops(q_shape, k_shape, v_shape, softcap, start, end, *args, **kwargs) -> int:
    """q·k and the weighted sum of v: 2 operations each a key, head and dim."""
    B, Hq, D = q_shape
    return 4 * B * Hq * (end - start) * D


def _sharding(q, k, v, softcap, start, end):
    """The layouts the op runs on unchanged, one mesh dimension at a time:
    all replicated; the batch sharded; or the kv heads sharded (dim 2 of k
    and v) with the query heads (dim 1 of q) following them."""
    from torch.distributed.tensor import Replicate, Shard

    rest = [None, None, None]
    return [([Replicate()], [Replicate()] * 3 + rest),
            ([Shard(0)], [Shard(0)] * 3 + rest),
            ([Shard(1)], [Shard(1), Shard(2), Shard(2)] + rest)]


def _whole_head_groups(expand, op_schema):
    """`expand`'s layouts (`_sharding` over every mesh dimension) less
    those that split the kv heads unevenly. DTensor cuts an uneven dim in
    chunks of ceil(H/n), and ceil(G·Hkv/n) ≠ G·ceil(Hkv/n) then (Hkv 6 and
    Hq 12 over 4: kv chunks of 2, query chunks of 3), so a rank's query
    heads would not be those of its kv heads. Kept: Hkv divisible by the
    product of the mesh dims its heads are split over."""
    from torch.distributed.tensor import Shard

    strategy = expand(op_schema)
    hkv = op_schema.args_schema[1].shape[2]

    def whole(spec) -> bool:
        return hkv % math.prod(spec.mesh.size(i) for i, p in enumerate(spec.placements)
                               if p == Shard(2)) == 0

    strategy.strategies = [s for s in strategy.strategies if whole(s.input_specs[1])]
    return strategy


def _register() -> None:
    from torch.utils.flop_counter import register_flop_formula

    op = torch.ops.repro_torch.decode_attention
    register_flop_formula(op)(_flops)
    try:
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import register_sharding
    except ImportError:  # a PyTorch built without distributed
        return
    register_sharding(op.default)(_sharding)
    # register_sharding expands `_sharding` to every mesh dimension on its
    # own; the filter that keeps head groups whole wraps that expansion.
    funcs = DTensor._op_dispatcher.sharding_propagator.op_strategy_funcs
    funcs[op.default] = functools.partial(_whole_head_groups, funcs[op.default])


_register()


def _decode_attention_cuda(q, k, v, softcap, start, end):
    """The CUDA launch of `csrc/decode_attn.cu` (or the wide source), on
    checked arguments."""
    (B, Hq, D), (S, Hkv) = q.shape, k.shape[1:3]
    dev = q.device
    G = Hq // Hkv
    if kernel_source(D) == "decode_attn_wide":
        return _decode_attention_wide(q, k, v, softcap, start, end)
    nsplit = split_count(B, end - start, Hkv, G, _sm_count(dev), tile_keys(D, k.dtype))
    workspace = c_function("decode_attn", "decode_attn_workspace", [ctypes.c_int] * 5,
                           ctypes.c_longlong)(B, Hkv, G, D, nsplit)
    ws = torch.empty((max(workspace, 1),), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    fn = c_function("decode_attn", "decode_attn_launch",
                    [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 8
                    + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ws.data_ptr(),
             ws.numel(), B, S, start, end, Hkv, G, D, DTYPE_CODES[q.dtype, k.dtype],
             1.0 / math.sqrt(D), float(softcap), nsplit, cuda_stream_handle())
    check_launch("decode_attn", err)
    LAUNCHES["decode_attention"] += 1
    return out


def _decode_attention_wide(q, k, v, softcap, start, end):
    """The CUDA launch of `csrc/decode_attn_wide.cu` (head_dim above 512),
    on checked arguments."""
    (B, Hq, D), (S, Hkv) = q.shape, k.shape[1:3]
    G = Hq // Hkv
    nsplit = wide_split_count(B, end - start, Hkv, G, _sm_count(q.device))
    workspace = c_function("decode_attn_wide", "decode_attn_wide_workspace", [ctypes.c_int] * 5,
                           ctypes.c_longlong)(B, Hkv, G, D, nsplit)
    ws = torch.empty((max(workspace, 1),), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    fn = c_function("decode_attn_wide", "decode_attn_wide_launch",
                    [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 8
                    + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ws.data_ptr(),
             ws.numel(), B, S, start, end, Hkv, G, D, DTYPE_CODES[q.dtype, k.dtype],
             1.0 / math.sqrt(D), float(softcap), nsplit, cuda_stream_handle())
    check_launch("decode_attn_wide", err)
    LAUNCHES["decode_attention"] += 1
    return out
