"""Public entry points of the port's kernels (port of `repro.kernels.ops`).

Each entry dispatches on the device of its tensors through the kernel
wrappers (CPU: the plain PyTorch version; CUDA: the hand-written kernel)
and owns the conventions around the kernel: the superstep's padding to a
multiple of `block_e` at the dump slot, `max` as negated `min`, and the
commit's coefficient vector.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import bsp_superstep as _bsp
from repro_torch.kernels import decode_attn as _attn
from repro_torch.kernels import ebg_commit as _ebg
from repro_torch.kernels import ebg_score as _memb
from repro_torch.kernels import segment_reduce as _seg

INF = _bsp.INF


def pad_stream(lsrc, ldst, weight, *, num_out: int, block_e: int, identity: float):
    """Pad every worker's [p, E] stream to a multiple of block_e with no-op
    edges at the dump slot num_out-1 (which keeps dst-sortedness) carrying
    the reduction identity as weight."""
    p, E = lsrc.shape
    block_e = max(min(block_e, E), 1)
    pad = (-E) % block_e
    if not pad:
        return lsrc, ldst, weight
    dev = lsrc.device
    lsrc = torch.cat([lsrc, torch.zeros((p, pad), dtype=lsrc.dtype, device=dev)], dim=1)
    ldst = torch.cat([ldst, torch.full((p, pad), num_out - 1, dtype=ldst.dtype, device=dev)], dim=1)
    weight = torch.cat([weight, torch.full((p, pad), identity, dtype=weight.dtype, device=dev)],
                       dim=1)
    return lsrc, ldst, weight


def segment_min_plus(lsrc, ldst, weight, val, *, num_out: int, block_e: int = 512):
    """out[d] = min(val[d], min over edges into d of val[src] + w), over an
    [E] stream of dst-sorted edges; pads must carry weight INF. `block_e` is
    the TPU grid's edge block: the kernel takes any E, so nothing is padded."""
    del block_e
    return _seg.segment_reduce(lsrc, ldst, weight, val, num_out=num_out, op="min")


def segment_sum_scaled(lsrc, ldst, scale, val, *, num_out: int, block_e: int = 512):
    """out[d] = sum over edges into d of val[src] * scale; pads carry scale 0.
    `block_e` is ignored, as in `segment_min_plus`."""
    del block_e
    return _seg.segment_reduce(lsrc, ldst, scale, val, num_out=num_out, op="sum")


def segment_max(lsrc, ldst, weight, val, *, num_out: int, block_e: int = 512):
    """out[d] = max(val[d], max over edges into d of val[src]), on the min
    kernel through negation: `weight` is the pad carrier only (real edges
    hold 0, pads INF). `block_e` is ignored, as in `segment_min_plus`."""
    return -segment_min_plus(lsrc, ldst, weight, -val, num_out=num_out, block_e=block_e)


def bsp_superstep(lsrc, ldst, weight, val, *, num_out: int, combine: str = "min",
                  inner_cap: int = 1, out_degree=None, block_e: int = 512, err=None, live=None):
    """Whole-local-stage BSP superstep for a batch of workers.

    combine="min" iterates the min-plus relaxation to local convergence
    (capped at `inner_cap`; pads carry weight INF); combine="max" runs on
    the same kernel via negation (`weight` is then the pad carrier only:
    real edges hold 0, pads INF); combine="sum" is one out-degree-normalized
    push-sum sweep (pads carry weight 0; `out_degree` [p, num_out] f32).
    An id outside [0, num_out) raises ValueError; with `err` (a zeroed
    int32 [1] tensor on the stream's device) the kernel ORs its id guard's
    bits into it instead, for the caller to read when it syncs
    (`bsp_superstep.check_flag`). `val` may hold a batch's B·p rows, row r
    on stream row r % p; `live` (min and max: a bool [B]) leaves the rows
    of a query that is not live as they are, with 0 iterations.
    Returns (new_val [R, num_out] f32, per-worker inner iterations [R] int32).
    """
    if combine not in ("min", "max", "sum"):
        raise ValueError(f"combine must be 'min', 'max' or 'sum', got {combine!r}")
    if combine == "max":
        out, iters = bsp_superstep(lsrc, ldst, weight, -val, num_out=num_out, combine="min",
                                   inner_cap=inner_cap, block_e=block_e, err=err, live=live)
        return -out, iters
    if (combine == "sum") != (out_degree is not None):
        raise ValueError("out_degree is required for combine='sum' and only then")
    identity = 0.0 if combine == "sum" else INF
    lsrc, ldst, weight = pad_stream(lsrc, ldst, weight, num_out=num_out, block_e=block_e,
                                    identity=identity)
    kw = dict(num_out=num_out, combine=combine, inner_cap=inner_cap, out_degree=out_degree,
              live=live)
    if err is None:
        return _bsp.bsp_superstep(lsrc, ldst, weight, val, **kw)
    return _bsp.launch_flagged(lsrc, ldst, weight, val, err=err, **kw)


def commit_coefficients(*, alpha, beta, inv_e, inv_v, eps, device) -> torch.Tensor:
    """The commit kernel's [5] f32 coefficient vector (ce, cv, inv_e, inv_v,
    eps). inv_e/inv_v should be computed in f32 by the caller
    (float32(p) / float32(E)), as the reference does."""
    coef = np.array([alpha, beta, inv_e, inv_v, eps], dtype=np.float32)
    return torch.from_numpy(coef).to(device)


def ebg_membership(keep_bits, u, v, *, block_e: int = 512):
    """memb[i, e] = the endpoints of edge e absent from keep[i] (packed
    bitset). `block_e` is the TPU grid's edge block: the CUDA kernel takes
    any E, so nothing is padded."""
    del block_e
    return _memb.ebg_membership(keep_bits, u, v)


def decode_attention(q, k, v, *, softcap: float = 0.0, block_s: int = 512):
    """Single-token GQA decode attention over a KV cache. `block_s` is the
    TPU grid's S block: the CUDA kernel streams S in its own chunks."""
    del block_s
    return _attn.decode_attention(q, k, v, softcap=softcap)


def ebg_commit_block(
    keep_bits, e_count, v_count, u, v, valid, *,
    alpha, beta, inv_e, inv_v, eps=1.0, balance: str = "static",
    wu=None, wv=None, window: bool = False,
):
    """Fused streaming-scorer block commit: membership score + argmin + exact
    balance commit + bitset update for one block of edges. alpha/beta are
    the generic edge/vertex balance coefficients (HDRF's lambda is alpha
    with beta=0), `balance` selects the edge-balance normalizer, wu/wv
    optionally weight the membership term per edge. Returns new
    (keep_bits, e_count, v_count, parts); pad edges get part p."""
    if (wu is None) != (wv is None):
        raise ValueError("wu and wv must be given together")
    coef = commit_coefficients(alpha=alpha, beta=beta, inv_e=inv_e, inv_v=inv_v, eps=eps,
                               device=keep_bits.device)
    # Unweighted scorers pass no weight streams: the kernel is specialised
    # on `weighted` and reads none (the TPU kernel took zero streams).
    return _ebg.ebg_commit_block(
        keep_bits, e_count, v_count, u, v, valid, coef, balance=balance,
        wu=wu, wv=wv, window=window,
    )


# [p, V] bool -> [p, ceil(V/32)] packed bitset in int32 words.
pack_keep_bits = _ebg.pack_keep_bits
