"""Mixture-of-Experts FFN with capacity-based sorted dispatch (port of
`repro.models.moe`).

Dispatch is the sort-and-segment pattern (no [T, E, C] one-hot tensors):
each token's top-k assignments are sorted by expert (a stable sort, as
`jnp.argsort` is, so the capacity drop keeps the same first `cap`
assignments of an expert), ranked within their expert, capacity-dropped,
added into an [E, cap, d] buffer, run through the grouped SwiGLU as three
batched products (`torch.bmm`: the reference computes them outside any
Pallas kernel, as `jnp.einsum`), and combined back with the router's
gates. Dropped rows add zeros at rank 0 (`index_put_(accumulate=True)`);
the combine is `index_add_`, so with top_k > 2 the order of a token's
contributions, and on the card their bf16 rounding, is not fixed. On
DTensors (a sharded run, `pspec.activation_axes`) both run out of place
on buffers made replicated on the mesh (`_zeros`), and the expert buffer
and the output take the reference's constraints.

The capacity depends on the token count T: cap = max(8, ⌈T·k/E·cf⌉₈). A
prefill or a full forward at capacity_factor 1.25 may drop assignments
that a decode step (T = B) keeps; that is the reference's semantics.

`expert_perm` (from `repro_torch.core.placement.ebg_expert_placement`)
renames expert e to slot perm[e] after the router, so that the contiguous
expert-parallel sharding of the weights realizes a placement; expert e's
weights then sit at slot perm[e].

`moe_ffn_ep` is the expert-parallel dispatch over a `torch.distributed`
process group of w ranks (the reference's shard_map over the mesh's model
axis; on DTensors under `pspec.ep_shard_map()`, the plan `ep`,
`_moe_ffn_ep_dtensor` hands it the local shards): tokens are replicated,
each rank holds E/w experts (`shard_experts`), sends every other rank's
assignments to a dump bucket, and the partial outputs [T, d] are added by
one `all_reduce` (the reference's `psum`). With no group it is `moe_ffn`,
as the reference falls back off-mesh.

Under autograd `moe_ffn_ep` differentiates as the reference's shard_map
does: the tokens and the router are replicated, so each rank's gradient
of them is a partial that the ranks sum (`_SumGrads`: identity forward,
an `all_reduce` of the gradient backward), and the output is replicated,
so the `all_reduce` that sums the partial outputs hands each rank the
output's gradient unchanged (`_SumOutputs`). Every rank then holds the
single-process gradients: the router's, the input's and its own
experts'. (A sum-backward `all_reduce` on the output alone would scale
the experts' gradients by w and leave the router's and the input's
partial.)
"""
from __future__ import annotations

import types
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch.models import pspec
from repro_torch.models.config import ModelConfig
from repro_torch.models.pspec import constrain


class MoE(nn.Module):
    """A MoE layer's parameters, in the reference's layouts: `router` [d, E]
    (always f32), `w_gate`, `w_in` [E, d, f] and `w_out` [E, f, d]."""

    def __init__(self, cfg: ModelConfig, *, num_experts: Optional[int] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        m = cfg.moe
        d, f = cfg.d_model, m.d_ff
        E = num_experts or m.num_experts

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.zeros(shape, device=device, dtype=dt), requires_grad=False)

        self.router = param(d, m.num_experts, dt=torch.float32)
        self.w_gate = param(E, d, f)
        self.w_in = param(E, d, f)
        self.w_out = param(E, f, d)


def capacity(cfg: ModelConfig, num_tokens: int) -> int:
    """Rows an expert's buffer takes for T tokens: T·k/E·cf, rounded up to
    a multiple of 8, at least 8."""
    m = cfg.moe
    cap = int(num_tokens * m.top_k / m.num_experts * m.capacity_factor)
    return max(8, -(-cap // 8) * 8)


def route(cfg: ModelConfig, router: torch.Tensor, xf: torch.Tensor):
    """The router over tokens xf [T, d]: (logits [T, E] f32, gates [T, k]
    f32, expert ids [T, k] in descending logit order). The f32 router is
    cast to x's type for the product, the logits back to f32."""
    logits = (xf @ router.to(xf.dtype)).float()
    gate_logits, expert_idx = torch.topk(logits, cfg.moe.top_k, dim=-1, sorted=True)
    return logits, torch.softmax(gate_logits, dim=-1), expert_idx


def _experts(buf, w_gate, w_in, w_out):
    """The grouped SwiGLU over [E, cap, d] buffers."""
    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_in)
    return torch.bmm(h, w_out)


def _zeros(like: torch.Tensor, shape: tuple) -> torch.Tensor:
    """Zeros of `shape` in like's dtype, on its device, or, for a DTensor,
    a replicated DTensor on its mesh (the buffers the dispatch scatters
    into and the combine adds into)."""
    if not pspec.is_dtensor(like):
        return torch.zeros(shape, dtype=like.dtype, device=like.device)
    from torch.distributed.tensor import Replicate, zeros

    mesh = like.device_mesh
    return zeros(shape, dtype=like.dtype, device_mesh=mesh, placements=[Replicate()] * mesh.ndim)


def _dispatch_combine(xf, gates, sorted_e, order, keep, rank, k, cap, w_gate, w_in, w_out):
    """Scatter the kept assignments (in `order`, expert `sorted_e`, row
    `rank`) into the experts' buffers, run them, and add each back into its
    token's row with its gate: y [T, d] in x's type."""
    T, d = xf.shape
    E = w_gate.shape[0]
    token_of = order // k
    safe_rank = torch.where(keep, rank, 0)
    sharded = pspec.is_dtensor(xf)
    buf = _zeros(xf, (E, cap, d))
    rows = torch.where(keep[:, None], xf[token_of], 0).to(xf.dtype)
    # On DTensors out of place: their in-place index ops can change a
    # tensor's layout.
    if sharded:
        buf = buf.index_put((sorted_e, safe_rank), rows, accumulate=True)
        buf = constrain(buf, "tp", None, None)  # EP: experts over the model axis
    else:
        buf.index_put_((sorted_e, safe_rank), rows, accumulate=True)
    out = _experts(buf, w_gate, w_in, w_out)
    contrib = out[sorted_e, safe_rank]  # [T·k, d]
    gate_sorted = gates.reshape(-1)[order]
    contrib = torch.where(keep[:, None], contrib * gate_sorted[:, None].to(xf.dtype), 0)
    if sharded:
        return constrain(_zeros(xf, (T, d)).index_add(0, token_of, contrib), "dp", None)
    return _zeros(xf, (T, d)).index_add_(0, token_of, contrib)


def moe_ffn(cfg: ModelConfig, p: MoE, x: torch.Tensor, *,
            expert_perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, S, d] → [B, S, d]; see the module docstring."""
    m = cfg.moe
    B, S, d = x.shape
    T, E, k = B * S, m.num_experts, m.top_k
    xf = x.reshape(T, d)
    _, gates, expert_idx = route(cfg, p.router, xf)
    if expert_perm is not None:  # EBG placement: rename the expert ids
        expert_idx = expert_perm[expert_idx]
    cap = capacity(cfg, T)
    flat_e = expert_idx.reshape(-1)  # [T·k]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=x.device), side="left")
    rank = torch.arange(T * k, device=x.device) - starts[sorted_e]
    y = _dispatch_combine(xf, gates, sorted_e, order, rank < cap, rank, k, cap, p.w_gate,
                          p.w_in, p.w_out)
    return y.reshape(B, S, d)


def _moe_body(cfg: ModelConfig, xb: torch.Tensor, router, wg, wi, wo, *,
              rank: int) -> torch.Tensor:
    """One expert-parallel rank's partial output [T, d]: the router over
    all tokens xb [T, d], then only this rank's experts (wg, wi, wo: the
    E_loc experts [rank·E_loc, (rank+1)·E_loc)); every other rank's
    assignments go to a dump bucket and add nothing. Summed over the
    ranks it is `moe_ffn` (the same capacity, the same kept assignments)."""
    m = cfg.moe
    k = m.top_k
    E_loc = wg.shape[0]
    Tl, d = xb.shape
    _, gates, expert_idx = route(cfg, router, xb)
    cap = capacity(cfg, Tl)
    flat_e = expert_idx.reshape(-1) - rank * E_loc  # local expert ids
    mine = (flat_e >= 0) & (flat_e < E_loc)
    sort_key = torch.where(mine, flat_e, E_loc)  # foreign → dump bucket
    order = torch.argsort(sort_key, stable=True)
    sorted_e = sort_key[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E_loc, device=xb.device), side="left")
    safe_e = sorted_e.clamp(0, E_loc - 1)
    r = torch.arange(Tl * k, device=xb.device) - starts[safe_e]
    keep = (sorted_e < E_loc) & (r >= 0) & (r < cap)
    return _dispatch_combine(xb, gates, safe_e, order, keep, r, k, cap, wg, wi, wo)


class _SumGrads(torch.autograd.Function):
    """Identity forward; the gradient summed over the group's ranks."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _SumOutputs(torch.autograd.Function):
    """The partial outputs summed over the group's ranks, in place; the
    replicated output's gradient passed to each rank's partial unchanged."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.mark_dirty(t)
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def moe_ffn_ep(cfg: ModelConfig, p: MoE, x: torch.Tensor, *, group=None) -> torch.Tensor:
    """Expert-parallel `moe_ffn` over the ranks of `group` (a
    `torch.distributed` process group; None: `moe_ffn` on this process,
    or, on DTensors under `pspec.ep_shard_map()`, `_moe_ffn_ep_dtensor`).
    x [B, S, d] holds every token on every rank; p holds this rank's E/w
    experts and the whole router (`shard_experts`). One `all_reduce` of
    the partial [B·S, d] outputs; every rank returns the sum."""
    if group is None:
        ctx = pspec.ep_shard_map()
        if ctx is not None and pspec.is_dtensor(x):
            return _moe_ffn_ep_dtensor(cfg, p, x, *ctx)
        return moe_ffn(cfg, p, x)
    w, r = dist.get_world_size(group), dist.get_rank(group)
    E = cfg.moe.num_experts
    if E % w or p.w_gate.shape[0] != E // w:
        raise ValueError(f"moe_ffn_ep: {E} experts over {w} ranks need E/w = {E // w} experts "
                         f"a rank, got {p.w_gate.shape[0]}")
    B, S, d = x.shape
    xb = _SumGrads.apply(x.reshape(B * S, d), group)
    y = _moe_body(cfg, xb, _SumGrads.apply(p.router, group), p.w_gate, p.w_in, p.w_out, rank=r)
    return _SumOutputs.apply(y, group).reshape(B, S, d)


def _moe_ffn_ep_dtensor(cfg: ModelConfig, p: MoE, x, mesh, dp, tp):
    """The plan `ep` on DTensors (the reference's shard_map specs): the
    tokens laid out over `dp` and whole over `tp`, the router whole, the
    experts over `tp`; `moe_ffn_ep` runs on the local tensors over the
    `tp` axis's process group, and its output is wrapped back laid out
    over `dp`. The local router's and experts' gradients are partial sums
    over the DP axes (each DP rank saw its own tokens; `moe_ffn_ep` has
    summed them over `tp`), which DTensor reduces back onto their layout."""
    from torch.distributed.tensor import DTensor, Partial

    dims = tuple(mesh.mesh_dim_names)
    dp_names = (dp,) if isinstance(dp, str) else tuple(dp)

    def local(t, spec, partial_over_dp):
        pl = pspec.placements(spec, mesh)
        grad = tuple(Partial() if partial_over_dp and dims[i] in dp_names else pl[i]
                     for i in range(len(dims)))
        return t.redistribute(mesh, pl).to_local(grad_placements=grad)

    P = pspec.P
    expert = P(tp, None, None)
    shard = types.SimpleNamespace(router=local(p.router, P(None, None), True),
                                  **{n: local(getattr(p, n), expert, True)
                                     for n in ("w_gate", "w_in", "w_out")})
    out_pl = pspec.placements(P(dp, None, None), mesh)
    y = moe_ffn_ep(cfg, shard, local(x, P(dp, None, None), False), group=mesh.get_group(tp))
    return DTensor.from_local(y, mesh, out_pl, run_check=False, shape=x.shape,
                              stride=x.stride())


def shard_experts(cfg: ModelConfig, p: MoE, rank: int, world: int) -> MoE:
    """Rank `rank`'s share of `p` for `moe_ffn_ep` over `world` ranks: the
    router, and experts [rank·E/w, (rank+1)·E/w) (views, no copy)."""
    E = cfg.moe.num_experts
    if E % world or not 0 <= rank < world:
        raise ValueError(f"{E} experts do not shard over rank {rank} of {world}")
    n = E // world
    out = MoE(cfg, num_experts=n, device="meta", dtype=p.w_gate.dtype)
    lo = rank * n
    for name in ("w_gate", "w_in", "w_out"):
        setattr(out, name, nn.Parameter(getattr(p, name)[lo:lo + n], requires_grad=False))
    out.router = p.router
    return out


def aux_load_balance_loss(logits: torch.Tensor, expert_idx: torch.Tensor,
                          num_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E[fraction routed] x E[router prob]."""
    probs = torch.softmax(logits, dim=-1)
    frac = F.one_hot(expert_idx[..., 0], num_experts).float().mean(dim=0)
    return num_experts * (frac * probs.mean(dim=0)).sum()


def init_moe(cfg: ModelConfig, gen: torch.Generator, dtype) -> MoE:
    """Random MoE weights at the reference's scales (router d^-0.5 in f32;
    w_gate, w_in d^-0.5 and w_out f^-0.5 in `dtype`), drawn on the
    generator's device."""
    from repro_torch.models.layers import _normal

    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff, m.num_experts
    p = MoE(cfg, device=gen.device, dtype=dtype)
    p.router.data = _normal(gen, (d, E), d ** -0.5, torch.float32)
    p.w_gate.data = _normal(gen, (E, d, f), d ** -0.5, dtype)
    p.w_in.data = _normal(gen, (E, d, f), d ** -0.5, dtype)
    p.w_out.data = _normal(gen, (E, f, d), f ** -0.5, dtype)
    return p
