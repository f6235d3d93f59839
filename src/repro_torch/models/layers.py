"""Transformer layer primitives (port of `repro.models.layers`).

Every attention variant of the assigned architectures: GQA, sliding window
(gemma2's local layers), attention and logit soft-capping, QK-norm
(qwen3), QKV bias (qwen2), RoPE and M-RoPE (qwen2-vl), and the `kv_x`
branch (cross-attention over another sequence's keys: seamless's decoder
over the encoder's output; no RoPE, no mask). Sums and softmax in f32;
the parameters' dtype (f32 or bf16) everywhere else, as in the reference.

The parameters are `nn.Module`s in the reference's einsum layouts —
`wq` [d, H, hd], `wk`/`wv` [d, Hkv, hd], `wo` [H, hd, d], `w_gate`/`w_in`
[d, f], `w_out` [f, d] — so carrying the reference's weights across is a
copy (`repro_torch.interop.lm_params_from_numpy`).

With a KV cache (`KVCache`: preallocated [B, max_seq, Hkv, hd] tensors in
the cache's dtype and the count of keys written), `attention` writes this
call's K and V in place at that position. A one-token call (the decode
step) then attends through `kernels.ops.decode_attention` — the CUDA
kernel on the card — over the cache's keys [max(0, pos+1-window), pos+1),
read in place. A longer call (prefill) attends with the reference's masked
einsum over the keys written so far. The reference masks the whole
max_seq cache instead; a masked key's weight, exp(NEG_INF - m), is exactly
0 in f32, so both compute one function up to the order of the sums.

A one-token call with `kv_x` (decode-time cross-attention) also attends
through `kernels.ops.decode_attention`, over all the source's keys
[0, Se) of the K and V this call computes (a fresh contiguous
[B, Se, Hkv, hd] pair, no cache); longer calls keep the einsum.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import decode_attn as _attn
from repro_torch.kernels import ops
from repro_torch.models import pspec
from repro_torch.models.config import ModelConfig

NEG_INF = -2.0e38

# Test hook: when set (by `plain_decode_attention`), the decode step's
# attention runs the kernel's plain version on any device, so that a run
# on the card can be held against the same run without the kernel.
_PLAIN_DECODE = False


@contextlib.contextmanager
def plain_decode_attention():
    """Test hook: inside this context the decode step (self- and
    cross-attention) attends through the plain PyTorch version of
    `decode_attention` (on the card too), over the same keys; it counts no
    launch."""
    global _PLAIN_DECODE
    before, _PLAIN_DECODE = _PLAIN_DECODE, True
    try:
        yield
    finally:
        _PLAIN_DECODE = before


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(x.dtype)


def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                           / head_dim)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections=None) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] or [3, B, S] for M-RoPE."""
    D = x.shape[-1]
    freqs = _rope_freqs(D, theta, x.device)  # [D/2]
    if positions.ndim == 2:
        angles = positions[..., None].float() * freqs  # [B, S, D/2]
    else:
        # M-RoPE: frequency bands partitioned into (t, h, w) sections (the
        # band's stream index made on the host: a shape-only run has no
        # values to size a repeat_interleave by).
        sec = torch.tensor([i for i, n in enumerate(mrope_sections) for _ in range(n)],
                           device=x.device)
        pos = positions[sec]  # [D/2, B, S]: the positional stream of each band
        angles = pos.movedim(0, -1).float() * freqs  # [B, S, D/2]
    sin, cos = torch.sin(angles)[:, :, None, :], torch.cos(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _attn_mask(S_q: int, S_kv: int, *, causal: bool, window: Optional[int], offset: int = 0,
               device=None) -> torch.Tensor:
    """[S_q, S_kv] additive mask. `offset` = absolute position of query 0."""
    q_pos = torch.arange(S_q, device=device)[:, None] + offset
    k_pos = torch.arange(S_kv, device=device)[None, :]
    ok = torch.ones((S_q, S_kv), dtype=torch.bool, device=device)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    return torch.where(ok, 0.0, NEG_INF).float()


@dataclasses.dataclass
class KVCache:
    """One attention layer's cache: k, v [B, max_seq, Hkv, hd], written in
    place; `pos` keys of each row are written."""

    k: torch.Tensor
    v: torch.Tensor
    pos: int = 0


def _param(*shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, device=device, dtype=dtype), requires_grad=False)


class Attention(nn.Module):
    """An attention layer's parameters, in the reference's layouts."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        H, Hkv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.d_model
        kw = dict(device=device, dtype=dtype)
        self.wq = _param(d, H, hd, **kw)
        self.wk = _param(d, Hkv, hd, **kw)
        self.wv = _param(d, Hkv, hd, **kw)
        self.wo = _param(H, hd, d, **kw)
        if cfg.qkv_bias:
            self.bq = _param(H, hd, **kw)
            self.bk = _param(Hkv, hd, **kw)
            self.bv = _param(Hkv, hd, **kw)
        if cfg.qk_norm:
            self.q_norm = _param(hd, **kw)
            self.k_norm = _param(hd, **kw)


class MLP(nn.Module):
    """A gated MLP's parameters: w_gate, w_in [d, f], w_out [f, d]."""

    def __init__(self, cfg: ModelConfig, *, d_ff: Optional[int] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        kw = dict(device=device, dtype=dtype)
        self.w_gate = _param(d, f, **kw)
        self.w_in = _param(d, f, **kw)
        self.w_out = _param(f, d, **kw)


def _project(x: torch.Tensor, w: torch.Tensor, heads_tp: bool = False) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) as one matrix product. Sharded
    (`pspec.activation_axes`, DTensors), the product's [H·hd] columns are
    laid out first, over `tp` when `heads_tp` (whole heads a shard), else
    whole, so that splitting them into [H, hd] keeps every head on one
    rank."""
    B, S, d = x.shape
    if pspec.axes() is None:
        return (x @ w.reshape(d, -1)).reshape(B, S, *w.shape[1:])
    x = pspec.constrain(x, "dp", "sp", None)
    w2 = pspec.layout(w.reshape(d, -1), None, "tp" if heads_tp else None)
    y = pspec.constrain(x @ w2, "dp", "sp", "tp" if heads_tp else None)
    return y.reshape(B, S, *w.shape[1:])


def _write_cache(cache_t: torch.Tensor, new: torch.Tensor, pos: int, end: int) -> None:
    """cache_t[:, pos:end] = new, in place. On a DTensor cache each rank
    writes the keys of its own shard of the sequence dim (the reference's
    `cache_specs` shard it when the kv heads do not divide the model axis)
    into its local tensor; `new` is laid out as the cache is first."""
    if not pspec.is_dtensor(cache_t):
        cache_t[:, pos:end] = new.to(cache_t.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh, pl = cache_t.device_mesh, cache_t.placements
    whole = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in pl]
    src = new.to(cache_t.dtype).redistribute(mesh, whole).to_local()
    local = cache_t.to_local()
    lo = pspec.shard_index(cache_t, 1)[0] * local.shape[1]
    a, b = max(pos, lo), min(end, lo + local.shape[1])
    if a < b:
        local[:, a - lo:b - lo] = src[:, a - pos:b - pos]


def attention(
    cfg: ModelConfig,
    p: Attention,
    x: torch.Tensor,  # [B, S, d]
    positions: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    kv_x: Optional[torch.Tensor] = None,  # attend over this sequence's keys
    cache: Optional[KVCache] = None,
) -> tuple[torch.Tensor, Optional[KVCache]]:
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_

    heads_tp = pspec.fits(Hkv, "tp")  # the query heads follow the kv heads
    q = _project(x, p.wq, heads_tp)
    src = x if kv_x is None else kv_x
    k = _project(src, p.wk, heads_tp)
    v = _project(src, p.wv, heads_tp)
    if cfg.qkv_bias:  # the biases laid out as their heads
        bias = [pspec.layout(b, "tp" if heads_tp else None, None) for b in (p.bq, p.bk, p.bv)]
        q, k, v = q + bias[0], k + bias[1], v + bias[2]
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    if kv_x is None:  # RoPE only for self-attention
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)

    wo = pspec.layout(p.wo.reshape(H * hd, -1), "tp" if heads_tp else None, None)
    if cache is not None:
        # Write this call's K/V at `pos`, in place.
        pos, end = cache.pos, cache.pos + S
        if end > cache.k.shape[1]:
            raise ValueError(f"the cache holds {cache.k.shape[1]} keys; this call writes "
                             f"keys {pos}..{end - 1}")
        _write_cache(cache.k, k, pos, end)
        _write_cache(cache.v, v, pos, end)
        cache.pos = end
        if S == 1:
            start = max(0, end - window) if window is not None else 0
            out = _one_query(cfg, q[:, 0], cache.k, cache.v, start, end)
            return out.reshape(B, 1, H * hd) @ wo, cache
        k, v = cache.k[:, :end], cache.v[:, :end]
        hd_spec = ("dp", "sp", "tp" if heads_tp else None, None)
        k, v = pspec.constrain(k, *hd_spec), pspec.constrain(v, *hd_spec)
        mask = _attn_mask(S, end, causal=True, window=window, offset=pos, device=x.device)
    elif kv_x is not None and S == 1:  # decode-time cross-attention: keys [0, Se)
        out = _one_query(cfg, q[:, 0], k, v, 0, k.shape[1])
        return out.reshape(B, 1, H * hd) @ wo, None
    else:
        mask = _attn_mask(S, k.shape[1], causal=causal and kv_x is None, window=window,
                          device=x.device)

    out = _attend(cfg, q, k, v, mask, heads_tp).to(x.dtype)
    out = pspec.constrain(out, "dp", "sp", "tp" if heads_tp else None)
    return out @ wo, cache


def _attend(cfg: ModelConfig, q, k, v, mask, heads_tp: bool) -> torch.Tensor:
    """The masked einsum attention of q [B, S, H, hd] over k, v [B, T, Hkv,
    hd]: [B, S, H·hd] in f32. Sharded (DTensors), q, k and v are laid out
    with the batch over the DP axes, the heads over `tp` when `heads_tp`
    and the sequences whole, and each rank attends its own (batch, heads)
    block on its local tensors: the block is independent of every other."""
    if not pspec.is_dtensor(q):
        return _attend_local(cfg, q, k, v, mask)
    from torch.distributed.tensor import DTensor

    spec = ("dp", None, "tp" if heads_tp else None, None)
    q, k, v = (pspec.layout(t, *spec) for t in (q, k, v))
    out = _attend_local(cfg, *(pspec.local(t) for t in (q, k, v)), mask).contiguous()
    B, S, H, hd = q.shape
    return DTensor.from_local(out, q.device_mesh, q.placements, run_check=False,
                              shape=(B, S, H * hd), stride=(S * H * hd, H * hd, 1))


def _attend_local(cfg: ModelConfig, q, k, v, mask) -> torch.Tensor:
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    qf = q.float().reshape(B, S, Hkv, H // Hkv, hd)
    scores = torch.einsum("bshgk,bthk->bhgst", qf, k.float()) / math.sqrt(hd)
    if cfg.attn_softcap:
        scores = cfg.attn_softcap * torch.tanh(scores / cfg.attn_softcap)
    scores = scores + mask
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthk->bshgk", w, v.float())
    return out.reshape(B, S, H * hd)


def _one_query(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               start: int, end: int) -> torch.Tensor:
    """One query token [B, H, hd] over keys [start, end) of k, v [B, S, Hkv,
    hd] (a cache, or a cross-attention source), read in place: [B, H, hd]
    in q's dtype."""
    q = q.contiguous()
    if _PLAIN_DECODE:
        return _attn.decode_attention_plain(q, k[:, start:end], v[:, start:end],
                                            softcap=cfg.attn_softcap)
    return ops.decode_attention(q, k, v, softcap=cfg.attn_softcap, start=start, end=end)


def mlp(cfg: ModelConfig, p: MLP, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "silu":
        h = F.silu(x @ p.w_gate)
    else:  # jax.nn.gelu's default: the tanh approximation
        h = F.gelu(x @ p.w_gate, approximate="tanh")
    return (h * (x @ p.w_in)) @ p.w_out


# ------------------------------------------------------------------ init


def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
            * scale).to(dtype)


def init_attention(cfg: ModelConfig, gen: torch.Generator, dtype) -> Attention:
    """Random attention weights at the reference's scales (d^-0.5, and
    (H·hd)^-0.5 for wo), drawn on the generator's device; biases and norm
    scales zero."""
    H, Hkv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.d_model
    p = Attention(cfg, device=gen.device, dtype=dtype)
    s = d ** -0.5
    p.wq.data = _normal(gen, (d, H, hd), s, dtype)
    p.wk.data = _normal(gen, (d, Hkv, hd), s, dtype)
    p.wv.data = _normal(gen, (d, Hkv, hd), s, dtype)
    p.wo.data = _normal(gen, (H, hd, d), (H * hd) ** -0.5, dtype)
    return p


def init_mlp(cfg: ModelConfig, gen: torch.Generator, dtype, d_ff: Optional[int] = None) -> MLP:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = MLP(cfg, d_ff=f, device=gen.device, dtype=dtype)
    p.w_gate.data = _normal(gen, (d, f), d ** -0.5, dtype)
    p.w_in.data = _normal(gen, (d, f), d ** -0.5, dtype)
    p.w_out.data = _normal(gen, (f, d), f ** -0.5, dtype)
    return p
