"""Model assembly for the decoder-only dense stack (port of
`repro.models.transformer`).

The reference scans `cfg.group` n_groups times over parameters stacked
along a group axis; the port runs a plain loop over its `n_layers` layers,
layer l taking the spec `cfg.group[l % len(cfg.group)]` (gemma2's
local/global alternation). `interop.lm_params_from_numpy` unstacks the
reference's parameters into that order. The reference's sharding
constraints (`pspec.constrain`) have no counterpart here.

This slice runs stacks whose layers are all attention + dense MLP. A spec
with an SSM mixer, a MoE MLP or cross-attention, and an encoder-decoder
config, raise NotImplementedError naming the slice that brings them.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import LayerSpec, ModelConfig


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError unless every layer of `cfg` is attention +
    dense MLP in a decoder-only stack."""
    for spec in cfg.group:
        if spec.kind == "ssm":
            raise NotImplementedError(
                f"{cfg.name}: SSM layers (models/ssm.py) come in a later slice of the port")
        if spec.mlp == "moe":
            raise NotImplementedError(
                f"{cfg.name}: MoE layers (models/moe.py with core/placement.py) come in a "
                f"later slice of the port")
        if spec.cross_attn or cfg.is_encdec:
            raise NotImplementedError(
                f"{cfg.name}: the encoder-decoder stack comes in a later slice of the port")
        if spec.kind != "attn" or spec.mlp != "dense":
            raise NotImplementedError(f"{cfg.name}: layer spec {spec} is not ported")


# ----------------------------------------------------------------- params


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, attn: L.Attention, mlp: L.MLP, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        self.pre_norm = nn.Parameter(torch.zeros(d, device=device, dtype=dtype),
                                     requires_grad=False)
        self.attn = attn
        self.mlp_norm = nn.Parameter(torch.zeros(d, device=device, dtype=dtype),
                                     requires_grad=False)
        self.mlp = mlp


class DecoderLM(nn.Module):
    """The parameters: `embed` [vocab, d], `final_norm` [d], `unembed`
    [d, vocab] (untied embeddings only) and `layers` (n_layers)."""

    def __init__(self, cfg: ModelConfig, layers: list, *, device=None, dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        self.embed = nn.Parameter(torch.zeros(cfg.vocab, d, device=device, dtype=dtype),
                                  requires_grad=False)
        self.final_norm = nn.Parameter(torch.zeros(d, device=device, dtype=dtype),
                                       requires_grad=False)
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(torch.zeros(d, cfg.vocab, device=device, dtype=dtype),
                                        requires_grad=False)
        self.layers = nn.ModuleList(layers)


def empty_params(cfg: ModelConfig, *, device=None, dtype=torch.float32) -> DecoderLM:
    """A `DecoderLM` of zeros in `dtype` on `device` (to be filled)."""
    check_supported(cfg)
    kw = dict(device=device, dtype=dtype)
    layers = [DecoderLayer(cfg, L.Attention(cfg, **kw), L.MLP(cfg, **kw), **kw)
              for _ in range(cfg.n_layers)]
    return DecoderLM(cfg, layers, **kw)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16) -> DecoderLM:
    """Random parameters at the reference's scales, drawn from `generator`
    on its device (the numbers are not jax.random's)."""
    check_supported(cfg)
    gen, d = generator, cfg.d_model
    kw = dict(device=gen.device, dtype=dtype)
    embed = L._normal(gen, (cfg.vocab, d), d ** -0.5, dtype)
    unembed = None if cfg.tie_embeddings else L._normal(gen, (d, cfg.vocab), d ** -0.5, dtype)
    layers = [DecoderLayer(cfg, L.init_attention(cfg, gen, dtype), L.init_mlp(cfg, gen, dtype),
                           **kw) for _ in range(cfg.n_layers)]
    params = DecoderLM(cfg, layers, **kw)
    params.embed.data = embed
    if unembed is not None:
        params.unembed.data = unembed
    return params


# ---------------------------------------------------------------- forward


def _apply_layer(cfg, spec: LayerSpec, p: DecoderLayer, x, positions, *, cache=None):
    h = L.rms_norm(x, p.pre_norm, cfg.norm_eps)
    h, _ = L.attention(cfg, p.attn, h, positions, causal=True, window=spec.sliding_window,
                       cache=cache)
    x = x + h
    h = L.rms_norm(x, p.mlp_norm, cfg.norm_eps)
    return x + L.mlp(cfg, p.mlp, h)


@torch.no_grad()
def forward(
    cfg: ModelConfig,
    params: DecoderLM,
    *,
    tokens: Optional[torch.Tensor] = None,  # [B, S]
    embeds: Optional[torch.Tensor] = None,  # [B, S, d] (modality frontend stub)
    positions: Optional[torch.Tensor] = None,
    caches: Optional[list] = None,  # init_caches(...), written in place
    cache_pos: Optional[int] = None,
):
    """Returns (logits [B, S, vocab], caches)."""
    check_supported(cfg)
    x = params.embed[tokens] if embeds is None else embeds
    B, S = x.shape[:2]
    if positions is None:
        base = torch.arange(S, device=x.device)[None, :] + (0 if cache_pos is None
                                                            else int(cache_pos))
        positions = base.expand(B, S)
        if cfg.mrope_sections is not None:
            positions = positions[None].expand(3, B, S)
    for layer, p in enumerate(params.layers):
        x = _apply_layer(cfg, cfg.group[layer % len(cfg.group)], p, x, positions,
                         cache=None if caches is None else caches[layer])
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    unembed = params.embed.T if cfg.tie_embeddings else params.unembed
    logits = x @ unembed
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits, caches


# ----------------------------------------------------------------- caches


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
                device=None) -> list:
    """One `KVCache` a layer: k, v zeros [batch, max_seq, Hkv, hd] in
    `dtype`, nothing written."""
    check_supported(cfg)
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim_)
    return [L.KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                      v=torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.n_layers)]
