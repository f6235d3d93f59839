"""Model assembly: decoder-only, hybrid and encoder-decoder stacks (port of
`repro.models.transformer`).

The reference scans `cfg.group` n_groups times over parameters stacked
along a group axis; the port runs a plain loop over its `n_layers` layers,
layer l taking the spec `cfg.group[l % len(cfg.group)]` (gemma2's
local/global alternation, jamba's period-8 block of one attention and
seven SSM mixers with a MoE MLP every other layer).
`interop.lm_params_from_numpy` unstacks the reference's parameters into
that order. The sharding constraints (`pspec.constrain`) sit where the
reference's do: after the embedding, at each group boundary (each run of
`len(cfg.group)` layers), on the logits. They act on DTensors inside
`pspec.activation_axes` only; on plain tensors they return their input.

A layer (`Layer`) is a pre-norm mixer (`attn` or `ssm`), then for an
encoder-decoder's decoder a cross-attention (`cross_norm`, `cross`), then
a `dense` or `moe` MLP (`mlp_norm`; mamba2's `none` has neither). The
encoder (`enc_layers`: attention + dense MLP, not causal, then
`enc_final_norm`) runs inside `forward` when it is given `enc_tokens` or
`enc_embeds` and no `enc_out`; `encode` is that block alone, so that a
serving loop can compute `enc_out` once. With no encoder input at all the
cross layers run `attention(kv_x=None)`: an unmasked self-attention over
the call's own tokens, with RoPE, as the reference computes it.

Caches (`init_caches`): one a layer, a `layers.KVCache` for an attention
mixer and an `ssm.SSMCache` for an SSM mixer, written in place.

`forward` and `encode` are differentiable: the serving callers
(`steps.make_prefill_step`, `steps.make_serve_step`, `launch.serve.
generate`) run them under `torch.no_grad()`, the training step under
autograd. With `remat` (the reference's `jax.checkpoint` of each scanned
group) each run of `len(cfg.group)` layers is one
`torch.utils.checkpoint` segment: its activations are recomputed in the
backward pass, not kept. A forward with caches, with grad off, or with
nothing that requires grad, runs no checkpoint. The parameters are built
with `requires_grad=False` (the serving default); the training step turns
it on for the ones it trains.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import pspec
from repro_torch.models import ssm as SSM
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.pspec import constrain

ENC_SPEC = LayerSpec(kind="attn", mlp="dense")  # an encoder layer


# ----------------------------------------------------------------- params


class Layer(nn.Module):
    """One layer's parameters: `pre_norm` and `attn` or `ssm`; `cross_norm`
    and `cross` (cross_attn); `mlp_norm` and `mlp` or `moe` (an MLP)."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, new, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        d = cfg.d_model

        def norm():
            return nn.Parameter(torch.zeros(d, device=device, dtype=dtype), requires_grad=False)

        self.pre_norm = norm()
        if spec.kind == "attn":
            self.attn = new("attn")
        else:
            self.ssm = new("ssm")
        if spec.cross_attn:
            self.cross_norm = norm()
            self.cross = new("attn")
        if spec.mlp != "none":
            self.mlp_norm = norm()
            if spec.mlp == "dense":
                self.mlp = new("mlp")
            else:
                self.moe = new("moe")


class LM(nn.Module):
    """The parameters: `embed` [vocab, d], `final_norm` [d], `unembed`
    [d, vocab] (untied embeddings only), `layers` (n_layers) and, for an
    encoder-decoder, `enc_layers` (n_enc_layers) and `enc_final_norm`."""

    def __init__(self, cfg: ModelConfig, new, *, device=None, dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        kw = dict(device=device, dtype=dtype)

        def param(*shape):
            return nn.Parameter(torch.zeros(shape, **kw), requires_grad=False)

        self.embed = param(cfg.vocab, d)
        self.final_norm = param(d)
        if not cfg.tie_embeddings:
            self.unembed = param(d, cfg.vocab)
        self.layers = nn.ModuleList(Layer(cfg, cfg.group[i % len(cfg.group)], new, **kw)
                                    for i in range(cfg.n_layers))
        if cfg.is_encdec:
            self.enc_layers = nn.ModuleList(Layer(cfg, ENC_SPEC, new, **kw)
                                            for _ in range(cfg.n_enc_layers))
            self.enc_final_norm = param(d)


def empty_params(cfg: ModelConfig, *, device=None, dtype=torch.float32) -> LM:
    """An `LM` of zeros in `dtype` on `device` (to be filled); the MoE
    router and the SSM's dt_bias, A_log and D are f32, as in the reference."""
    kw = dict(device=device, dtype=dtype)
    kinds = {"attn": L.Attention, "mlp": L.MLP, "moe": MOE.MoE, "ssm": SSM.SSM}
    return LM(cfg, lambda kind: kinds[kind](cfg, **kw), **kw)


def init_params(cfg: ModelConfig, generator: torch.Generator, dtype=torch.bfloat16) -> LM:
    """Random parameters at the reference's scales, drawn from `generator`
    on its device (the numbers are not jax.random's); norm scales zero."""
    gen, d = generator, cfg.d_model
    kinds = {"attn": L.init_attention, "mlp": L.init_mlp, "moe": MOE.init_moe,
             "ssm": SSM.init_ssm}
    params = LM(cfg, lambda kind: kinds[kind](cfg, gen, dtype), device=gen.device, dtype=dtype)
    params.embed.data = L._normal(gen, (cfg.vocab, d), d ** -0.5, dtype)
    if not cfg.tie_embeddings:
        params.unembed.data = L._normal(gen, (d, cfg.vocab), d ** -0.5, dtype)
    return params


# ---------------------------------------------------------------- forward


def _apply_layer(cfg, spec: LayerSpec, p: Layer, x, positions, *, causal, enc_out=None,
                 cache=None):
    # Sharded, each branch's output is laid out as the residual before the
    # add (a partial sum over `tp` reduced), so that the residual stream
    # keeps the layout of the group boundary.
    def branch(h):
        return constrain(h, "dp", "sp", None)

    h = L.rms_norm(x, p.pre_norm, cfg.norm_eps)
    if spec.kind == "attn":
        h, _ = L.attention(cfg, p.attn, h, positions, causal=causal,
                           window=spec.sliding_window, cache=cache)
    else:
        h, _ = SSM.ssm_block(cfg, p.ssm, h, cache=cache)
    x = x + branch(h)
    if spec.cross_attn:
        h = L.rms_norm(x, p.cross_norm, cfg.norm_eps)
        h, _ = L.attention(cfg, p.cross, h, positions, causal=False, kv_x=enc_out)
        x = x + branch(h)
    if spec.mlp != "none":
        h = L.rms_norm(x, p.mlp_norm, cfg.norm_eps)
        h = L.mlp(cfg, p.mlp, h) if spec.mlp == "dense" else MOE.moe_ffn_ep(cfg, p.moe, h)
        x = x + branch(h)
    return x


def _run_stack(cfg, layers, specs, x, positions, *, causal, enc_out=None, caches=None,
               remat=False):
    """The layers in order, layer l with spec specs[l % len(specs)]. With
    `remat` (grad on, something to differentiate, no caches) each run of
    len(specs) layers, one of the reference's scanned groups, is a
    checkpoint segment."""
    n = len(specs)
    axes = pspec.axes()

    def group(g, xg):
        with pspec.restored(axes):
            xg = constrain(xg, "dp", "sp", None)
            for layer in range(g * n, min((g + 1) * n, len(layers))):
                xg = _apply_layer(cfg, specs[layer % n], layers[layer], xg, positions,
                                  causal=causal, enc_out=enc_out,
                                  cache=None if caches is None else caches[layer])
            return xg

    segments = (remat and caches is None and torch.is_grad_enabled() and
                (x.requires_grad or any(t.requires_grad for t in layers.parameters())))
    for g in range(-(-len(layers) // n)):
        x = checkpoint(group, g, x, use_reentrant=False) if segments else group(g, x)
    return x


def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """table[tokens]. Sharded (DTensors), the table is gathered over the DP
    axes first (the FSDP all-gather; its d_model dim stays over `tp`) and
    each rank looks its own tokens up in its local piece; the table's
    gradient is a partial sum over the DP axes, which DTensor reduces back
    onto its layout."""
    if not pspec.axes() or not hasattr(tokens, "placements"):
        return table[tokens]
    from torch.distributed.tensor import DTensor, Partial, Shard

    table = pspec.layout(table, None, "tp")
    mesh = table.device_mesh
    grad = tuple(p if isinstance(p, Shard) else Partial() for p in table.placements)
    local = table.to_local(grad_placements=grad)[tokens.to_local()]
    out = tuple(Shard(2) if isinstance(p, Shard) else q
                for p, q in zip(table.placements, tokens.placements))
    shape = (*tokens.shape, table.shape[1])
    return DTensor.from_local(local, mesh, out, run_check=False, shape=shape,
                              stride=(shape[1] * shape[2], shape[2], 1))


def encode(cfg: ModelConfig, params: LM, *, enc_tokens: Optional[torch.Tensor] = None,
           enc_embeds: Optional[torch.Tensor] = None,
           remat: bool = True) -> Optional[torch.Tensor]:
    """The encoder of an encoder-decoder config: enc_out [B, Se, d] from
    `enc_embeds` [B, Se, d] or `enc_tokens` [B, Se] (embedded), None when
    neither is given. Not causal; positions 0..Se-1."""
    if enc_embeds is None and enc_tokens is not None:
        enc_embeds = params.embed[enc_tokens]
    if enc_embeds is None:
        return None
    B, Se = enc_embeds.shape[:2]
    enc_pos = torch.arange(Se, device=enc_embeds.device)[None, :].expand(B, Se)
    x = _run_stack(cfg, params.enc_layers, (ENC_SPEC,), enc_embeds, enc_pos, causal=False,
                   remat=remat)
    return L.rms_norm(x, params.enc_final_norm, cfg.norm_eps)


def forward(
    cfg: ModelConfig,
    params: LM,
    *,
    tokens: Optional[torch.Tensor] = None,  # [B, S]
    embeds: Optional[torch.Tensor] = None,  # [B, S, d] (modality frontend stub)
    positions: Optional[torch.Tensor] = None,
    enc_tokens: Optional[torch.Tensor] = None,
    enc_embeds: Optional[torch.Tensor] = None,
    enc_out: Optional[torch.Tensor] = None,  # a precomputed encoder output (decode)
    caches: Optional[list] = None,  # init_caches(...), written in place
    cache_pos: Optional[int] = None,
    remat: bool = True,
):
    """Returns (logits [B, S, vocab], caches)."""
    x = _embed(params.embed, tokens) if embeds is None else embeds
    x = constrain(x, "dp", "sp", None)
    B, S = x.shape[:2]
    if positions is None:
        base = torch.arange(S, device=x.device)[None, :] + (0 if cache_pos is None
                                                            else int(cache_pos))
        positions = base.expand(B, S)
        if cfg.mrope_sections is not None:
            positions = positions[None].expand(3, B, S)
    if cfg.is_encdec and enc_out is None:
        enc_out = encode(cfg, params, enc_tokens=enc_tokens, enc_embeds=enc_embeds, remat=remat)
    x = _run_stack(cfg, params.layers, cfg.group, x, positions, causal=True, enc_out=enc_out,
                   caches=caches, remat=remat)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    unembed = params.embed.T if cfg.tie_embeddings else params.unembed
    x = constrain(x, "dp", "sp", None)
    logits = x @ pspec.layout(unembed, None, "tp")  # vocab-parallel: vocab over tp
    logits = constrain(logits, "dp", "sp", "tp")
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits, caches


# ----------------------------------------------------------------- caches


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
                device=None) -> list:
    """One cache a layer, nothing written: a `KVCache` (k, v zeros [batch,
    max_seq, Hkv, hd] in `dtype`) for an attention mixer, an `SSMCache`
    (state f32 [batch, nh, P, N], conv [batch, K-1, c] in `dtype`) for an
    SSM mixer."""
    kv_shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim_)
    out = []
    for layer in range(cfg.n_layers):
        if cfg.group[layer % len(cfg.group)].kind == "attn":
            out.append(L.KVCache(k=torch.zeros(kv_shape, dtype=dtype, device=device),
                                 v=torch.zeros(kv_shape, dtype=dtype, device=device)))
        else:
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            nh = d_in // s.head_dim
            out.append(SSM.SSMCache(
                state=torch.zeros((batch, nh, s.head_dim, s.d_state), dtype=torch.float32,
                                  device=device),
                conv=torch.zeros((batch, s.d_conv - 1, d_in + 2 * s.d_state), dtype=dtype,
                                 device=device)))
    return out
