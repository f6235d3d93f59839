"""Train, prefill and decode step functions (port of `repro.models.steps`):
the units the training loop (`repro_torch.launch.train`) and the serving
loop (`repro_torch.launch.serve.generate`) call.

Batch dicts:
  train:   {tokens [B, S] | embeds [B, S, d], targets [B, S],
            (enc_tokens | enc_embeds)}
  prefill: {tokens [B, S] | embeds [B, S, d], (enc_tokens | enc_embeds)}
           → last logits + caches
  decode:  {token [B, 1] | embed, pos, (enc_out | enc_embeds | enc_tokens)}
           → next logits + caches

The train step runs the forward and the backward under autograd (with
`remat`, each group of layers recomputed in the backward, as the
reference's `jax.checkpoint`), then `optim.apply_updates` in place. The
serving steps run under `torch.no_grad()` and build no autograd graph.
An encoder-decoder's decode step takes `enc_out` computed once
(`transformer.encode`), or recomputes it from `enc_embeds` / `enc_tokens`
every step, as the reference's does. The caches are written in place: a
decode step returns the same cache objects it was given, advanced by one
key.

Sharded (DTensor parameters and batches inside `pspec.activation_axes`),
the same steps run on every rank: the prefill's caches are laid out by the
cache rules, and the loss takes its logsumexp and the target's logit as
sums over the vocab-sharded logits (`_logsumexp`, `_target_logit`), each
one all-reduce, where DTensor's own would gather the whole vocab.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import pspec
from repro_torch.models.config import ModelConfig
from repro_torch.models.pspec import constrain
from repro_torch.models.transformer import forward, init_caches
from repro_torch.optim.adam import AdamWConfig, apply_updates


def lm_loss(cfg: ModelConfig, params, batch: dict, *, remat: bool = True,
            vocab_parallel: bool = False):
    """Mean next-token cross entropy over [B, S]: (loss, dict(loss=loss)),
    the loss an f32 0-d tensor. logsumexp of the f32 logits less the
    target's logit, taken by `take_along_dim` of the f32 logits or, with
    `vocab_parallel`, by a one-hot contraction in the logits' dtype (the
    reference's Megatron-style branch for vocab-sharded logits)."""
    logits, _ = forward(cfg, params, tokens=batch.get("tokens"), embeds=batch.get("embeds"),
                        enc_tokens=batch.get("enc_tokens"), enc_embeds=batch.get("enc_embeds"),
                        remat=remat)
    targets = batch["targets"].long()
    lse = _logsumexp(logits.float())
    if vocab_parallel:
        onehot = F.one_hot(targets, cfg.vocab).to(logits.dtype)
        tgt = torch.einsum("bsv,bsv->bs", logits, onehot).float()[..., None]
    else:
        tgt = _target_logit(logits.float(), targets)
    # Laid out as the batch (its gradient too, so that it meets the
    # vocab-sharded logits without a gather).
    nll = constrain(lse[..., None] - tgt, "dp", "sp", None)
    loss = nll.mean()
    return loss, dict(loss=loss)


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """logsumexp over the vocab: `torch.logsumexp`, or on a DTensor the
    same steps written out (the max, the sum of exp(x - max)), each a
    reduction DTensor runs on vocab-sharded logits with one all-reduce (its
    logsumexp gathers the whole vocab first)."""
    if not pspec.is_dtensor(logits):
        return torch.logsumexp(logits, dim=-1)
    m = constrain(logits.detach().amax(dim=-1, keepdim=True), "dp", "sp", None)
    m = torch.where(m.abs() == float("inf"), 0.0, m)
    total = constrain(torch.exp(logits - m).sum(dim=-1, keepdim=True), "dp", "sp", None)
    return (torch.log(total) + m)[..., 0]


def _target_logit(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits[b, s, targets[b, s]] as [B, S, 1]: `take_along_dim`, or on a
    DTensor a sum over the vocab masked by target == vocab id, with the ids
    laid out as the logits' vocab dim (the same value: one term and exact
    zeros), so that vocab-sharded logits and their gradient stay sharded
    (DTensor's gather scatters its gradient into the whole [B, S, vocab])."""
    if not pspec.is_dtensor(logits):
        return torch.take_along_dim(logits, targets[..., None], dim=-1)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    V, Vl = logits.shape[-1], logits.to_local().shape[-1]
    lo = pspec.shard_index(logits, 2)[0] * Vl
    ids = torch.arange(lo, lo + Vl, device=logits.to_local().device)
    vocab = tuple(Shard(0) if p == Shard(2) else Replicate() for p in logits.placements)
    ids = DTensor.from_local(ids, logits.device_mesh, vocab, run_check=False, shape=(V,),
                             stride=(1,))
    hit = targets[..., None].long() == ids
    return constrain(torch.where(hit, logits, 0.0).sum(dim=-1, keepdim=True), "dp", "sp", None)


def make_train_step(cfg: ModelConfig, opt: AdamWConfig, *, remat: bool = True,
                    vocab_parallel: bool = False):
    """train_step(params, opt_state, batch) → (params, opt_state,
    dict(loss, grad_norm, lr)): one forward and backward of `lm_loss`, then
    one AdamW update of `params` (an `LM`, updated in place; its parameters
    get `requires_grad` and keep it). The metrics are f32 0-d tensors on
    the device."""

    def train_step(params, opt_state, batch):
        named = list(params.named_parameters())
        for _, p in named:
            if not p.requires_grad:
                p.requires_grad_(True)
        with torch.enable_grad():
            loss, _ = lm_loss(cfg, params, batch, remat=remat, vocab_parallel=vocab_parallel)
            grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
        params, opt_state, om = apply_updates(params, {n: g for (n, _), g in zip(named, grads)},
                                              opt_state, opt)
        return params, opt_state, dict(loss=loss.detach(), **om)

    return train_step


def make_prefill_step(cfg: ModelConfig, max_seq: int, *, cache_layout=None):
    """prefill_step(params, batch) → (last logits [B, vocab], caches).
    `cache_layout` (caches → caches), for a sharded run: the caches are
    made on the meta device and handed to it to be laid out on the mesh
    (`launch.sharding.lay_out_caches`); None makes them on the params'
    device."""

    @torch.no_grad()
    def prefill_step(params, batch):
        x = batch["tokens"] if "tokens" in batch else batch["embeds"]
        caches = init_caches(cfg, x.shape[0], max_seq,
                             device="meta" if cache_layout else params.embed.device)
        if cache_layout is not None:
            caches = cache_layout(caches)
        logits, caches = forward(cfg, params, tokens=batch.get("tokens"),
                                 embeds=batch.get("embeds"), enc_tokens=batch.get("enc_tokens"),
                                 enc_embeds=batch.get("enc_embeds"), caches=caches, cache_pos=0)
        return logits[:, -1], caches

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: token [B, 1] + caches → logits [B, vocab] + caches."""

    @torch.no_grad()
    def serve_step(params, caches, batch):
        pos = int(batch["pos"])  # the cache's length: an int or a 0-d tensor
        logits, caches = forward(cfg, params, tokens=batch.get("token"),
                                 embeds=batch.get("embed"), enc_embeds=batch.get("enc_embeds"),
                                 enc_tokens=batch.get("enc_tokens"),
                                 enc_out=batch.get("enc_out"), caches=caches, cache_pos=pos)
        return logits[:, -1], caches

    return serve_step
