"""Prefill and decode step functions (port of `repro.models.steps`):
the units the serving loop (`repro_torch.launch.serve.generate`) calls.

Batch dicts:
  prefill: {tokens [B, S] | embeds [B, S, d], (enc_tokens | enc_embeds)}
           → last logits + caches
  decode:  {token [B, 1] | embed, pos, (enc_out | enc_embeds | enc_tokens)}
           → next logits + caches

An encoder-decoder's decode step takes `enc_out` computed once
(`transformer.encode`), or recomputes it from `enc_embeds` / `enc_tokens`
every step, as the reference's does. The reference's `lm_loss` and
`make_train_step` come with the training slice of the port. The caches are
written in place: a decode step returns the same cache objects it was
given, advanced by one key.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import forward, init_caches


def make_prefill_step(cfg: ModelConfig, max_seq: int):
    def prefill_step(params, batch):
        x = batch["tokens"] if "tokens" in batch else batch["embeds"]
        caches = init_caches(cfg, x.shape[0], max_seq, device=params.embed.device)
        logits, caches = forward(cfg, params, tokens=batch.get("tokens"),
                                 embeds=batch.get("embeds"), enc_tokens=batch.get("enc_tokens"),
                                 enc_embeds=batch.get("enc_embeds"), caches=caches, cache_pos=0)
        return logits[:, -1], caches

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: token [B, 1] + caches → logits [B, vocab] + caches."""

    def serve_step(params, caches, batch):
        pos = int(batch["pos"])  # the current length of the cache
        logits, caches = forward(cfg, params, tokens=batch.get("token"),
                                 embeds=batch.get("embed"), enc_embeds=batch.get("enc_embeds"),
                                 enc_tokens=batch.get("enc_tokens"),
                                 enc_out=batch.get("enc_out"), caches=caches, cache_pos=pos)
        return logits[:, -1], caches

    return serve_step
