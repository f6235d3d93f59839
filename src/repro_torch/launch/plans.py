"""Named optimization plans (port of `repro.launch.plans`).

A plan transforms (cfg, overrides) before the dry-run lays a cell out;
`baseline` is the untouched configuration.

overrides keys consumed by `launch.dryrun`:
  sp:             mesh axis for sequence-parallel activations ("model")
  compress_grads: "bf16" gradient compression before the global norm
  vocab_parallel: one-hot vocab-parallel loss (no gather of the logits)
  serve_repl:     replicate weights over the DP axes (the serving layout:
                  no per-step FSDP all-gathers)
  donate_cache:   the reference donates the decode caches to the step; the
                  port's decode step writes them in place already
  ep_shard_map:   MoE through the manual expert-parallel dispatch
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


def apply_plan(cfg: ModelConfig, arch: str, shape: str, plan: str):
    """Returns (cfg, overrides) for a named plan: components joined by "+"."""
    overrides: dict = {}
    if plan == "baseline":
        return cfg, overrides

    for p in plan.split("+"):
        if p == "vp":  # vocab-parallel loss
            overrides["vocab_parallel"] = True
        elif p == "sp":  # sequence-parallel activations over the model axis
            overrides["sp"] = "model"
        elif p == "bf16g":  # gradient compression
            overrides["compress_grads"] = "bf16"
        elif p == "cap1":  # MoE: capacity 1.0 — less dispatch padding
            if cfg.moe is None:
                raise ValueError(f"plan component 'cap1' needs a MoE config; {arch} has none")
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.0)
            )
        elif p == "repl":  # serving: weights replicated over DP axes
            overrides["serve_repl"] = True
        elif p == "don":  # serving: donate the KV cache (in-place update)
            overrides["donate_cache"] = True
        elif p == "ep":  # MoE: manual expert-parallel dispatch + all-reduce combine
            overrides["ep_shard_map"] = True
        else:
            raise ValueError(f"unknown plan component {p!r} in {plan!r}")
    return cfg, overrides
