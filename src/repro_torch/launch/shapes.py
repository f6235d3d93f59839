"""Shape-only stand-ins for every model input (port of
`repro.launch.shapes`): `device="meta"` tensors with the reference's shapes
and dtypes, no memory. The dry-run (`launch.dryrun`) lays them out on a
mesh and runs the steps on fake tensors of their local shapes.

The decode step reads the cache's length on the host
(`models.steps.make_serve_step`), which no fake tensor can give, so
`decode_batch_specs` carries `pos` as a Python int: the cache of `seq`
keys holds `seq - 1` written, and the step writes the last.

The caches are `transformer.init_caches(..., device="meta")`: one cache a
layer, with no group axis. The reference stacks each of a group's layers
along a leading [G] axis (G = n_groups), so its leaf `layer_i/kv/k`
[G, B, S, Hkv, hd] holds the port's caches of layers i, i + len(group),
i + 2·len(group), ….
"""
from __future__ import annotations

import torch

from repro_torch.configs import SHAPES
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_caches


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, seq: int, gb: int) -> dict:
    b: dict = {"targets": sds((gb, seq), torch.int32)}
    if cfg.frontend:
        b["embeds"] = sds((gb, seq, cfg.d_model), torch.bfloat16)
    else:
        b["tokens"] = sds((gb, seq), torch.int32)
    if cfg.is_encdec:
        b["enc_embeds"] = sds((gb, seq, cfg.d_model), torch.bfloat16)
    return b


def prefill_batch_specs(cfg: ModelConfig, seq: int, gb: int) -> dict:
    b: dict = {}
    if cfg.frontend:
        b["embeds"] = sds((gb, seq, cfg.d_model), torch.bfloat16)
    else:
        b["tokens"] = sds((gb, seq), torch.int32)
    if cfg.is_encdec:
        b["enc_embeds"] = sds((gb, seq, cfg.d_model), torch.bfloat16)
    return b


def decode_batch_specs(cfg: ModelConfig, seq: int, gb: int) -> dict:
    b: dict = {"pos": seq - 1}
    if cfg.frontend:
        b["embed"] = sds((gb, 1, cfg.d_model), torch.bfloat16)
    else:
        b["token"] = sds((gb, 1), torch.int32)
    if cfg.is_encdec:
        # decode consumes the PREcomputed encoder output (from prefill);
        # re-running the encoder per token would waste ~all decode FLOPs.
        b["enc_out"] = sds((gb, seq, cfg.d_model), torch.bfloat16)
    return b


def cache_specs_shapes(cfg: ModelConfig, gb: int, max_seq: int) -> list:
    """The decode caches on the meta device, one a layer."""
    return init_caches(cfg, gb, max_seq, torch.bfloat16, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """All stand-ins for one (arch × shape) cell."""
    seq, gb, kind = SHAPES[shape_name]
    if kind == "train":
        return dict(kind="train", batch=train_batch_specs(cfg, seq, gb))
    if kind == "prefill":
        return dict(kind="prefill", batch=prefill_batch_specs(cfg, seq, gb), max_seq=seq)
    # decode: KV cache of length `seq` already in memory, one new token.
    caches = cache_specs_shapes(cfg, gb, seq)
    for c in caches:
        if hasattr(c, "pos"):
            c.pos = seq - 1
    return dict(kind="decode", batch=decode_batch_specs(cfg, seq, gb), caches=caches)
