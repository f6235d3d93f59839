"""Config registry: one module per assigned architecture (+ the paper's
graph-engine config). `get_config(name)` returns the full published config;
`reduced_config(name)` returns a tiny same-family config for CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
import importlib

ARCHS = [
    "seamless_m4t_large_v2",
    "llama3_2_3b",
    "qwen2_72b",
    "gemma2_27b",
    "qwen3_4b",
    "phi3_5_moe",
    "kimi_k2",
    "jamba_1_5_large",
    "mamba2_780m",
    "qwen2_vl_2b",
]

# Shape cells (system prompt): name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def get_config(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.config


def reduced_config(name: str):
    """Tiny same-family config: same group pattern, small dims."""
    from repro_torch.models.config import MoEConfig, SSMConfig

    cfg = get_config(name)
    kw: dict = dict(
        n_layers=len(cfg.group),
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        head_dim=16,
    )
    if cfg.moe is not None:
        # capacity_factor = E ⇒ cap = T·k: no token drops, so decode ≡ full
        # forward exactly (capacity dropping is shape-dependent otherwise).
        kw["moe"] = MoEConfig(num_experts=4, top_k=2, d_ff=64, capacity_factor=4.0)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16)
    if cfg.n_enc_layers:
        kw["n_enc_layers"] = 1
    if cfg.mrope_sections is not None:
        kw["mrope_sections"] = (2, 3, 3)
    return dataclasses.replace(cfg, **kw)


def runnable_shapes(name: str) -> list[str]:
    """Which shape cells run for this arch (DESIGN.md §4 skip rules)."""
    cfg = get_config(name)
    out = []
    for shape, (_, _, kind) in SHAPES.items():
        if kind == "decode" and not cfg.decoder:
            continue
        if shape == "long_500k" and not cfg.sub_quadratic:
            continue
        out.append(shape)
    return out
