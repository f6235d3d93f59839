"""The training presets (port of `repro.launch.train`'s `PRESETS` and
`preset_config`), which the serving driver shares. The training loop
itself (data pipeline, AdamW, checkpointed steps) comes with the training
slice of the port.
"""
from __future__ import annotations

from repro_torch.models.config import LayerSpec, ModelConfig

PRESETS = {
    # name: (d_model, n_layers, n_heads, kv, d_ff, vocab)  ~params
    "tiny": (128, 4, 4, 2, 512, 2048),  # ~2M — quick demos
    "small": (256, 6, 8, 4, 1024, 8192),  # ~12M
    "base": (512, 12, 8, 4, 2048, 32768),  # ~100M
}


def preset_config(name: str) -> ModelConfig:
    d, L, H, kv, f, v = PRESETS[name]
    return ModelConfig(
        name=f"preset_{name}",
        family="dense",
        n_layers=L,
        d_model=d,
        n_heads=H,
        n_kv_heads=kv,
        d_ff=f,
        vocab=v,
        group=(LayerSpec(kind="attn", mlp="dense"),),
        tie_embeddings=True,
    )
