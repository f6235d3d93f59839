"""Qwen3-4B [hf:Qwen/Qwen3-4B; hf] — QK-norm, GQA."""
from repro_torch.models.config import LayerSpec, ModelConfig

config = ModelConfig(
    name="qwen3_4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    vocab=151936,
    head_dim=128,
    group=(LayerSpec(kind="attn", mlp="dense"),),
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
)
