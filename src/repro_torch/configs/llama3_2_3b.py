"""Llama-3.2-3B [hf:meta-llama/Llama-3.2-3B; unverified]."""
from repro_torch.models.config import LayerSpec, ModelConfig

config = ModelConfig(
    name="llama3_2_3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    head_dim=128,
    group=(LayerSpec(kind="attn", mlp="dense"),),
    rope_theta=500000.0,
    tie_embeddings=True,
)
