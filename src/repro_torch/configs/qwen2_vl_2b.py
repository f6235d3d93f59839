"""Qwen2-VL-2B [arXiv:2409.12191; hf] — M-RoPE, dynamic-resolution vision
frontend STUBBED (input_specs provides precomputed patch embeddings)."""
from repro_torch.models.config import LayerSpec, ModelConfig

config = ModelConfig(
    name="qwen2_vl_2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    head_dim=128,
    group=(LayerSpec(kind="attn", mlp="dense"),),
    qkv_bias=True,
    mrope_sections=(16, 24, 24),
    frontend="vision",
    rope_theta=1000000.0,
    tie_embeddings=True,
)
