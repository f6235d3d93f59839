"""Qwen2-72B [arXiv:2407.10671; hf] — GQA with QKV bias."""
from repro_torch.models.config import LayerSpec, ModelConfig

config = ModelConfig(
    name="qwen2_72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    head_dim=128,
    group=(LayerSpec(kind="attn", mlp="dense"),),
    qkv_bias=True,
    rope_theta=1000000.0,
)
