"""Phi-3.5-MoE 42B (6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct; hf] —
16 experts, top-2, every layer MoE."""
from repro_torch.models.config import LayerSpec, ModelConfig, MoEConfig

config = ModelConfig(
    name="phi3_5_moe",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab=32064,
    head_dim=128,
    group=(LayerSpec(kind="attn", mlp="moe"),),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff=6400),
)
