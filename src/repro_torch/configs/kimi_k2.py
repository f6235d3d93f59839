"""Kimi K2 1T (32B active) [arXiv:2501.kimi2; unverified, paper-table] —
384 experts top-8. Divergence note: the real model's dense first layer and
shared expert are folded into the uniform MoE stack."""
from repro_torch.models.config import LayerSpec, ModelConfig, MoEConfig

config = ModelConfig(
    name="kimi_k2",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    head_dim=112,
    group=(LayerSpec(kind="attn", mlp="moe"),),
    moe=MoEConfig(num_experts=384, top_k=8, d_ff=2048),
)
