"""Jamba-1.5-Large 398B [arXiv:2403.19887; hf] — 1:7 attention:mamba
interleave in period-8 blocks, MoE (16e top-2) every other layer.
Divergence note: mamba layers use our mamba2/SSD mixer (d_state=128)
instead of the original mamba1 (d_state=16)."""
from repro_torch.models.config import LayerSpec, ModelConfig, MoEConfig, SSMConfig

_block = []
for i in range(8):
    kind = "attn" if i == 4 else "ssm"
    mlp = "moe" if i % 2 == 1 else "dense"
    _block.append(LayerSpec(kind=kind, mlp=mlp))

config = ModelConfig(
    name="jamba_1_5_large",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    head_dim=128,
    group=tuple(_block),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff=24576),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=128, chunk=256),
    sub_quadratic=True,
)
