"""Mamba2-780m [arXiv:2405.21060; unverified] — attention-free SSD."""
from repro_torch.models.config import LayerSpec, ModelConfig, SSMConfig

config = ModelConfig(
    name="mamba2_780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,      # unused (attn-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    head_dim=64,
    group=(LayerSpec(kind="ssm", mlp="none"),),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    tie_embeddings=True,
    sub_quadratic=True,
)
