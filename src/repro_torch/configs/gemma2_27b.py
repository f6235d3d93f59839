"""Gemma-2 27B [arXiv:2408.00118; hf] — alternating local(4096)/global
attention, attention softcap 50, final-logit softcap 30, GeGLU."""
from repro_torch.models.config import LayerSpec, ModelConfig

config = ModelConfig(
    name="gemma2_27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab=256000,
    head_dim=128,
    group=(
        LayerSpec(kind="attn", mlp="dense", sliding_window=4096),
        LayerSpec(kind="attn", mlp="dense"),
    ),
    attn_softcap=50.0,
    logit_softcap=30.0,
    act="gelu",
    tie_embeddings=True,
)
