"""SeamlessM4T-large v2 backbone [arXiv:2308.11596; hf] — enc-dec, audio
frontend STUBBED (input_specs provides precomputed frame embeddings).
Divergence note (DESIGN.md): RoPE replaces the original relative-position
encoding; conformer encoder blocks simplified to transformer blocks."""
from repro_torch.models.config import LayerSpec, ModelConfig

config = ModelConfig(
    name="seamless_m4t_large_v2",
    family="audio",
    n_layers=24,
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    group=(LayerSpec(kind="attn", mlp="dense", cross_attn=True),),
    frontend="audio",
    rope_theta=10000.0,
    sub_quadratic=False,
    decoder=True,
)
