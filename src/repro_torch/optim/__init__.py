"""repro_torch.optim — the optimizer of the LM training step (port of
`repro.optim`): AdamW with dtype-configurable states, global-norm clipping,
a linear-warmup cosine schedule and optional bf16 gradient compression."""
from repro_torch.optim.adam import AdamWConfig, apply_updates, init_opt_state

__all__ = ["AdamWConfig", "apply_updates", "init_opt_state"]
