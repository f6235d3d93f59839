"""AdamW (port of `repro.optim.adam`): dtype-configurable states, global-norm
clipping, a linear-warmup cosine schedule and optional bf16 gradient
compression.

The parameters are an `LM` (`repro_torch.models.transformer`), taken in
`named_parameters()` order; the gradients and the states `mu` and `nu` are
dicts keyed by the same names (a gradient that is None, a parameter the
loss did not reach, counts as zeros, as the reference's `jax.grad` gives
them). `step` is an int32 0-d tensor on the parameters' device, as the
reference's is an int32 array, so the schedule and the bias corrections
are f32 arithmetic on the device and nothing waits for the host.

The arithmetic is the reference's: `compress_grads="bf16"` casts the
gradients to bf16 before the norm; each update is computed in f32 and cast
to the parameter's dtype and to `state_dtype`. The parameters and the
states are updated in place, under `torch.no_grad()`, so a parameter keeps
its `requires_grad`. The sums of the norm run in another order than XLA's,
and XLA may contract a product and a sum into one FMA where the port
rounds twice: the parity tests hold an update to 1e-6 of the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    state_dtype: torch.dtype = torch.float32  # bf16 halves optimizer memory (big-MoE configs)
    compress_grads: Optional[str] = None  # None | "bf16"


def init_opt_state(params, cfg: AdamWConfig) -> dict:
    """Zero `mu` and `nu` in `state_dtype`, one a parameter, and `step` 0."""
    named = list(params.named_parameters())
    dev = named[0][1].device
    # zeros_like: a sharded (DTensor) parameter's states take its layout.
    zeros = {n: torch.zeros_like(p, dtype=cfg.state_dtype) for n, p in named}
    return dict(mu=zeros, nu={n: torch.zeros_like(z) for n, z in zeros.items()},
                step=torch.zeros((), dtype=torch.int32, device=dev))


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at `step` (an int32 tensor), in f32."""
    warm = torch.clamp((step + 1) / cfg.warmup_steps, max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps),
                       0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1 + torch.cos(math.pi * prog))


def _global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    total = 0
    for g in grads:
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, grads: dict, state: dict, cfg: AdamWConfig):
    """One AdamW step on `params` (in place) from `grads` {name: tensor or
    None}. Returns (params, state, dict(grad_norm=, lr=)), the metrics f32
    0-d tensors on the device."""
    named = list(params.named_parameters())
    flat_g = []
    for n, p in named:
        g = grads.get(n)
        flat_g.append(torch.zeros_like(p) if g is None else g)
    if cfg.compress_grads == "bf16":
        flat_g = [g.to(torch.bfloat16) for g in flat_g]
    gnorm = _global_norm(flat_g)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state["step"]
    lr = _schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    t = (step + 1).float()
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t
    for (n, p), g in zip(named, flat_g):
        mu, nu = state["mu"][n], state["nu"][n]
        g = g.float() * scale
        mu32 = mu.float() * b1 + (1 - b1) * g
        nu32 = nu.float() * b2 + (1 - b2) * g * g
        mhat = mu32 / bc1
        vhat = nu32 / bc2
        p32 = p.float()
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
        mu.copy_(mu32.to(cfg.state_dtype))
        nu.copy_(nu32.to(cfg.state_dtype))
    state["step"] = step + 1
    return params, state, dict(grad_norm=gnorm, lr=lr)
