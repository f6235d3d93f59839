"""End-to-end training driver (port of `repro.launch.train`). It runs on the
CUDA card unless `--device cpu` asks for the CPU; without a card and
without `--device cpu` it raises, it never falls back.

  PYTHONPATH=src python -m repro_torch.launch.train --preset tiny --steps 200
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --preset tiny --steps 40

The flags are the reference's, plus `--device`. What it exercises: the
deterministic restartable data pipeline (`data.pipeline`), AdamW
(`optim.adam`), checkpoint/restart through `checkpoint.ckpt` (`--resume`
picks up the latest step; the async writer overlaps the next steps), the
bf16 gradient compression flag. The parameters are f32 from
`init_params` with a `torch.Generator` seeded 0 on the device (not
jax.random's numbers). A checkpoint holds the parameters by name
(`params`) and the optimizer state (`opt`: `mu`, `nu` by name and the int32
`step`); a restore writes them into the model in place, so every
parameter keeps its `requires_grad`.

`PRESETS` and `preset_config` are shared with the serving driver.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import ckpt as CKPT
from repro_torch.data.pipeline import DataConfig, shard_batch_at_step
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.steps import make_train_step
from repro_torch.models.transformer import init_params
from repro_torch.optim.adam import AdamWConfig, init_opt_state

PRESETS = {
    # name: (d_model, n_layers, n_heads, kv, d_ff, vocab)  ~params
    "tiny": (128, 4, 4, 2, 512, 2048),  # ~2M — quick demos
    "small": (256, 6, 8, 4, 1024, 8192),  # ~12M
    "base": (512, 12, 8, 4, 2048, 32768),  # ~100M
}


def preset_config(name: str) -> ModelConfig:
    d, L, H, kv, f, v = PRESETS[name]
    return ModelConfig(
        name=f"preset_{name}",
        family="dense",
        n_layers=L,
        d_model=d,
        n_heads=H,
        n_kv_heads=kv,
        d_ff=f,
        vocab=v,
        group=(LayerSpec(kind="attn", mlp="dense"),),
        tie_embeddings=True,
    )


def train_state(params, opt_state) -> dict:
    """The checkpointed tree: the parameters by name and the optimizer
    state (tensors, not copies)."""
    return dict(params=dict(params.named_parameters()), opt=opt_state)


@torch.no_grad()
def restore_train_state(ckpt_dir, step: int, params, opt_state):
    """Restore checkpoint `step` into `params` (in place: each parameter
    keeps its tensor and its `requires_grad`) and `opt_state` (in place)."""
    state = CKPT.restore(ckpt_dir, step, train_state(params, opt_state))
    for name, p in params.named_parameters():
        p.copy_(state["params"][name])
    for key in ("mu", "nu"):
        for name, t in opt_state[key].items():
            t.copy_(state["opt"][key][name])
    opt_state["step"] = state["opt"]["step"]
    return params, opt_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--arch", default=None, help="use a reduced assigned arch instead")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the host)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.reduced_config(args.arch) if args.arch else preset_config(args.preset)
    opt = AdamWConfig(
        lr=args.lr,
        warmup_steps=20,
        total_steps=args.steps,
        compress_grads="bf16" if args.compress_grads else None,
    )
    data = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.float32)
    params.requires_grad_(True)
    opt_state = init_opt_state(params, opt)
    start = 0
    ckpter = None
    if args.ckpt_dir:
        ckpter = CKPT.AsyncCheckpointer(args.ckpt_dir)
        if args.resume:
            last = CKPT.latest_step(args.ckpt_dir)
            if last is not None:
                params, opt_state = restore_train_state(args.ckpt_dir, last, params, opt_state)
                start = last
                print(f"[resume] restored step {last}")

    step_fn = make_train_step(cfg, opt, remat=False)
    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = shard_batch_at_step(data, step, 0, 1, device=dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"step {step:5d}  loss {losses[-1]:.4f}  ({dt:.1f}s)")
        if ckpter and (step + 1) % args.ckpt_every == 0:
            ckpter.save(step + 1, train_state(params, opt_state))
    if ckpter:
        ckpter.save(args.steps, train_state(params, opt_state))
        ckpter.wait()
    print(f"final loss {np.mean(losses[-10:]):.4f} (first10 {np.mean(losses[:10]):.4f})")
    return losses


if __name__ == "__main__":
    main()
