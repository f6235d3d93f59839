"""Batched LM serving driver (port of `repro.launch.serve`): prefill, then
greedy decode over per-layer KV caches. It runs on the CUDA card unless
`--device cpu` asks for the CPU (the kernels' plain versions).

  PYTHONPATH=src python -m repro_torch.launch.serve --preset tiny --tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --preset tiny

The flags are the reference's, plus `--device`. As there, the parameters
are f32 from a seeded random init and the caches bf16, so each decode step
attends with an f32 query over a bf16 cache. `--arch` takes the reduced
form of every config of the registry: the dense decoders, the MoE
(phi3_5_moe, kimi_k2), the SSM (mamba2_780m), the hybrid
(jamba_1_5_large) and the encoder-decoder (seamless_m4t_large_v2).
`generate`, as the reference's, passes no encoder input: seamless's cross
layers then attend over the decoder's own tokens (`models.transformer`).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch.train import PRESETS, preset_config
from repro_torch.models.steps import make_prefill_step, make_serve_step
from repro_torch.models.transformer import init_params
from repro_torch.serve.padding import bucket_size, pad_batch_rows


@torch.no_grad()
def generate(cfg, params, prompt_tokens, max_new: int, max_seq: int, *, on_step=None):
    """prompt_tokens: [B, S0] → greedy continuation [B, max_new], on the
    parameters' device. `on_step(t, logits)`, if given, sees the logits
    [B, vocab] of the prefill (t = 0) and of each decode step (t = 1 ..
    max_new) as they are enqueued; nothing here waits for the device."""
    dev = params.embed.device
    prompt = torch.as_tensor(prompt_tokens, dtype=torch.int64, device=dev)
    B, S0 = prompt.shape
    prefill = make_prefill_step(cfg, max_seq)
    serve = make_serve_step(cfg)
    logits, caches = prefill(params, dict(tokens=prompt))
    if on_step is not None:
        on_step(0, logits)
    out = []
    tok = torch.argmax(logits, dim=-1)[:, None]
    for t in range(max_new):
        out.append(tok)
        logits, caches = serve(params, caches, dict(token=tok, pos=S0 + t))
        if on_step is not None:
            on_step(t + 1, logits)
        tok = torch.argmax(logits, dim=-1)[:, None]
    return torch.cat(out, dim=1).to(torch.int32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--arch", default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.reduced_config(args.arch) if args.arch else preset_config(args.preset)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.float32)
    rng = np.random.default_rng(0)
    # Same padded-shape policy as the graph-query server: pad the request
    # batch to its bucket, run padded, return only the real rows.
    bucket = bucket_size(args.batch)
    prompt = pad_batch_rows(rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)), bucket)
    t0 = time.time()
    out = generate(cfg, params, prompt, args.tokens, args.prompt_len + args.tokens)
    out = out[: args.batch].cpu()
    dt = time.time() - t0
    total = args.batch * args.tokens
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(
        f"generated {total} tokens in {dt:.2f}s ({total/dt:.1f} tok/s, "
        f"batch {args.batch} padded to bucket {bucket}) on {name}"
    )
    print("sample:", out[0][:16].numpy())
    assert np.isfinite(dt)
    return out


if __name__ == "__main__":
    main()
