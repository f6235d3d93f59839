#!/usr/bin/env python3
"""Decode-step time of the LM serving path at full width on the card, for
an A/B of two source trees or of the process environment.

    python3 scripts/probe_decode_ab.py [--src DIR] [--label NAME]

Builds the kernels of the `repro_torch` under DIR (default: this
repository's `src`), then runs `launch.serve.generate` for llama3_2_3b,
phi3_5_moe (16 of its 32 layers: all 32 are ~84 GB in bf16, past an 80 GB
card) and mamba2_780m at their published widths (bf16 weights drawn on the
card from seed 0, B 8 prompts of 1,024 tokens, 32 greedy tokens) twice
each, and prints one JSON line: each run's decode ms a token at p50 (CUDA
events recorded as each step is enqueued) and the process's
CUBLAS_WORKSPACE_CONFIG. Run it in one call once a process for each side,
in turns, e.g. another commit unpacked by `git archive` into build/parent:

    env -u CUBLAS_WORKSPACE_CONFIG python3 scripts/probe_decode_ab.py --src build/parent/src
    CUBLAS_WORKSPACE_CONFIG=:4096:8 python3 scripts/probe_decode_ab.py --label cublas_cfg
"""
import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

LAYERS = {"phi3_5_moe": 16}  # the depth cut of a config past the card's memory


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=Path(__file__).resolve().parents[1] / "src")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_decode_ab: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch import configs
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer

    dev = torch.device("cuda", 0)
    dispatch.build_kernels()
    out = {"label": args.label, "src": str(args.src),
           "cublas_workspace_config": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
           "card": torch.cuda.get_device_name(0)}
    for name in ("llama3_2_3b", "phi3_5_moe", "mamba2_780m"):
        cfg = configs.get_config(name)
        if name in LAYERS:
            cfg = dataclasses.replace(cfg, n_layers=LAYERS[name])
        params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                         torch.bfloat16)
        prompt = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (8, 1024)))
        prompt = prompt.to(dev)
        generate(cfg, params, prompt[:, :64], 4, 68)  # warm-up
        for rep in range(2):
            events = []

            def on_step(t, lg):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                events.append(e)

            torch.cuda.synchronize()
            generate(cfg, params, prompt, 32, 1024 + 32, on_step=on_step)
            torch.cuda.synchronize()
            ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
            out[f"{name}_decode_ms_p50_{rep}"] = float(np.percentile(ms, 50))
        del params
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
