#!/usr/bin/env python3
"""Decode-step time of the LM serving path for two source trees in one
process, turn by turn, so that the host's own drift between processes
does not enter the comparison.

    python3 scripts/probe_decode_inproc.py --base DIR [--rounds N] [--small]

DIR is the `src` of another tree (e.g. a commit unpacked by `git archive`
into build/parent). Its `repro_torch` is copied under build/ as the
package `repro_torch_base` (every name `repro_torch` in its sources
renamed), so both trees load side by side; each builds its kernels from
its own sources. For llama3_2_3b, phi3_5_moe (16 of its 32 layers: all 32
are ~84 GB in bf16, past an 80 GB card) and mamba2_780m at their published
widths, one set of bf16 weights drawn on the card from seed 0 serves both
trees: `launch.serve.generate` for B 8 prompts of 1,024 tokens and 32
greedy tokens, in the order base, this, this, base, repeated `--rounds`
times. Prints one JSON line: each call's decode ms a token at p50 (CUDA
events recorded as each step is enqueued), and whether the two trees'
tokens agreed. `--small` runs the reduced configs on the CPU (B 2,
prompts of 16, 8 tokens), to check the script itself.
"""
import argparse
import dataclasses
import importlib
import json
import re
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
LAYERS = {"phi3_5_moe": 16}  # the depth cut of a config past the card's memory
ARCHS = ("llama3_2_3b", "phi3_5_moe", "mamba2_780m")


def load_base(src: Path):
    """The tree under `src` as the package `repro_torch_base`."""
    dest = ROOT / "build" / "probe_base"
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(src / "repro_torch", dest / "src" / "repro_torch_base")
    for f in (dest / "src").rglob("*.py"):
        f.write_text(re.sub(r"\brepro_torch\b", "repro_torch_base", f.read_text()))
    sys.path.insert(0, str(dest / "src"))
    return {m: importlib.import_module(f"repro_torch_base.{m}")
            for m in ("configs", "kernels.dispatch", "launch.serve")}


def timed_generate(serve, cfg, params, prompt, new, dev):
    """(tokens, decode ms a token at p50) of one `generate` call."""
    marks = []

    def on_step(t, lg):
        if dev.type == "cuda":
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append(e)
        else:
            marks.append(time.perf_counter())

    if dev.type == "cuda":
        torch.cuda.synchronize()
    toks = serve.generate(cfg, params, prompt, new, prompt.shape[1] + new, on_step=on_step)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    return toks, float(np.percentile(ms, 50))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    if not args.small and not torch.cuda.is_available():
        print("probe_decode_inproc: needs a CUDA card (or --small)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    base = load_base(args.base.resolve())
    dev = torch.device("cpu") if args.small else torch.device("cuda", 0)
    B, S0, new = (2, 16, 8) if args.small else (8, 1024, 32)
    if dev.type == "cuda":
        dispatch.build_kernels()
        base["kernels.dispatch"].build_kernels()
    trees = {"this": (configs, serve), "base": (base["configs"], base["launch.serve"])}
    out = {"base": str(args.base), "rounds": args.rounds,
           "card": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"}
    for name in ARCHS:
        cfgs = {}
        for side, (cmod, _) in trees.items():
            cfg = cmod.reduced_config(name) if args.small else cmod.get_config(name)
            if name in LAYERS and not args.small:
                cfg = dataclasses.replace(cfg, n_layers=LAYERS[name])
            cfgs[side] = cfg
        params = transformer.init_params(cfgs["this"], torch.Generator(device=dev).manual_seed(0),
                                         torch.bfloat16)
        prompt = torch.from_numpy(np.random.default_rng(0).integers(0, cfgs["this"].vocab,
                                                                    (B, S0))).to(dev)
        for side, (_, smod) in trees.items():  # warm-up: cuBLAS, the allocator
            smod.generate(cfgs[side], params, prompt[:, :min(64, S0)], 4, min(64, S0) + 4)
        ms = {"this": [], "base": []}
        toks = {}
        for _ in range(args.rounds):
            for side in ("base", "this", "this", "base"):
                toks[side], t = timed_generate(trees[side][1], cfgs[side], params, prompt, new,
                                               dev)
                ms[side].append(t)
        for side in ms:
            out[f"{name}_{side}_decode_ms_p50"] = ms[side]
            out[f"{name}_{side}_median"] = float(np.median(ms[side]))
        out[f"{name}_tokens_equal"] = bool(torch.equal(toks["this"], toks["base"]))
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
