#!/usr/bin/env python3
"""Does chip_smoke's hash-family host check slow the LM decode step that
runs beside it?

    python3 scripts/probe_hash_contention.py [--rounds 1] [--tokens 32] [--log2-edges 26]

chip_smoke checks the hash family's full-width partitions on the host
(`chip_smoke.hash_family_check`: the numpy splitmix64 and
`partition_metrics`) in threads, one a partitioner, beside its LM phases,
whose decode step is bound by the host's eager dispatch. This probe, on one
card, serves llama3_2_3b at its published widths (bf16 weights drawn on the
card from seed 0, B 8 prompts of 1,024 tokens, as chip_smoke's lm phase)
through `launch.serve.generate`, each decode step timed by CUDA events
recorded as it is enqueued, in three modes a round: alone (`--alone-calls`
generate calls); beside the checks in 3 threads (as chip_smoke runs them);
beside them in 1 thread (the three checks one after another). In a threaded
mode the generate calls repeat until the checks end, so the steps sample
their whole run. The checks run on a uniform random graph of 2^22 vertices
and 2^log2-edges edges, partitioned by hash, DBH and CVC on the card. One
JSON line a mode and round: decode ms a token at p50 and p90, the steps
timed, the checks' wall. Needs a card. A round takes ~12 minutes at the
default sizes (beside the decode loop the checks take 5-7 minutes a mode),
so give the chip call ~15 minutes a round.
"""
import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
MODES = (("alone", 0), ("threads3", 3), ("thread1", 1))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--alone-calls", type=int, default=5)
    ap.add_argument("--log2-edges", type=int, default=26)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_hash_contention: no CUDA device")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.core import PARTITIONERS
    from repro_torch.core.types import Graph
    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer
    from repro_torch.serve.padding import bucket_size, pad_batch_rows

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    dispatch.build_kernels(["decode_attn"])
    rng = np.random.default_rng(0)
    V, E = 1 << 22, 1 << args.log2_edges
    g = Graph(src=torch.from_numpy(rng.integers(0, V, E, dtype=np.int32)),
              dst=torch.from_numpy(rng.integers(0, V, E, dtype=np.int32)), num_vertices=V)
    parts = {name: PARTITIONERS[name](g, cs.PARTS, device=dev).part.cpu().numpy()
             for name in cs.HASH_FAMILY}
    cfg = configs.get_config(cs.LM["config"])
    params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                     torch.bfloat16)
    B, S0 = cs.LM["batch"], cs.LM["prompt_len"]
    prompt = pad_batch_rows(np.random.default_rng(0).integers(0, cfg.vocab, (B, S0)),
                            bucket_size(B))
    prompt = torch.from_numpy(prompt).to(dev)
    cs.lm_generate(cfg, params, prompt[:, :64], N=args.tokens)  # warm-up

    for r in range(args.rounds):
        for mode, workers in MODES:
            steps, checks_s = [], None
            if workers:
                t = time.perf_counter()
                with ThreadPoolExecutor(max_workers=workers) as pool:
                    checks = [pool.submit(cs.hash_family_check, g, name, parts[name], {})
                              for name in cs.HASH_FAMILY]
                    while not all(f.done() for f in checks):
                        steps += cs.lm_generate(cfg, params, prompt, N=args.tokens)[3]
                    for f in checks:
                        f.result()
                checks_s = time.perf_counter() - t
            else:
                for _ in range(args.alone_calls):
                    steps += cs.lm_generate(cfg, params, prompt, N=args.tokens)[3]
            print(json.dumps(dict(mode=mode, round=r, decode_ms_p50=float(np.median(steps)),
                                  decode_ms_p90=float(np.percentile(steps, 90)),
                                  steps=len(steps), checks_s=checks_s, card=smi)), flush=True)


if __name__ == "__main__":
    main()
