#!/usr/bin/env python3
"""Where the time of the superstep's min goes on one NVIDIA card.

    python3 scripts/probe_bsp_min.py [--graph synthetic|full] [--rounds 3]

Builds `bsp_superstep.cu` from `src/repro_torch/kernels/csrc` into
build/probe_min/ as it is and in variants (VARIANTS below): the runs'
segmented min taken across the CTA (with its two barriers a tile) rather
than in a warp; the values or the frontier read through L2 only (no
tagged L1 read); the frontier read in every pass after the first, or in
none (as it is, a pass reads it when at most half of the active workers'
vertices changed in the pass before).

The stream: `synthetic` (default) is made on the card from a seed at the
full-width shape of `chip_smoke.py` (p=32 workers, 249,537 values and
8,441,856 edges a worker: an R-MAT-like skewed graph's edges in both
directions, each half dst-sorted, weight 0, values the vertices' ids);
`full` is the first CC superstep's stream of chip_smoke's full-width graph
(R-MAT, 2^22 vertices, 2^26 edges, p=32, ebg_chunked), ~7 minutes of host
work to make. Holds each build against the plain version (values and
iteration counts, bitwise), then times the builds in turns, `--rounds`
times each (CUDA events over 5 calls, no host read of the id flag), and
prints one JSON line with every time and each build's edges taken a pass.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
P, E, N = 32, 8_441_856, 249_537
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# (old, new) text of each variant of csrc/bsp_superstep.cu.
_RULE = "kFrontierShare * __ldcg(nchg + ((pass - 1) & 1)) <="
VARIANTS = {
    "as_is": [],
    "cta_scan": [("tile_scan<segsum::MinI32, false>", "tile_scan<segsum::MinI32, true>")],
    "vals_l2": [("y.g[k] = __ldca(prev + s);", "y.g[k] = __ldcg(prev + s);")],
    "front_l2": [("pass < kNoTag ? __ldca(fr + s / kFrontBits) : 0u", "0u")],
    "always_front": [(_RULE, "0ull <=")],
    "never_front": [("const bool use_front = pass > 0 &&", "const bool use_front = false &&")],
}


def synthetic_cc_stream(dev):
    """Both directions of E/2 skewed edges over N vertices, each half
    dst-sorted, as the engine's symmetric CC stream is laid out."""
    gen = torch.Generator(device=dev).manual_seed(0)
    skew = lambda: (N * torch.rand((P, E // 2), generator=gen, device=dev) ** 3).long()
    a, b = skew().clamp(max=N - 1), torch.randint(0, N, (P, E // 2), generator=gen, device=dev)
    halves = []
    for s, d in ((a, b), (b, a)):
        d, order = d.sort(dim=1)
        halves.append((s.gather(1, order), d))
    lsrc = torch.cat([halves[0][0], halves[1][0]], dim=1).int().contiguous()
    ldst = torch.cat([halves[0][1], halves[1][1]], dim=1).int().contiguous()
    w = torch.zeros((P, E), device=dev)
    val = torch.arange(N, device=dev, dtype=torch.float32).repeat(P, 1).contiguous()
    return lsrc, ldst, w, val, N


def full_cc_stream(dev):
    """The first CC superstep's kernel inputs on chip_smoke's full-width graph."""
    from repro_torch.api.pipeline import GraphPipeline
    from repro_torch.graph import engine
    from repro_torch.graph.generate import rmat

    g = rmat(num_vertices=1 << 22, num_edges=1 << 26, a=0.57, b=0.19, c=0.19, seed=0)
    pipe = GraphPipeline(g, device=dev).partition("ebg_chunked", parts=P)
    sub = pipe.subgraphs_for(symmetrize=True)
    (lsrc, ldst, w, _), val, n = engine.kernel_inputs(sub, "cc", num_vertices=g.num_vertices)
    return lsrc, ldst, w, val, n


def event_ms(fn, reps=5):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graph", choices=("synthetic", "full"), default="synthetic")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_bsp_min: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import bsp_superstep as bsp, dispatch

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    make = full_cc_stream if args.graph == "full" else synthetic_cc_stream
    lsrc, ldst, w, val, n = make(dev)
    e = lsrc.shape[1]
    kw = dict(num_out=n, combine="min", inner_cap=10_000)
    want, want_it = bsp.bsp_superstep_plain(lsrc, ldst, w, val, **kw)
    passes = int((want_it + 1).sum())
    result = dict(card=card, graph=args.graph, shape=f"[{P}, {e}] stream, [{P}, {n}] values",
                  worker_passes=passes, iters=want_it.tolist(),
                  stream_pass_bound_ms=1e3 * passes * 12.0 * e / HBM_BYTES_PER_S,
                  ms={name: [] for name in VARIANTS}, pass_edges={})
    source = (dispatch.CSRC / "bsp_superstep.cu").read_text()
    csrc0 = dispatch.CSRC
    functions = {}  # each build's loaded C entries
    flag = torch.zeros((1,), dtype=torch.int32, device=dev)
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            assert old in text, f"{name}: the text this variant edits has changed"
            text = text.replace(old, new)
        csrc = ROOT / "build" / "probe_min" / name / "csrc"
        shutil.rmtree(csrc, ignore_errors=True)
        shutil.copytree(csrc0, csrc)
        (csrc / "bsp_superstep.cu").write_text(text)
        dispatch.CSRC, dispatch.BUILD_DIR = csrc, csrc.parent / "build"
        dispatch._LIBS.clear()
        dispatch._FUNCTIONS.clear()
        taken = torch.zeros((10_000,), dtype=torch.int64, device=dev)
        got, it = bsp.launch_flagged(lsrc, ldst, w, val, err=flag, taken=taken, **kw)
        assert torch.equal(it, want_it) and torch.equal(got, want), f"{name}: differs from plain"
        result["pass_edges"][name] = taken[:int(want_it.max()) + 1].tolist()
        functions[name] = dict(dispatch._FUNCTIONS)
    for _ in range(args.rounds):
        for name in VARIANTS:
            dispatch._FUNCTIONS.clear()
            dispatch._FUNCTIONS.update(functions[name])
            result["ms"][name].append(event_ms(
                lambda: bsp.launch_flagged(lsrc, ldst, w, val, err=flag, **kw)))
    result["plain_ms"] = event_ms(lambda: bsp.bsp_superstep_plain(lsrc, ldst, w, val, **kw),
                                  reps=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
