#!/usr/bin/env python3
"""Where the time of the membership kernel goes on one NVIDIA card.

    python3 scripts/probe_ebg_membership.py [--rounds 3]

Builds `ebg_membership.cu` from `src/repro_torch/kernels/csrc` into
build/probe_memb/ as it is and in variants (VARIANTS below): 8 or 16 edges
a thread instead of 4; plain stores instead of streaming ones
(st.global.cs); and no gathers at all (each endpoint's word made from its
id), which times the stores alone and is not checked.

Input, at chip_smoke's full-width shape: a random (32, 131,072)-word
bitset with one bit in ten set (RF ~3.2 over 32 parts) and 2^22 edges of
uniform endpoints over 2^22 vertices, made on the card from a seed. Holds
each build but `no_gather` against the plain version (bitwise), then times
the main kernel of each build in turns, `--rounds` times (CUDA events over
20 launches, no host read of the id flag), beside the transpose alone and
the wrapper's whole call, and prints one JSON line. Needs a CUDA card.
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
P, VW, E = 32, 131_072, 1 << 22
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# (old, new) text of each variant of csrc/ebg_membership.cu.
VARIANTS = {
    "as_is": [],
    "edges8": [("constexpr int kEdges = 4;", "constexpr int kEdges = 8;")],
    "edges16": [("constexpr int kEdges = 4;", "constexpr int kEdges = 16;")],
    "plain_store": [("float4 x) { __stcs(p, x); }", "float4 x) { *p = x; }"),
                    ("float x) { __stcs(p, x); }", "float x) { *p = x; }")],
    "no_gather": [("return __ldg(memb + (size_t)id * W + w);",
                   "return (uint32_t)id * 2654435761u + (uint32_t)w;")],
}


def event_ms(fn, reps=20):
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
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_ebg_membership: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import dispatch, ebg_score, ops

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(0)
    keep = ops.pack_keep_bits(torch.rand((P, 32 * VW), generator=gen, device=dev) < 0.1)
    u, v = (torch.randint(0, 32 * VW, (E,), generator=gen, device=dev, dtype=torch.int32)
            for _ in range(2))
    want = ebg_score.ebg_membership_plain(keep, u, v)
    out_bytes = want.numel() * 4
    result = dict(card=card, shape=f"bitset ({P}, {VW}), {E} edges -> ({P}, {E}) f32",
                  bound_ms=1e3 * (out_bytes + keep.numel() * 4 + 2 * E * 4) / HBM_BYTES_PER_S,
                  ms={name: [] for name in VARIANTS})
    source = (dispatch.CSRC / "ebg_membership.cu").read_text()
    csrc0 = dispatch.CSRC
    functions = {}  # each build's loaded C entries
    memb = None
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            assert old in text, f"{name}: the text this variant edits has changed"
            text = text.replace(old, new)
        csrc = ROOT / "build" / "probe_memb" / name / "csrc"
        shutil.rmtree(csrc, ignore_errors=True)
        shutil.copytree(csrc0, csrc)
        (csrc / "ebg_membership.cu").write_text(text)
        dispatch.CSRC, dispatch.BUILD_DIR = csrc, csrc.parent / "build"
        dispatch._LIBS.clear()
        dispatch._FUNCTIONS.clear()
        if memb is None:
            memb = ebg_score.keep_to_memb(keep)
        got, err = ebg_score.launch_main(memb, u, v, P)
        torch.cuda.synchronize()
        assert int(err) == 0, f"{name}: the id guard fired"
        if name != "no_gather":
            assert torch.equal(got, want), f"{name}: differs from the plain version"
        if name == "as_is":
            result["call_ms"] = event_ms(lambda: ebg_score.ebg_membership(keep, u, v))
            result["transpose_ms"] = event_ms(lambda: ebg_score.keep_to_memb(keep))
        functions[name] = dict(dispatch._FUNCTIONS)
        del got
    out = torch.empty((P, E), device=dev)
    for _ in range(args.rounds):
        for name in VARIANTS:
            dispatch._FUNCTIONS.clear()
            dispatch._FUNCTIONS.update(functions[name])
            result["ms"][name].append(event_ms(lambda: ebg_score.launch_main(memb, u, v, P)))
    # A plain write of the output's bytes, as the yardstick of the stores.
    result["fill_ms"] = event_ms(lambda: out.fill_(1.0))
    result["write_tb_per_s"] = {name: out_bytes / (min(ms) * 1e-3) / 1e12
                                for name, ms in result["ms"].items()}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
