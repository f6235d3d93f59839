#!/usr/bin/env python3
"""Where the time of the superstep's sum goes on one NVIDIA card.

    python3 scripts/probe_segmented_sum.py

Builds `bsp_superstep.cu` twice from `src/repro_torch/kernels/csrc` into
build/probe/: as it is, and with the gather of `csrc/segmented_sum.cuh`
replaced by the edge weight alone (the stream and the scan without the
gathers). Runs each on a synthetic PageRank-like stream at the full-width
shape of `chip_smoke.py` (p=32 workers, 2,110,464 edges and 249,537 values
a worker; skewed, dst-sorted destinations and skewed sources, made on the
card from a seed) and reads each kernel's device time from
`torch.profiler`. Prints one JSON line. Needs a CUDA card.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
GATHER = "(double)__fmul_rn(__ldg(g + in.s[k]), in.w[k])"
P, E, N = 32, 2_110_464, 249_537
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)


def inputs(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    skew = lambda: (N * torch.rand((P, E), generator=gen, device=dev) ** 2).long().clamp(max=N - 1)
    ldst = skew().sort(dim=1).values.int()
    lsrc = skew().int()
    w = torch.rand((P, E), generator=gen, device=dev)
    val = torch.rand((P, N), generator=gen, device=dev)
    deg = torch.randint(0, 10, (P, N), generator=gen, device=dev).float()
    return lsrc, ldst, w, val, deg


def kernel_us(fn, reps=10):
    """Mean device time of each kernel fn() launches, by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {re.search(r"bsp_\w+", e.key).group(0): e.device_time_total / e.count
            for e in prof.key_averages() if "bsp_" in e.key}


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_segmented_sum: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import bsp_superstep as bsp, dispatch

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    lsrc, ldst, w, val, deg = inputs(dev)
    kw = dict(num_out=N, combine="sum", out_degree=deg)
    want = bsp.bsp_superstep_plain(lsrc, ldst, w, val, **kw)[0]
    header = (dispatch.CSRC / "segmented_sum.cuh").read_text()
    assert GATHER in header, "the gather this probe replaces has changed"
    variants = {"as_is": header, "no_gather": header.replace(GATHER, "(double)in.w[k]")}
    result = dict(card=card, shape=f"[{P}, {E}] stream, [{P}, {N}] values", us={})
    for name, text in variants.items():
        csrc = ROOT / "build" / "probe" / name / "csrc"
        shutil.rmtree(csrc, ignore_errors=True)
        shutil.copytree(dispatch.CSRC, csrc)
        (csrc / "segmented_sum.cuh").write_text(text)
        dispatch.CSRC, dispatch.BUILD_DIR = csrc, csrc.parent / "build"
        dispatch._LIBS.clear()
        dispatch._FUNCTIONS.clear()
        got = bsp.bsp_superstep(lsrc, ldst, w, val, **kw)[0]
        if name == "as_is":
            assert torch.allclose(got, want, rtol=1e-5, atol=1e-8), "the sum kernel is wrong"
        result["us"][name] = kernel_us(lambda: bsp.bsp_superstep(lsrc, ldst, w, val, **kw))
    stream_us = result["us"]["no_gather"]["bsp_sum_kernel"]
    result["stream_tb_per_s_without_gathers"] = 12.0 * P * E / (stream_us * 1e-6) / 1e12
    result["stream_share_of_hbm_without_gathers"] = (12.0 * P * E / (stream_us * 1e-6)
                                                     / HBM_BYTES_PER_S)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
