#!/usr/bin/env python3
"""Time the membership bitset's two transposes on one NVIDIA card.

    python3 scripts/probe_memb_transpose.py [--old-src DIR] [--reps 200]

Builds `csrc/memb_transpose.cuh` (the kernel as it is) and, with
`--old-src`, the same header of another tree's `src` directory (for
example the parent commit's, unpacked with `git archive`) into
build/probe_membt/, each behind a one-function C entry, and times both in
one process: keep -> memb and memb -> keep at the full width's bitset
(keep [32, 131,072] <-> memb [2^22, 1]), at the sharded out-of-core path's
(keep [32, 16], a block's gathered bitset), and past one memb word (p =
33, 1,000 and 2,048). A time is the mean of `--reps` back-to-back bare
launches between two CUDA events, best of 3, the trees in turns (this,
old, old, this); this tree's also as 100 launches captured in one CUDA
graph (the device's time a launch, no host work between them). This
tree's results are checked bitwise against the plain versions
(`keep_bits_to_memb_plain`, `memb_to_keep_bits_plain`) and the round
trip; the old tree's against this tree's. The bytes bound of a
launch: the words read and written once over 3.35 TB/s. One JSON object
a shape on stdout, and the card's name and power limit. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PROBE_DIR = ROOT / "build" / "probe_membt"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
SHAPES = ((32, 131_072), (32, 16), (33, 131_072), (1000, 4096), (2048, 4096))  # (p, vw)

ENTRY = r"""
#include "memb_transpose.cuh"
extern "C" int probe_transpose(const void* src, void* dst, int p, int vw, int to_memb,
                               void* stream) {
  return (int)membt::launch_transpose(static_cast<const uint32_t*>(src),
                                      static_cast<uint32_t*>(dst), p, vw, to_memb != 0,
                                      static_cast<cudaStream_t>(stream));
}
"""


def build(srcs: dict) -> dict:
    """One library a tree, every nvcc started at once: {tree: CDLL}."""
    from repro_torch.kernels import dispatch

    procs = {}
    for tree, csrc in srcs.items():
        d = PROBE_DIR / tree
        d.mkdir(parents=True, exist_ok=True)
        (d / "entry.cu").write_text(ENTRY)
        out = d / "libprobe.so"
        cmd = [dispatch._nvcc(), *dispatch.NVCC_FLAGS, "-I", str(csrc), "-o", str(out),
               str(d / "entry.cu")]
        procs[tree] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    libs = {}
    for tree, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tree}:\n{log}")
        lib = ctypes.CDLL(str(out))
        lib.probe_transpose.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        libs[tree] = (lib, log)
    return libs


def run(lib, src, dst, p, vw, to_memb) -> None:
    from repro_torch.kernels.dispatch import cuda_stream_handle

    err = lib.probe_transpose(src.data_ptr(), dst.data_ptr(), p, vw, int(to_memb),
                              cuda_stream_handle())
    if err:
        raise RuntimeError(f"probe_transpose failed: cudaError_t {err}")


def event_ms(fn, reps: int) -> float:
    """Best of 3: the mean of `reps` back-to-back calls between two events."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / reps)
    return best


def graph_ms(fn, n: int = 100) -> float:
    """Device ms a launch of `n` captured in one CUDA graph, replayed (no
    host work between the launches: the device's own floor)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    return event_ms(g.replay, 3) / n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-src", type=Path, default=None,
                    help="another tree's src directory, whose kernel is timed beside this one")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_memb_transpose: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import dispatch, ebg_commit as ebg

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    print(card)
    srcs = {"this": dispatch.CSRC}
    if args.old_src is not None:
        srcs["old"] = args.old_src.resolve() / "repro_torch" / "kernels" / "csrc"
    libs = build(srcs)
    for tree, (_, log) in libs.items():
        print(json.dumps({"tree": tree, "ptxas": [ln for ln in log.splitlines()
                                                  if "registers" in ln or "spill" in ln]}))
    order = ["this", "old", "old", "this"] if "old" in libs else ["this"]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for p, vw in SHAPES:
        keep = torch.randint(-2**31, 2**31 - 1, (p, vw), generator=gen, device=dev,
                             dtype=torch.int32)
        W = (p + 31) // 32
        memb = torch.empty((32 * vw, W), dtype=torch.int32, device=dev)
        back = torch.empty_like(keep)
        lib = libs["this"][0]
        run(lib, keep, memb, p, vw, True)
        run(lib, memb, back, p, vw, False)
        torch.cuda.synchronize()
        ok = (torch.equal(memb, ebg.keep_bits_to_memb_plain(keep))
              and torch.equal(back, keep))
        rand = torch.randint(-2**31, 2**31 - 1, (32 * vw, W), generator=gen, device=dev,
                             dtype=torch.int32)
        run(lib, rand, back, p, vw, False)
        ok = ok and torch.equal(back, ebg.memb_to_keep_bits_plain(rand, p))
        if "old" in libs:
            old_memb, old_back = torch.empty_like(memb), torch.empty_like(keep)
            run(libs["old"][0], keep, old_memb, p, vw, True)
            run(libs["old"][0], rand, old_back, p, vw, False)
            ok = ok and torch.equal(old_memb, memb) and torch.equal(old_back, back)
        times = {}
        for tree in order:
            lib = libs[tree][0]
            for name, src, dst, to_memb in (("to_memb", keep, memb, True),
                                            ("to_keep", memb, back, False)):
                ms = event_ms(lambda: run(lib, src, dst, p, vw, to_memb), args.reps)
                times.setdefault(f"{tree}_{name}_ms", []).append(ms)
        for name, src, dst, to_memb in (("to_memb", keep, memb, True),
                                        ("to_keep", memb, back, False)):
            times[f"this_{name}_graph_ms"] = [
                graph_ms(lambda: run(libs["this"][0], src, dst, p, vw, to_memb))]
        bound_ms = 1e3 * 4 * (keep.numel() + memb.numel()) / HBM_BYTES_PER_S
        print(json.dumps(dict(p=p, vw=vw, memb=list(memb.shape), bitwise=ok, bound_ms=bound_ms,
                              **{k: min(v) for k, v in times.items()}, turns=times,
                              card=card)))
        if not ok:
            print(f"probe_memb_transpose: p={p}, vw={vw} differs", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
