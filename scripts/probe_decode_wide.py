#!/usr/bin/env python3
"""Time `decode_attention` past head_dim 512 (`csrc/decode_attn_wide.cu`)
on one NVIDIA card.

    python3 scripts/probe_decode_wide.py [--old-src DIR] [--variants] [--reps 100]

Builds `csrc/decode_attn_wide.cu` as it is and, with `--old-src`, the same
source of another tree's `src` directory (for example the parent commit's,
unpacked with `git archive`) into build/probe_wide/; with `--variants`
also this tree's source with one design choice undone each (VARIANTS: the
L2 evict-first hint on the copies, the merge as a plain launch or let in
from the split kernel's start, no arithmetic at all: the data path's
floor). It times them all in one process over chip_smoke.py's WIDEST_ATTN
shape (B 2, Hq 8 over Hkv 2, head_dim 1,024, 2,048 keys of a bf16 cache)
with a bf16 and an f32 query, softcap 0 and 50, and over head_dims 640,
1,536 and 4,096 at the same keys. A time is the mean of `--reps`
back-to-back bare launches of the C entry between two CUDA events, best of
3, the builds in turns (this, the others, the others backwards, this).
Each build's output is held against the plain version
(`decode_attention_plain`) at chip_smoke.py's ATTN_TOL with its x1.01
control (but no_math's); this tree's launches are split between its
kernels by torch.profiler (device µs a kernel). The C entries of the two
trees differ (before the split-S redesign: no split count, a workspace of
the scores); the probe reads which one a source has from its text. The
bytes bound: q, K, V read once and the output written once over 3.35
TB/s. One JSON object a case on stdout, and the card's name and power
limit. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PROBE_DIR = ROOT / "build" / "probe_wide"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
CASES = (  # (D, q dtype, softcap)
    (1024, torch.bfloat16, 0.0), (1024, torch.float32, 0.0), (1024, torch.bfloat16, 50.0),
    (1024, torch.float32, 50.0), (640, torch.bfloat16, 0.0), (1536, torch.bfloat16, 0.0),
    (4096, torch.bfloat16, 0.0))


# Variants of this tree's source (--variants): (text, replacement) edits
# that undo one design choice each, to show what it is worth.
VARIANTS = {
    # the L2 evict-first hint decode_attn.cu gives its bulk copies
    "evict_first": [
        ("uint64_t* bar) {\n  asm volatile(\n      \"cp.async.bulk",
         "uint64_t* bar) {\n  unsigned long long policy;\n  asm volatile("
         '"createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\\n" : "=l"(policy));\n'
         '  asm volatile(\n      "cp.async.bulk'),
        ("complete_tx::bytes [%0], [%1], %2, [%3];",
         "complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], %4;"),
        ('"r"(bytes), "r"(smem_u32(bar)) : "memory");',
         '"r"(bytes), "r"(smem_u32(bar)), "l"(policy) : "memory");')],
    # the merge as a plain launch, not a programmatic dependent
    "merge_plain_launch": [("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;")],
    # the merge's CTAs allowed in from the split kernel's start
    "merge_early": [
        ('  asm volatile("griddepcontrol.launch_dependents;\\n" ::: "memory");\n  if (nsplit > 1',
         "  if (nsplit > 1"),
        ("  const size_t rs = (size_t)Hkv * D;",
         '  asm volatile("griddepcontrol.launch_dependents;\\n" ::: "memory");\n'
         "  const size_t rs = (size_t)Hkv * D;")],
    # no score or P·V arithmetic: the ring, the syncs and the writes alone
    "no_math": [("      if (cc < nch) {", "      if (cc < nch && D < 0) {"),
                ("    if (ch < nch) {\n#pragma unroll\n      for (int jj",
                 "    if (ch < nch && D < 0) {\n#pragma unroll\n      for (int jj")],
}


def build(srcs: dict) -> dict:
    """One library a tree or variant, every nvcc started at once: {name: (CDLL,
    split API, ptxas)}. A source is a csrc directory or the text itself."""
    from repro_torch.kernels import dispatch

    procs = {}
    for tree, csrc in srcs.items():
        d = PROBE_DIR / tree
        d.mkdir(parents=True, exist_ok=True)
        src = d / "decode_attn_wide.cu"
        if isinstance(csrc, str):
            src.write_text(csrc)
        else:
            shutil.copyfile(csrc / "decode_attn_wide.cu", src)
        split_api = "int D, int nsplit)" in src.read_text()
        out = d / "libwide.so"
        cmd = [dispatch._nvcc(), *dispatch.NVCC_FLAGS, "-o", str(out), str(src)]
        procs[tree] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out, split_api)
    libs = {}
    for tree, (proc, out, split_api) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tree}:\n{log}")
        lib = ctypes.CDLL(str(out))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.decode_attn_wide_workspace.argtypes = [ci] * (5 if split_api else 4)
        lib.decode_attn_wide_workspace.restype = ctypes.c_longlong
        lib.decode_attn_wide_launch.argtypes = (
            [vp] * 5 + [ctypes.c_longlong] + [ci] * 8 + [ctypes.c_float] * 2
            + ([ci] if split_api else []) + [vp])
        libs[tree] = (lib, split_api, log)
    return libs


def launcher(lib, split_api, q, k, v, softcap, sms):
    """A zero-argument bare launch of a tree's C entry over all keys, and its output."""
    from repro_torch.kernels import decode_attn
    from repro_torch.kernels.dispatch import cuda_stream_handle

    (B, Hq, D), (S, Hkv) = q.shape, k.shape[1:3]
    G = Hq // Hkv
    extra = []
    if split_api:
        nsplit = decode_attn.wide_split_count(B, S, Hkv, G, sms)
        floats = lib.decode_attn_wide_workspace(B, Hkv, G, D, nsplit)
        extra = [nsplit]
    else:
        floats = lib.decode_attn_wide_workspace(B, Hkv, G, S)
    ws = torch.empty((max(floats, 1),), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ws.data_ptr(),
            ws.numel(), B, S, 0, S, Hkv, G, D, decode_attn.DTYPE_CODES[q.dtype, k.dtype],
            1.0 / math.sqrt(D), float(softcap), *extra, cuda_stream_handle()]

    def launch(buffers=(ws, out)):
        err = lib.decode_attn_wide_launch(*args)
        if err:
            raise RuntimeError(f"decode_attn_wide_launch failed: cudaError_t {err}")

    return launch, out


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


def kernel_split(launch, reps: int = 20) -> dict:
    """Device µs a launch of each kernel a call runs (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        total = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if e.count and total:
            out[e.key[:60]] = total / e.count
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-src", type=Path, default=None,
                    help="another tree's src directory, whose kernel is timed beside this one")
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--variants", action="store_true",
                    help="also time this tree's source with each edit of VARIANTS undone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_decode_wide: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import ATTN_CONTROL, ATTN_TOL, WIDEST_ATTN, over_limit
    from repro_torch.kernels import decode_attn, dispatch

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    print(card)
    srcs = {"this": dispatch.CSRC}
    if args.old_src is not None:
        srcs["old"] = args.old_src.resolve() / "repro_torch" / "kernels" / "csrc"
    if args.variants:
        text = (dispatch.CSRC / "decode_attn_wide.cu").read_text()
        for name, edits in VARIANTS.items():
            var = text
            for a, b in edits:
                if a not in var:
                    raise RuntimeError(f"variant {name}: its anchor is not in the source")
                var = var.replace(a, b)
            srcs[name] = var
    libs = build(srcs)
    for tree, (_, split_api, log) in libs.items():
        print(json.dumps({"tree": tree, "split_api": split_api,
                          "ptxas": [ln.strip() for ln in log.splitlines()
                                    if "registers" in ln or "spill" in ln
                                    or "Compiling entry" in ln]}))
    others = [name for name in libs if name != "this"]
    order = ["this", *others, *others[::-1], "this"]
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    c = WIDEST_ATTN
    B, Hq, Hkv, S = c["B"], c["Hq"], c["Hkv"], c["S"]
    failed = False
    for D, qt, softcap in CASES:
        gen = torch.Generator(device=dev).manual_seed(D)
        q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
                   for shape in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
        q = q.to(qt)
        want = decode_attn.decode_attention_plain(q, k, v, softcap=softcap).float()
        rtol, atol = ATTN_TOL[qt]
        launches, checks = {}, {}
        for tree, (lib, split_api, _) in libs.items():
            launch, out = launcher(lib, split_api, q, k, v, softcap, sms)
            launch()
            torch.cuda.synchronize()
            got = out.float()
            checks[tree] = dict(over_limit=over_limit(got, want, rtol, atol),
                                control_over_limit=over_limit(ATTN_CONTROL * got, want, rtol,
                                                              atol),
                                max_abs_err=float((got - want).abs().max()))
            if tree != "no_math":  # (its output is wrong by design)
                failed |= not (checks[tree]["over_limit"] <= 1.0
                               < checks[tree]["control_over_limit"])
            launches[tree] = launch
        times = {}
        for tree in order:
            times.setdefault(f"{tree}_ms", []).append(event_ms(launches[tree], args.reps))
        split = kernel_split(launches["this"])
        io = (q.numel() * q.element_size() * 2 + 2 * k.numel() * k.element_size())
        G = Hq // Hkv
        print(json.dumps(dict(
            D=D, q=str(qt).replace("torch.", ""), softcap=softcap, B=B, Hq=Hq, Hkv=Hkv, S=S,
            nsplit=decode_attn.wide_split_count(B, S, Hkv, G, sms),
            stages_h100=decode_attn.wide_stages(G, k.dtype), bound_ms=1e3 * io / HBM_BYTES_PER_S,
            **{key: min(val) for key, val in times.items()}, turns=times, checks=checks,
            this_kernels_us=split, card=card)))
        del q, k, v, launches
        torch.cuda.empty_cache()
    if failed:
        print("probe_decode_wide: a tree differs from the plain version", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
