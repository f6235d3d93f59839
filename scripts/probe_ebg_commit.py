#!/usr/bin/env python3
"""Where the time of the `ebg_commit` stream goes on one NVIDIA card.

    python3 scripts/probe_ebg_commit.py [--old-src DIR] [--blocks 512]

Generates chip_smoke.py's full-width graph (R-MAT, 2^22 vertices, 2^26
edges, p = 32, ebv, block 256, frozen commit), runs the stream through the
kernel up to its middle block, and from that state times `--blocks` blocks
in one launch of each kernel build. A build is compiled from a copy of a
`csrc` directory into build/probe/: `src/repro_torch/kernels/csrc` (the
kernel as it is) and, with `--old-src`, another tree's `src` directory
(for example the parent commit's, unpacked with `git archive`). Each is
built twice: as it is (its time a block, CUDA events) and with clock64()
stamps taken by thread 0 at the kernel's phase boundaries (the split of a
block's cycles between the phases). Every build's parts are checked
against the kernel's wrapper.

It also measures, in cycles, the dependent latency of the instructions
of the per-edge chain (a one-warp loop of each: FFMA, `redux`, `ballot`,
`ffs`, the +0 and order key) and of one link of the p <= 32 kernel's
chain in static mode as `chain()` runs it (the two speculative keys off
the chain; `redux` -> `ballot` -> the lowest lane at the min -> select),
and writes the kernel's SASS (`cuobjdump -sass`) to
chiprun_out/probe_ebg_commit_sass.txt. The chain floor is 256 × a link's
cycles over the SM clock of the run (thread 0's stamped cycles over the
stamped launch's time). Prints one JSON line; needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PROBE_DIR = ROOT / "build" / "probe"
OUT_DIR = ROOT / "chiprun_out"
BLOCK = 256

STAMP_HEADER = r"""
__device__ unsigned long long g_probe[8];
#define PROBE_T0 long long probe_t_ = clock64(); unsigned long long probe_acc_[8] = {0};
#define PROBE(k) if (threadIdx.x == 0) { const long long n_ = clock64(); \
  probe_acc_[k] += n_ - probe_t_; probe_t_ = n_; }
#define PROBE_END if (threadIdx.x == 0) { for (int i_ = 0; i_ < 8; ++i_) \
  atomicAdd(&g_probe[i_], probe_acc_[i_]); }
"""
STAMP_READ = r"""
extern "C" int probe_read(unsigned long long* out) {
  const int err = (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
  const unsigned long long zero[8] = {0};
  cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
  return err;
}
"""
# (anchor, text put before it) for each layout's kernel: the phases each
# PROBE(k) closes are named in PHASES.
STAMPS = {
    "old": [
        ("  for (int blk = 0; blk < nblocks; ++blk) {\n    const size_t base", "  PROBE_T0\n"),
        ("    // ---- 2. the sequential per-edge argmin", "    PROBE(0)\n"),
        ("    // ---- 3. commit the winners' membership bits", "    PROBE(1)\n"),
        ("  }\n  if (part_lane) {\n    e_count[t] = e_c;", "    PROBE(2)\n  }\n  PROBE_END\n//"),
    ],
    "new": [
        ("  for (int blk = 0; blk < nblocks; ++blk) {\n    const Buf cur", "  PROBE_T0\n"),
        ("    } else if (has_next) {\n      stage<WEIGHTED>", "      PROBE(0)\n"),
        ("    // ---- commit block b: its parts", "    PROBE(1)\n"),
        ("    // ---- patch block b+1's masks", "    PROBE(2)\n"),
        ("    if (warp != 0)\n      for (int i = t - 32; i < H;", "    PROBE(3)\n"),
        ("  if (t < p) {\n    e_count[t] = e_c;\n    v_count[t] = v_c;\n  }\n}\n\n// ------", "  PROBE_END\n"),
    ],
}
PHASES = {
    "old": ("stage_and_gather", "chain", "commit"),
    "new": ("chain", "wait_for_next_stage", "commit_and_table", "patch"),
}

# One-warp dependent-latency loops, in cycles an iteration (`x` carries
# the dependence; each body is one link of the per-edge chain).
LATENCY_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#define N 4096
__device__ __forceinline__ uint32_t score_key(float s) {
  const uint32_t b = __float_as_uint(__fadd_rn(s, 0.0f));
  return b ^ ((uint32_t)((int)b >> 31) | 0x80000000u);
}
template <int K>
__global__ void lat(float* fo, unsigned* uo, long long* cyc, float a, float c) {
  const int lane = threadIdx.x;
  const unsigned lt = (1u << lane) - 1u;
  float f = a + lane;
  unsigned x = lane * 2654435761u;
  long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < N; ++i) {
    if (K == 0) f = __fmaf_rn(f, a, c);                       // FFMA
    if (K == 1) x = __reduce_min_sync(0xffffffffu, x ^ lane); // REDUX (+ LOP3)
    if (K == 2) x = __ballot_sync(0xffffffffu, (x >> lane) & 1u) + lane;  // VOTE (+ SHF, IADD)
    if (K == 3) x = __ffs(x | 1u) + lane;                     // FFS (+ IADD)
    if (K == 4) x = score_key(__uint_as_float(x & 0x7f7fffffu)); // +0, order key
    if (K == 5) {  // a link of the p <= 32 kernel's chain, static mode (see chain())
      const float f_won = __fadd_rn(f, 1.0f);
      const uint32_t key_stay = score_key(__fmaf_rn(__fmul_rn(c, f), a, 1.0f));
      const uint32_t key_won = score_key(__fmaf_rn(__fmul_rn(c, f_won), a, 1.0f));
      const uint32_t kmin = __reduce_min_sync(0xffffffffu, x);
      const uint32_t at_min = __ballot_sync(0xffffffffu, x == kmin);
      const bool won = x == kmin && !(at_min & lt);
      if (won) f = f_won;
      x = won ? key_won : key_stay;
    }
  }
  long long t1 = clock64();
  fo[lane] = f;
  uo[lane] = x;
  if (lane == 0) cyc[0] = t1 - t0;
}
extern "C" int latency(int k, float* fo, unsigned* uo, long long* cyc, float a, float c) {
  switch (k) {
    case 0: lat<0><<<1, 32>>>(fo, uo, cyc, a, c); break;
    case 1: lat<1><<<1, 32>>>(fo, uo, cyc, a, c); break;
    case 2: lat<2><<<1, 32>>>(fo, uo, cyc, a, c); break;
    case 3: lat<3><<<1, 32>>>(fo, uo, cyc, a, c); break;
    case 4: lat<4><<<1, 32>>>(fo, uo, cyc, a, c); break;
    case 5: lat<5><<<1, 32>>>(fo, uo, cyc, a, c); break;
  }
  return (int)cudaDeviceSynchronize();
}
extern "C" int iterations() { return N; }
"""
LATENCY_NAMES = ("ffma", "redux_min", "ballot", "ffs", "plus0_and_key", "chain_link")


def prepare_builds(srcs: dict) -> dict:
    """{version: csrc dir} -> {(version, variant): built library path}; the
    builds run as parallel nvcc processes."""
    from repro_torch.kernels import dispatch

    procs, libs = [], {}
    for version, csrc in srcs.items():
        text = (csrc / "ebg_commit.cu").read_text()
        layout = "new" if "ebg_memb_transpose" in text else "old"
        for variant in ("as_is", "stamped"):
            d = PROBE_DIR / f"{version}_{variant}"
            shutil.rmtree(d, ignore_errors=True)
            shutil.copytree(csrc, d)
            body = text
            if variant == "stamped":
                for anchor, before in STAMPS[layout]:
                    assert body.count(anchor) == 1, f"{version}: stamp anchor not unique: {anchor!r}"
                    body = body.replace(anchor, before + anchor)
                body = body.replace("namespace {", STAMP_HEADER + "\nnamespace {", 1) + STAMP_READ
            (d / "ebg_commit.cu").write_text(body)
            out = d / "libebg_commit.so"
            cmd = [dispatch._nvcc(), *dispatch.NVCC_FLAGS, "-o", str(out), str(d / "ebg_commit.cu")]
            procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True), version, variant, layout, out))
    lat_dir = PROBE_DIR / "latency"
    lat_dir.mkdir(parents=True, exist_ok=True)
    (lat_dir / "latency.cu").write_text(LATENCY_SRC)
    lat_out = lat_dir / "liblatency.so"
    procs.append((subprocess.Popen([dispatch._nvcc(), *dispatch.NVCC_FLAGS, "-o", str(lat_out),
                                    str(lat_dir / "latency.cu")], stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True),
                  "latency", "", "", lat_out))
    for proc, version, variant, layout, out in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {version} {variant}:\n{log}")
        libs[(version, variant)] = (layout, out)
    return libs


def run_build(layout, lib, state, edges, coef, p, vw, nblocks):
    """One launch over `nblocks` blocks from `state`; returns (ms, parts,
    phase cycles or None)."""
    from repro_torch.kernels.dispatch import cuda_stream_handle

    keep, e, v = (t.clone() for t in state)
    u, w, valid = edges
    parts = torch.empty_like(u)
    stream = cuda_stream_handle()
    vp = ctypes.c_void_p
    main = lib.ebg_commit_launch
    if layout == "new":
        memb = torch.empty((32 * vw, (p + 31) // 32), dtype=torch.int32, device=keep.device)
        lib.ebg_memb_transpose.argtypes = [vp, vp] + [ctypes.c_int] * 3 + [vp]
        assert lib.ebg_memb_transpose(keep.data_ptr(), memb.data_ptr(), p, vw, 1, stream) == 0
        main.argtypes = [vp] * 10 + [ctypes.c_int] * 6 + [vp]
        args = [memb.data_ptr(), e.data_ptr(), v.data_ptr(), u.data_ptr(), w.data_ptr(),
                valid.data_ptr(), None, None, coef.data_ptr(), parts.data_ptr(),
                p, BLOCK, nblocks, 0, 0, 0, stream]
    else:
        main.argtypes = [vp] * 10 + [ctypes.c_int] * 7 + [vp]
        args = [keep.data_ptr(), e.data_ptr(), v.data_ptr(), u.data_ptr(), w.data_ptr(),
                valid.data_ptr(), None, None, coef.data_ptr(), parts.data_ptr(),
                p, vw, BLOCK, nblocks, 0, 0, 0, stream]
    main.restype = ctypes.c_int
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    assert main(*args) == 0
    b.record()
    b.synchronize()
    cycles = None
    if hasattr(lib, "probe_read"):
        buf = (ctypes.c_ulonglong * 8)()
        assert lib.probe_read(buf) == 0
        cycles = list(buf)
    return a.elapsed_time(b), parts, cycles


def latencies() -> dict:
    lib = ctypes.CDLL(str(PROBE_DIR / "latency" / "liblatency.so"))
    lib.latency.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_float, ctypes.c_float]
    n = lib.iterations()
    fo = torch.empty(32, device="cuda")
    uo = torch.empty(32, dtype=torch.int32, device="cuda")
    cyc = torch.empty(1, dtype=torch.int64, device="cuda")
    out = {}
    for k, name in enumerate(LATENCY_NAMES):
        best = None
        for _ in range(3):
            assert lib.latency(k, fo.data_ptr(), uo.data_ptr(), cyc.data_ptr(), 1.0001, 0.5) == 0
            c = int(cyc.item()) / n
            best = c if best is None else min(best, c)
        out[name] = best
    return out


def sass(lib_path: Path) -> str:
    from repro_torch.kernels import dispatch

    tool = Path(dispatch._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return "cuobjdump not found"
    r = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True)
    return r.stdout if r.returncode == 0 else r.stderr


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-src", type=Path, default=None,
                    help="another tree's src directory, whose kernel is probed beside this one")
    ap.add_argument("--blocks", type=int, default=512, help="blocks timed from the middle")
    ap.add_argument("--log2-edges", type=int, default=26)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_ebg_commit: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import FULL, PARTS
    from repro_torch.core import streaming
    from repro_torch.graph.generate import rmat
    from repro_torch.kernels import dispatch, ebg_commit as ebg

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    srcs = {"this": dispatch.CSRC}
    if args.old_src is not None:
        srcs["old"] = args.old_src.resolve() / "repro_torch" / "kernels" / "csrc"
    t = time.perf_counter()
    libs = prepare_builds(srcs)
    build_s = time.perf_counter() - t

    t = time.perf_counter()
    g = rmat(num_edges=1 << args.log2_edges, **FULL)
    st = streaming.prepare_stream(g, PARTS, "ebv", block=BLOCK, device=dev)
    state = st.new_state(PARTS, g.num_vertices)
    nblocks = st.u.shape[0] // BLOCK
    mid = nblocks // 2
    head = slice(0, mid * BLOCK)
    ebg.ebg_commit_stream(*state, st.u[head], st.v[head], st.valid[head], st.coef, block=BLOCK)
    window = slice(mid * BLOCK, (mid + args.blocks) * BLOCK)
    edges = (st.u[window], st.v[window], st.valid[window])
    want = ebg.ebg_commit_stream(*(x.clone() for x in state), *edges, st.coef, block=BLOCK)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t

    p, vw = state[0].shape
    result = dict(card=card, blocks=args.blocks, first_block=mid, build_s=build_s,
                  setup_s=setup_s, us_per_block={}, phase_share={}, phase_us_per_block={})
    for (version, variant), (layout, path) in libs.items():
        if version == "latency":
            continue
        lib = ctypes.CDLL(str(path))
        times = []
        for _ in range(3):
            ms, parts, cycles = run_build(layout, lib, state, edges, st.coef, p, vw, args.blocks)
            assert torch.equal(parts, want), f"{version} {variant}: parts differ from the wrapper's"
            times.append(ms)
        key = f"{version}_{variant}"
        result["us_per_block"][key] = 1e3 * min(times) / args.blocks
        if cycles is not None:
            names = PHASES[layout]
            total = sum(cycles[:len(names)])
            result["phase_share"][version] = {n: c / total for n, c in zip(names, cycles)}
            # The SM clock of the run: thread 0's stamped cycles over the launch's time.
            result.setdefault("sm_mhz_measured", {})[version] = total / (1e3 * times[-1])
    for version in srcs:
        share = result["phase_share"].get(version)
        if share:
            us = result["us_per_block"][f"{version}_as_is"]
            result["phase_us_per_block"][version] = {n: f * us for n, f in share.items()}

    lat = latencies()
    result["latency_cycles"] = lat
    result["clocks_max_sm_mhz"] = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True).stdout.strip()
    mhz = result["sm_mhz_measured"]["this"]
    result["chain_floor_us_per_block"] = BLOCK * lat["chain_link"] / mhz
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "probe_ebg_commit_sass.txt").write_text(sass(libs[("this", "as_is")][1]))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
