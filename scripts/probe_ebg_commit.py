#!/usr/bin/env python3
"""Where the time of the `ebg_commit` stream goes on one NVIDIA card.

    python3 scripts/probe_ebg_commit.py [--old-src DIR] [--log2-edges 22]
                                        [--edges-timed 65536] [--parts 32,64,256]
                                        [--blocks 256,2048,4096]

Generates an R-MAT stream with chip_smoke.py's full-width skew (2^22
vertices, 2^log2-edges edges, degree-sum order: ebv's, and hdrf's degree
weights) and times the commit kernel over every cell of a grid: p parts ×
block B × frozen/window × static/range × unweighted/weighted. Each cell
runs the stream through the kernel's wrapper up to its middle, then, from
that state, times `--edges-timed` edges (whole blocks) in one launch of
each kernel build. A build is compiled from a copy of a `csrc` directory
into build/probe/: `src/repro_torch/kernels/csrc` (the kernel as it is)
and, with `--old-src`, another tree's `src` directory (for example the
parent commit's, unpacked with `git archive`). Each is built twice: as it
is (its time a block, CUDA events, best of 3) and with clock64() stamps
taken by thread 0 at the kernel's phase boundaries (the split of the
launch's cycles between the phases). Every build's parts, bitset and
counters are checked against the wrapper's.

Stamped kernels and their phases: the p <= 32 pipelined kernel of a
frozen block a tile (chain, wait for the next block's staging, commit and
table, patch); this tree's tiled kernel (chain; wait for the next tile's
staging; commit — the tile's parts and table, or a deferred block's
bubble commit; patch — the next tile's masks from the table, or the
bubble's gather); and, in a tree from before the tiled kernel, its
block-wide kernel (stage and gather, chain, commit).

It also measures, in cycles, the dependent latency of the instructions
of the per-edge chain (a one-warp loop of each: FFMA, `redux`, `ballot`,
`ffs`, the +0 and order key), one link of the one-warp chain in static
mode as `chain()` runs it (the two speculative keys off the chain; `redux`
-> `ballot` -> the lowest lane at the min -> select), and one link of the
chain over Wc warps as `chain_multi()` runs it (`redux`, the warp's min
stored, `bar.sync` of the Wc warps, `redux` and `ballot` over the minima),
for the Wc of each p. A cell's chain floor is B × its link's cycles over
the SM clock of the run (thread 0's stamped cycles over the stamped
launch's time). The bytes bound of a block: its edges' inputs and parts
(each read or written once) over 3.35 TB/s. The SASS of this tree's build
goes to probe_ebg_commit_sass.txt and one JSON object a cell to
probe_ebg_commit.jsonl, both in OUT_DIR; the summary is one JSON line on
stdout. Needs a CUDA card.
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)

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
# (anchor, text put before it) for each kernel; the phases each PROBE(k)
# closes are named in PHASES (slot k). A source holds "pipe" (the p <= 32
# kernel of a block a tile) and "tiled" (this tree), or "pipe" and "block"
# (trees before the tiled kernel).
STAMPS = {
    "tiled": [
        ("  for (long long i = 0; i < ntiles; ++i) {", "  PROBE_T0\n"),
        ("    } else {\n      if (block_end) {", "      PROBE(4)\n"),
        ("    if (!DEFERRED) {\n      // ---- commit tile i", "    PROBE(5)\n"),
        ("      // ---- patch tile i+1's masks", "      PROBE(6)\n"),
        ("      if (has_next) {\n        gather_masks(nxt", "      PROBE(6)\n"),
        ("  }\n  if (chain_warp) {\n#pragma unroll", "    PROBE(7)\n"),
        ("  if (chain_warp) {\n#pragma unroll", "  PROBE_END\n"),
    ],
    "pipe": [
        ("  for (int blk = 0; blk < nblocks; ++blk) {\n    const Buf cur", "  PROBE_T0\n"),
        ("    } else if (has_next) {\n      stage<WEIGHTED>", "      PROBE(0)\n"),
        ("    // ---- commit block b: its parts", "    PROBE(1)\n"),
        ("    // ---- patch block b+1's masks", "    PROBE(2)\n"),
        ("    if (warp != 0)\n      for (int i = t - 32; i < H;", "    PROBE(3)\n"),
        ("  if (t < p) {\n    e_count[t] = e_c;\n    v_count[t] = v_c;\n  }\n}\n", "  PROBE_END\n"),
    ],
    "block": [
        ("  for (int blk = 0; blk < nblocks; ++blk) {\n    const size_t base", "  PROBE_T0\n"),
        ("    // ---- 2. the sequential per-edge argmin", "    PROBE(4)\n"),
        ("    // ---- 3. commit the winners' bits", "    PROBE(5)\n"),
        ("  }\n  if (!WIDE && part_lane) {\n    e_count[t] = e_c;",
         "    PROBE(6)\n  }\n  PROBE_END\n//"),
    ],
}
PHASES = {
    "tiled": {4: "chain", 5: "wait_for_next_stage", 6: "commit", 7: "patch_or_gather"},
    "pipe": {0: "chain", 1: "wait_for_next_stage", 2: "commit_and_table", 3: "patch"},
    "block": {4: "stage_and_gather", 5: "chain", 6: "commit"},
}

# One-warp dependent-latency loops, in cycles an iteration (`x` carries
# the dependence; each body is one link of the per-edge chain), and the
# chain over several warps (lat_multi, launched with 32·Wc threads).
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
    if (K == 5) {  // a link of the one-warp chain, static mode (see chain())
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
// A link of the chain over blockDim.x / 32 warps, static mode (see chain_multi()).
__global__ void lat_multi(float* fo, unsigned* uo, long long* cyc, float a, float c) {
  __shared__ unsigned cand[64];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  float f = a + threadIdx.x;
  unsigned x = threadIdx.x * 2654435761u;
  long long t0 = clock64();
  for (int i = 0; i < N; ++i) {
    const float f_won = __fadd_rn(f, 1.0f);
    const uint32_t key_stay = score_key(__fmaf_rn(__fmul_rn(c, f), a, 1.0f));
    const uint32_t key_won = score_key(__fmaf_rn(__fmul_rn(c, f_won), a, 1.0f));
    const uint32_t kw = __reduce_min_sync(0xffffffffu, x);
    if (lane == 0) cand[32 * (i & 1) + w] = kw;
    const unsigned at = __ballot_sync(0xffffffffu, x == kw);
    asm volatile("bar.sync 1, %0;" ::"r"((int)blockDim.x) : "memory");
    const uint32_t ck = lane < nw ? cand[32 * (i & 1) + lane] : 0xffffffffu;
    const uint32_t kmin = __reduce_min_sync(0xffffffffu, ck);
    const unsigned wm = __ballot_sync(0xffffffffu, ck == kmin);
    const bool won = (wm & (0u - wm)) == (1u << w) && x == kw && !(at & lt);
    if (won) f = f_won;
    x = won ? key_won : key_stay;
  }
  long long t1 = clock64();
  fo[threadIdx.x] = f;
  uo[threadIdx.x] = x;
  if (threadIdx.x == 0) cyc[0] = t1 - t0;
}
extern "C" int latency(int k, int warps, float* fo, unsigned* uo, long long* cyc, float a,
                       float c) {
  switch (k) {
    case 0: lat<0><<<1, 32>>>(fo, uo, cyc, a, c); break;
    case 1: lat<1><<<1, 32>>>(fo, uo, cyc, a, c); break;
    case 2: lat<2><<<1, 32>>>(fo, uo, cyc, a, c); break;
    case 3: lat<3><<<1, 32>>>(fo, uo, cyc, a, c); break;
    case 4: lat<4><<<1, 32>>>(fo, uo, cyc, a, c); break;
    case 5: lat<5><<<1, 32>>>(fo, uo, cyc, a, c); break;
    case 6: lat_multi<<<1, 32 * warps>>>(fo, uo, cyc, a, c); break;
  }
  return (int)cudaDeviceSynchronize();
}
extern "C" int iterations() { return N; }
"""
LATENCY_NAMES = ("ffma", "redux_min", "ballot", "ffs", "plus0_and_key", "chain_link")


def chain_warps(p: int) -> int:
    """The tiled kernel's chain warps at p parts (ebg_commit.cu's make_plan)."""
    W = -(-p // 32)
    return 1 if W == 1 else (W if W <= 16 else -(-W // 2))


def layouts_of(text: str) -> list:
    return ["pipe", "tiled" if "ebg_commit_tiled_kernel" in text else "block"]


def prepare_builds(srcs: dict) -> dict:
    """{version: csrc dir} -> {(version, variant): (layouts, built library
    path)}; the builds run as parallel nvcc processes."""
    from repro_torch.kernels import dispatch

    procs, libs = [], {}
    for version, csrc in srcs.items():
        text = (csrc / "ebg_commit.cu").read_text()
        layouts = layouts_of(text)
        for variant in ("as_is", "stamped"):
            d = PROBE_DIR / f"{version}_{variant}"
            shutil.rmtree(d, ignore_errors=True)
            shutil.copytree(csrc, d)
            body = text
            if variant == "stamped":
                for layout in layouts:
                    for anchor, before in STAMPS[layout]:
                        assert body.count(anchor) == 1, \
                            f"{version}: stamp anchor not unique: {anchor!r}"
                        body = body.replace(anchor, before + anchor)
                body = body.replace("namespace {", STAMP_HEADER + "\nnamespace {", 1) + STAMP_READ
            (d / "ebg_commit.cu").write_text(body)
            out = d / "libebg_commit.so"
            cmd = [dispatch._nvcc(), *dispatch.NVCC_FLAGS, "-o", str(out), str(d / "ebg_commit.cu")]
            procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True), version, variant, layouts, out))
    lat_dir = PROBE_DIR / "latency"
    lat_dir.mkdir(parents=True, exist_ok=True)
    (lat_dir / "latency.cu").write_text(LATENCY_SRC)
    lat_out = lat_dir / "liblatency.so"
    procs.append((subprocess.Popen([dispatch._nvcc(), *dispatch.NVCC_FLAGS, "-o", str(lat_out),
                                    str(lat_dir / "latency.cu")], stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True),
                  "latency", "", [], lat_out))
    for proc, version, variant, layouts, out in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {version} {variant}:\n{log}")
        libs[(version, variant)] = (layouts, out)
    return libs


def run_build(lib, state, edges, wts, coef, cell, nblocks):
    """One launch over `nblocks` blocks from `state`; returns (ms, [parts,
    keep, e, v], phase cycles or None)."""
    from repro_torch.kernels.dispatch import cuda_stream_handle

    keep, e, v = (t.clone() for t in state)
    u, w, valid = edges
    p, vw = keep.shape
    parts = torch.empty_like(u)
    stream = cuda_stream_handle()
    vp = ctypes.c_void_p
    memb = torch.empty((32 * vw, (p + 31) // 32), dtype=torch.int32, device=keep.device)
    lib.ebg_memb_transpose.argtypes = [vp, vp] + [ctypes.c_int] * 3 + [vp]
    assert lib.ebg_memb_transpose(keep.data_ptr(), memb.data_ptr(), p, vw, 1, stream) == 0
    lib.ebg_commit_workspace_bytes.argtypes = [ctypes.c_int] * 3
    lib.ebg_commit_workspace_bytes.restype = ctypes.c_longlong
    ws_bytes = lib.ebg_commit_workspace_bytes(p, cell["block"], int(wts is not None))
    ws = torch.empty((ws_bytes + 15) // 16 * 4 or 4, dtype=torch.int32, device=keep.device)
    main = lib.ebg_commit_launch
    main.argtypes = [vp] * 11 + [ctypes.c_int] * 6 + [vp]
    main.restype = ctypes.c_int
    args = [memb.data_ptr(), e.data_ptr(), v.data_ptr(), u.data_ptr(), w.data_ptr(),
            valid.data_ptr(), None if wts is None else wts[0].data_ptr(),
            None if wts is None else wts[1].data_ptr(), coef.data_ptr(), parts.data_ptr(),
            ws.data_ptr(), p, cell["block"], nblocks, int(cell["balance"] == "range"),
            int(wts is not None), int(cell["window"]), stream]
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
    keep_out = torch.empty_like(keep)
    assert lib.ebg_memb_transpose(memb.data_ptr(), keep_out.data_ptr(), p, vw, 0, stream) == 0
    return a.elapsed_time(b), [parts, keep_out, e, v], cycles


def latencies(warps=()) -> dict:
    lib = ctypes.CDLL(str(PROBE_DIR / "latency" / "liblatency.so"))
    lib.latency.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_void_p, ctypes.c_float, ctypes.c_float]
    n = lib.iterations()
    fo = torch.empty(1024, device="cuda")
    uo = torch.empty(1024, dtype=torch.int32, device="cuda")
    cyc = torch.empty(1, dtype=torch.int64, device="cuda")

    def best(k, nw=1):
        out = None
        for _ in range(3):
            assert lib.latency(k, nw, fo.data_ptr(), uo.data_ptr(), cyc.data_ptr(), 1.0001,
                               0.5) == 0
            c = int(cyc.item()) / n
            out = c if out is None else min(out, c)
        return out

    res = {name: best(k) for k, name in enumerate(LATENCY_NAMES)}
    res["chain_link_warps"] = {str(w): best(6, w) for w in warps}
    return res


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
    ap.add_argument("--log2-edges", type=int, default=22)
    ap.add_argument("--edges-timed", type=int, default=1 << 16,
                    help="edges timed in each cell (whole blocks, at least one)")
    ap.add_argument("--parts", default="32,64,256")
    ap.add_argument("--blocks", default="256,2048,4096")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_ebg_commit: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import FULL
    from repro_torch.core import streaming
    from repro_torch.graph.generate import rmat
    from repro_torch.kernels import dispatch, ebg_commit as ebg

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    parts_grid = [int(x) for x in args.parts.split(",")]
    blocks_grid = [int(x) for x in args.blocks.split(",")]
    srcs = {"this": dispatch.CSRC}
    if args.old_src is not None:
        srcs["old"] = args.old_src.resolve() / "repro_torch" / "kernels" / "csrc"
    t = time.perf_counter()
    libs = prepare_builds(srcs)
    loaded = {key: (layouts, ctypes.CDLL(str(path))) for key, (layouts, path) in libs.items()
              if key[0] != "latency"}
    build_s = time.perf_counter() - t

    t = time.perf_counter()
    g = rmat(num_edges=1 << args.log2_edges, **FULL)
    gen_s = time.perf_counter() - t
    lat = latencies(sorted({chain_warps(p) for p in parts_grid if p > 32}))
    OUT_DIR.mkdir(exist_ok=True)
    cells_path = OUT_DIR / "probe_ebg_commit.jsonl"
    cells_path.unlink(missing_ok=True)
    summary = dict(card=card, log2_edges=args.log2_edges, build_s=build_s, generate_s=gen_s,
                   latency_cycles=lat, cells=0, us_per_block={})
    mhz = None
    for p in parts_grid:
        streams = {}
        for B in blocks_grid:
            # ebv's order and coefficients; hdrf's weights for the weighted cells.
            ebv = streaming.prepare_stream(g, p, "ebv", block=B, device=dev)
            hdrf = streaming.prepare_stream(g, p, "hdrf", block=B, order=ebv.order, device=dev)
            streams[B] = (ebv, hdrf)
        for B in blocks_grid:
            ebv, hdrf = streams[B]
            nblocks = ebv.u.shape[0] // B
            count = max(1, args.edges_timed // B)
            mid = nblocks // 2
            for window in (False, True):
                for balance in ("static", "range"):
                    for weighted in (False, True):
                        cell = dict(p=p, block=B, window=window, balance=balance,
                                    weighted=weighted, blocks=count)
                        wts_all = (hdrf.wu, hdrf.wv) if weighted else None
                        kw = dict(balance=balance, window=window)
                        state = ebv.new_state(p, g.num_vertices)
                        head = slice(0, mid * B)
                        ebg.ebg_commit_stream(*state, ebv.u[head], ebv.v[head], ebv.valid[head],
                                              ebv.coef, block=B,
                                              wu=None if wts_all is None else wts_all[0][head],
                                              wv=None if wts_all is None else wts_all[1][head],
                                              **kw)
                        sl = slice(mid * B, (mid + count) * B)
                        edges = (ebv.u[sl], ebv.v[sl], ebv.valid[sl])
                        wts = None if wts_all is None else (wts_all[0][sl], wts_all[1][sl])
                        want_state = [x.clone() for x in state]
                        want = ebg.ebg_commit_stream(
                            *want_state, *edges, ebv.coef, block=B,
                            wu=None if wts is None else wts[0],
                            wv=None if wts is None else wts[1], **kw)
                        want_all = [want, *want_state]
                        for (version, variant), (layouts, lib) in loaded.items():
                            times = []
                            for _ in range(3 if variant == "as_is" else 1):
                                ms, got, cycles = run_build(lib, state, edges, wts, ebv.coef, cell,
                                                            count)
                                for name, x, y in zip(("parts", "keep", "e", "v"), got, want_all):
                                    assert torch.equal(x, y), \
                                        f"{version} {variant} {cell}: {name} differs"
                                times.append(ms)
                            if variant == "as_is":
                                cell[f"{version}_us_per_block"] = 1e3 * min(times) / count
                            elif cycles is not None:
                                total = sum(cycles)
                                names = {}
                                for layout in layouts:
                                    names.update(PHASES[layout])
                                split = {names[k]: c / count for k, c in enumerate(cycles)
                                         if c and k in names}
                                cell[f"{version}_cycles_per_block"] = split
                                if version == "this" and mhz is None and total:
                                    mhz = total / (1e3 * times[-1])
                        cell["sm_mhz"] = mhz
                        wc = chain_warps(p)
                        link = lat["chain_link"] if wc == 1 else lat["chain_link_warps"][str(wc)]
                        cell["chain_link_cycles"] = link
                        cell["chain_floor_us_per_block"] = B * link / mhz if mhz else None
                        io = B * (4 + 4 + 1 + 4 + (8 if weighted else 0))
                        cell["bytes_bound_us_per_block"] = 1e6 * io / HBM_BYTES_PER_S
                        with cells_path.open("a") as f:
                            f.write(json.dumps(cell) + "\n")
                        key = (f"p{p}_B{B}_{'window' if window else 'frozen'}_{balance}"
                               f"{'_weighted' if weighted else ''}")
                        summary["us_per_block"][key] = {
                            k: cell[k] for k in cell if k.endswith("_us_per_block")}
                        summary["cells"] += 1
                        print(f"{key}: " + ", ".join(
                            f"{k} {cell[k]:.2f}" for k in cell
                            if k.endswith("_us_per_block") and cell[k] is not None),
                            file=sys.stderr, flush=True)
        del streams
    summary["sm_mhz"] = mhz
    summary["clocks_max_sm_mhz"] = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True).stdout.strip()
    (OUT_DIR / "probe_ebg_commit_sass.txt").write_text(sass(libs[("this", "as_is")][1]))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
