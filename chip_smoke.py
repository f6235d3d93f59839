#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--full-log2-edges 26]

Phases; a failed check raises and the script exits non-zero:

  1. build    compile the CUDA kernels of src/repro_torch/kernels/csrc with
              nvcc (one process per source, all at once) into build/kernels/.
  2. kernels  hold each kernel against its plain PyTorch version on the card,
              on the smoke graph's real state: ebg_commit over a range of
              blocks for ebv (frozen and window), hdrf and greedy, block by
              block and as one stream launch, and at p=64 (the block-wide
              kernel) — bitwise; its two bitset transposes (bitwise);
              bsp_superstep on the CC, REACH (two-level and flat addressing,
              the latter with negative values), SSSP and BFS streams (min,
              bitwise), the PageRank stream and a hub-heavy [p, E] stream
              (sum, to rtol 1e-5); and in one launch over a batch's B·p value
              rows on the shared streams (BFS, SSSP, PR), against the plain
              version and against each query's rows launched alone;
              segment_reduce min and max (bitwise) and sum (rtol 1e-5) on
              two workers' CC and PageRank streams and on a hub-heavy
              stream, and the id guards of segment_reduce, of
              bsp_superstep's min, max and sum and of ebg_membership (an
              out-of-range id must raise ValueError, and the next good call
              succeed);
              ebg_membership on the smoke partition's bitset (bitwise);
              decode_attention at the parity tests' shapes and at the
              head_dims the kernel runs zero-padded (kimi_k2's 112, the
              reduced configs' 16), f32 and bf16, with and without softcap
              (f32: 2e-5; bf16: one bf16 rounding, rtol 2^-7 and atol
              1e-5, which the kernel's output scaled by 1.01 must fail).
              The segment reductions, membership and attention run
              through `kernels.ops`.
  3. pinned   the smoke graph and twitter_like through GraphPipeline on the
              card (p=32, ebg_chunked): every number the JAX reference gives
              on the CPU, exactly (RF and imbalances to 6 decimals). On
              twitter_like each program runs by the fused driver (cold: it
              captures its CUDA graph; then warm: it captures nothing) and
              by the host driver: equal values and stats, the host syncs
              and walls of each logged.
  4. baselines
              the paper's baselines beside ebg_chunked on twitter_like
              (p=32) through GraphPipeline: hash, DBH and CVC partition on
              the card, NE and METIS-like on the host; each then a
              symmetric build and CC on the card, with the launch counts
              zeroed just before and read just after. RF and imbalances
              (6 decimals), CC's supersteps and messages equal the JAX
              reference's; the labels equal label propagation. One line a
              partitioner on stdout: the port's Table III/IV row.
  5. full     the full-width path: R-MAT with LiveJournal's scale and skew
              (2^22 vertices, 2^26 edges), p=32, ebg_chunked, then CC, REACH,
              SSSP, BFS and PR through GraphPipeline. Kernel launch counts
              are zeroed just before and read just after; the results are
              checked against plain label-propagation / BFS / power-iteration
              oracles on the card. Each program runs again by the fused
              driver (warm) and by the host driver: equal values and stats,
              walls and host syncs kept. Then the serving tier on the
              directed build: a synthetic trace of 64 BFS/SSSP point
              queries (degree-proportional sources, 2,000 queries/s)
              through GraphPipeline.serve (max_batch 8, buckets 1/2/4/8,
              every graph captured first), launch counts zeroed just
              before; every answer against the BFS oracle from its
              source, the first batch of each program against single
              host-driver runs, bitwise; one {"serve": ...} stdout line.
              Then crash and resume (launch counts zeroed just before and
              read just after): CC on the symmetric build, SSSP and PR
              (20 steps) on the directed one, each through
              GraphPipeline.run checkpointed every k supersteps with a
              crash planned at superstep s (RESILIENCE), resumed by
              resume_bsp once by the fused and once by the host driver:
              values and every BSPStats field equal to the uninterrupted
              fused run, bitwise; snapshot bytes, save and resume walls,
              new captures. Then the out-of-core pipeline (launch counts
              zeroed just before and read just after): the graph written
              to a shard store on local disk (shards of 2^20 edges), its
              degrees (equal to the graph's) and the external degree-sum
              order, partition_store (ebv, block 4,096) with its state on
              the card, against the in-memory driver's stream on the card:
              the order, the assignments in stream and input order and the
              counters, bitwise; edges/s and the counters' RF beside
              partition_metrics'. On twitter_like the same partition, then
              the streamed build of edge_part_stream against build_subgraphs
              on the same partition (every field) and CC on both (labels,
              every stat; the labels against label propagation).
              Then the distributed path on a NCCL world of this process
              alone (launch counts zeroed just before each run and read
              just after): the stepper with all 32 subgraphs on rank 0,
              CC and REACH on the symmetric build, SSSP, BFS and PR on the
              directed one, cold and warm, each equal to the main path's
              fused run (values and every stat, bitwise), its walls and
              host syncs beside the fused and host drivers';
              GraphPipeline.run("cc", mode="dist") at p = 1 on
              twitter_like against mode="sim"; and partition_store's
              sharded layout on twitter_like (ebv, frozen, block 256, one
              commit launch and one all_gather a block) against the
              replicated one: the order, the parts and the counters,
              bitwise, with edges/s of each. With two cards or more, a
              NCCL world of 2 (one rank a card) also runs CC's full-width
              stepper; with one card the log says it did not.
              Then each kernel is held against its plain
              version at these shapes and timed beside its bound, its plain
              version and the nearest single PyTorch call: segment_reduce
              on one worker's CC and PageRank streams, ebg_membership on
              the full partition's bitset over 2^22 stream edges, and
              decode_attention at gemma2_27b's attention widths (Hq 32,
              Hkv 16, head_dim 128; S=32768, bf16) at B=8 and B=1, with
              softcap 50 and with softcap 0, where SDPA computes the same
              function. These three are off the main path (the JAX
              package's too): their launch counts there are 0.
              segment_reduce and bsp_superstep are timed with their
              wrappers' host read of the id flag (ms) and without it
              (kernel_ms). ebg_commit's entry carries the full stream's
              time a block, and a block of p=2048 parts and 8192 edges
              (the workspace path: frozen and window, bitwise against the
              plain version, on the smoke graph). bsp_superstep.min's
              entry carries the share of the stream's edges that took part
              in each pass (the frontier), and the serving path's batched
              launch (8 BFS queries' first superstep, B·p value rows)
              against its rows launched alone, bitwise, timed beside the 8
              single launches. decode_attention is also timed
              at kimi_k2's attention widths (head_dim 112). ebg_membership's
              entry carries its main kernel's time (kernel_ms) and its
              transpose's (transpose_ms) beside the whole call. Last, hash,
              DBH and CVC partition the full-width graph on the card,
              bitwise against a numpy splitmix64 written here, with their
              edges per second and metrics.

Prints the card's name and power limit, the {"serve": ...} and {"kernels": [...]} lines, and last
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
It needs the repository around it and a CUDA card; without either it fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores (NVIDIA data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 in the tensor cores (NVIDIA data sheet)
PARTS = 32
SMOKE = dict(num_vertices=1 << 14, num_edges=200_000, a=0.65, b=0.15, c=0.15, seed=7)
FULL = dict(num_vertices=1 << 22, a=0.57, b=0.19, c=0.19, seed=0)
SUM_RTOL, SUM_ATOL = 1e-5, 1e-8  # f32 sums in another order (atomics in the plain version)
PR_ORACLE_RTOL = 1e-3  # f32 engine against a float64 power iteration
# Attention limits (rtol, atol). bf16: one bf16 rounding of the output (a
# one-ulp disagreement is at most 2^-7 of the value) plus an f32-level atol
# for values near zero. Every comparison also holds a control, the kernel's
# output off by ATTN_CONTROL, which must fail the limit.
ATTN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2**-7, 1e-5)}
ATTN_CONTROL = 1.01
SEGMENT_ENTRIES = {"min": "segment_min_plus", "max": "segment_max", "sum": "segment_sum_scaled"}
# The parity tests' decode shapes (B, Hq, Hkv, D, S), and gemma2_27b's
# attention widths (src/repro/configs/gemma2_27b.py) at B=8, S=32768.
ATTN_SHAPES = ((2, 8, 4, 64, 512), (1, 4, 4, 32, 1024), (3, 12, 2, 64, 512))
GEMMA2_27B = dict(Hq=32, Hkv=16, D=128, S=32_768)
# Head dims outside the kernel's built widths, which it runs zero-padded:
# kimi_k2's attention (src/repro/configs/kimi_k2.py: Hq 64, Hkv 8, head_dim
# 112) and the reduced model configs' (src/repro/configs/__init__.py:
# reduced_config: Hq 4, Hkv 2, head_dim 16), as (B, Hq, Hkv, D, S).
PADDED_ATTN_SHAPES = ((2, 64, 8, 112, 4096), (2, 4, 2, 16, 1024), (3, 4, 2, 17, 777))
KIMI_K2 = dict(Hq=64, Hkv=8, D=112, S=32_768)
ATTN_CASES = (  # (entry name, batch, softcap)
    ("decode_attention", 8, 50.0), ("decode_attention.softcap0", 8, 0.0),
    ("decode_attention.B1", 1, 50.0), ("decode_attention.B1.softcap0", 1, 0.0),
)
MEMB_EDGES = 1 << 22  # the membership slice of the full-width stream
WIDE_COMMIT = dict(parts=2048, block=8192)  # past the block-wide kernel's shared memory

# The JAX reference on the CPU (compute_backend="xla", all defaults,
# p=32, ebg_chunked): (steps, messages) per program, CC with components.
PINNED = {
    "smoke": dict(
        V=16_384, E=165_674, metrics=("3.426599", "1.030651", "1.018251"),
        runs=dict(cc=(3, 47_726), sssp=(4, 52_741), bfs=(4, 52_741), reach=(4, 84_812),
                  pr=(20, 956_080)),
        components=11,
    ),
    "twitter_like": dict(
        V=131_072, E=1_842_450, metrics=("3.400300", "1.013207", "1.010039"),
        runs=dict(cc=(3, 342_275), sssp=(4, 397_727), bfs=(4, 397_727), reach=(4, 608_567),
                  pr=(20, 6_848_920)),
        components=46,
    ),
}
PROGRAMS = ("cc", "sssp", "bfs", "reach", "pr")
INF_I32 = 2**31 - 1
# The paper's baselines on twitter_like: the JAX reference on the CPU
# (p=32, each baseline's defaults, then a symmetric build and CC with
# compute_backend="xla"): RF, edge and vertex imbalance to 6 decimals, CC
# (supersteps, total messages). tests/test_torch_partitioners.py holds the
# same table and checks the port against it on the CPU.
PINNED_BASELINES = {
    "hash": (("9.568018", "1.010620", "1.008537"), (4, 1_209_490)),
    "dbh": (("4.039308", "1.201895", "1.030388"), (4, 430_814)),
    "cvc": (("5.081672", "1.120543", "1.055968"), (4, 612_352)),
    "ne": (("2.847871", "1.000008", "2.273158"), (2, 263_570)),
    "metis": (("3.354389", "20.466453", "7.109937"), (3, 328_897)),
}
HASH_FAMILY = ("hash", "dbh", "cvc")  # the baselines that run on the card
# The serving replay at full width: graph_serve's defaults (rate, mix,
# max_batch 8, buckets 1/2/4/8) on 64 degree-proportional point queries.
SERVE = dict(queries=64, rate_qps=2000.0, mix=(("bfs", 0.5), ("sssp", 0.5)), seed=0,
             max_batch=8)
BATCH_B = 8  # the batched superstep launch timed at full width (BFS)
# Crash and resume at full width: (program, checkpoint_every, crash_at_superstep),
# each crash after at least one snapshot past superstep 0.
RESILIENCE = (("cc", 1, 2), ("sssp", 2, 2), ("pr", 5, 12))
# The out-of-core pipeline: shards of 2^20 edges, blocks of 4,096 (the
# default of partition_store).
OUT_OF_CORE = dict(shard_edges=1 << 20, block=4096)
# The sharded out-of-core layout's block on twitter_like (one launch and
# one all_gather a block).
DIST_SHARDED_BLOCK = 256


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def sync() -> None:
    torch.cuda.synchronize()


class Stages:
    """Wall times of named stages, each ended by a device synchronize."""

    def __init__(self):
        self.s = {}

    def __call__(self, name, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        sync()
        self.s[name] = time.perf_counter() - t
        log(f"  {name}: {self.s[name]:.2f} s")
        return out


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over `reps` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    sync()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ------------------------------------------------------------------ phases


def phase_build():
    from repro_torch.kernels import dispatch

    t = time.perf_counter()
    reports = dispatch.build_kernels()
    secs = time.perf_counter() - t
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "ptxas.txt").write_text("\n".join(f"== {k}\n{v}" for k, v in reports.items()))
    for name in dispatch.KERNEL_NAMES:
        dispatch.load_library(name)
    log(f"build: {sorted(reports)} in {secs:.1f} s")
    return secs


def compare_commit(state, st, sl, window):
    """One block through the kernel and the plain version; bitwise."""
    from repro_torch.kernels import ebg_commit as ebg

    args = (*state, st.u[sl], st.v[sl], st.valid[sl], st.coef)
    kw = dict(balance=st.balance, window=window,
              wu=None if st.wu is None else st.wu[sl], wv=None if st.wv is None else st.wv[sl])
    got = ebg.ebg_commit_block(*args, **kw)
    want = ebg.ebg_commit_block_plain(*args, **kw)
    for name, g, w in zip(("keep_bits", "e_count", "v_count", "parts"), got, want):
        check(torch.equal(g, w), f"ebg_commit {name} differs from the plain version")
    return got[:3]


def commit_blocks(graph, scorer, window, dev, first, count, block=256, order=None,
                  parts=PARTS):
    """Blocks [first, first+count) of `scorer`'s stream over `graph`, each held
    against the plain version, from the real state the kernel's stream entry
    reaches after `first` blocks. Returns (stream, state at `first`)."""
    from repro_torch.core import streaming
    from repro_torch.kernels import ebg_commit as ebg

    st = streaming.prepare_stream(graph, parts, scorer, block=block, order=order, device=dev)
    state = st.new_state(parts, graph.num_vertices)
    if first:
        sl = slice(0, first * block)
        ebg.ebg_commit_stream(*state, st.u[sl], st.v[sl], st.valid[sl], st.coef, block=block,
                              balance=st.balance, window=window,
                              wu=None if st.wu is None else st.wu[sl],
                              wv=None if st.wv is None else st.wv[sl])
    start = tuple(t.clone() for t in state)
    for b in range(first, first + count):
        state = compare_commit(state, st, slice(b * block, (b + 1) * block), window)
    return st, start


def compare_commit_stream(start, st, first, count, window):
    """Blocks [first, first+count) as one stream launch on the card (the
    pipelined kernel carries the state across block boundaries) and through
    the plain version on host copies; bitwise."""
    from repro_torch.kernels import ebg_commit as ebg

    sl = slice(first * st.block, (first + count) * st.block)
    edges = (st.u[sl], st.v[sl], st.valid[sl])
    kw = dict(block=st.block, balance=st.balance, window=window)
    wts = (None, None) if st.wu is None else (st.wu[sl], st.wv[sl])
    got_state = [t.clone() for t in start]
    got = ebg.ebg_commit_stream(*got_state, *edges, st.coef, wu=wts[0], wv=wts[1], **kw)
    want_state = [t.cpu() for t in start]
    want = ebg.ebg_commit_stream(*want_state, *(t.cpu() for t in edges), st.coef.cpu(),
                                 wu=None if wts[0] is None else wts[0].cpu(),
                                 wv=None if wts[1] is None else wts[1].cpu(), **kw)
    check(torch.equal(got.cpu(), want), "ebg_commit stream parts differ from the plain version")
    for name, g, w in zip(("keep_bits", "e_count", "v_count"), got_state, want_state):
        check(torch.equal(g.cpu(), w), f"ebg_commit stream {name} differs from the plain version")


def compare_transposes(dev, keep=None):
    """The commit's bitset transposes against their plain versions, and the
    round trip; bitwise. `keep` defaults to a random [33, 1000] bitset."""
    from repro_torch.kernels import ebg_commit as ebg

    if keep is None:
        gen = torch.Generator(device=dev).manual_seed(5)
        keep = torch.randint(-2**31, 2**31 - 1, (33, 1000), generator=gen, device=dev,
                             dtype=torch.int32)
    p = keep.shape[0]
    memb = ebg.keep_bits_to_memb(keep)
    check(torch.equal(memb, ebg.keep_bits_to_memb_plain(keep)),
          "keep_bits_to_memb differs from the plain version")
    back = ebg.memb_to_keep_bits(memb, p)
    check(torch.equal(back, ebg.memb_to_keep_bits_plain(memb, p)),
          "memb_to_keep_bits differs from the plain version")
    check(torch.equal(back, keep), "memb_to_keep_bits does not invert keep_bits_to_memb")
    return memb


def compare_superstep(sub, prog, num_vertices, source=0):
    """The first superstep's local stage of `prog` through the kernel and
    the plain version. Returns (inputs, values, num_out, kernel result, max abs err)."""
    from repro_torch.graph import engine
    from repro_torch.kernels import bsp_superstep as bsp

    (lsrc, ldst, w, deg), val, n = engine.kernel_inputs(sub, prog, num_vertices=num_vertices,
                                                        source=source)
    combine = "sum" if deg is not None else "min"
    kw = dict(num_out=n, combine=combine, inner_cap=10_000, out_degree=deg)
    got = bsp.bsp_superstep(lsrc, ldst, w, val, **kw)
    want = bsp.bsp_superstep_plain(lsrc, ldst, w, val, **kw)
    check(torch.equal(got[1], want[1]), f"bsp_superstep {prog}: iteration counts differ")
    err = float((got[0].double() - want[0].double()).abs().max())
    if combine == "min":
        check(torch.equal(got[0], want[0]), f"bsp_superstep {prog}: min values differ")
    else:
        check(torch.allclose(got[0], want[0], rtol=SUM_RTOL, atol=SUM_ATOL),
              f"bsp_superstep {prog}: sum values differ beyond rtol {SUM_RTOL}")
    return (lsrc, ldst, w, deg), val, n, got, err


def compare_superstep_batch(sub, prog, num_vertices, sources):
    """The first superstep's local stage of len(sources) queries of `prog`
    in one launch over B·p value rows on the shared streams: against the
    plain version on the same inputs (min bitwise, sum to rtol) and each
    query's rows against the same rows launched alone (bitwise). Returns
    (inputs, values, num_out, kernel result, each query's values)."""
    from repro_torch.graph import engine
    from repro_torch.kernels import bsp_superstep as bsp

    (lsrc, ldst, w, deg), val, n = engine.kernel_inputs(sub, prog, num_vertices=num_vertices,
                                                        source=list(sources))
    p = lsrc.shape[0]
    combine = "sum" if deg is not None else "min"
    kw = dict(num_out=n, combine=combine, inner_cap=10_000, out_degree=deg)
    got = bsp.bsp_superstep(lsrc, ldst, w, val, **kw)
    want = bsp.bsp_superstep_plain(lsrc, ldst, w, val, **kw)
    check(torch.equal(got[1], want[1]), f"bsp_superstep batch {prog}: iteration counts differ")
    check(torch.equal(got[0], want[0]) if combine == "min" else
          torch.allclose(got[0], want[0], rtol=SUM_RTOL, atol=SUM_ATOL),
          f"bsp_superstep batch {prog}: values differ from the plain version")
    rows = [val[b * p:(b + 1) * p].clone() for b in range(len(sources))]
    for b, v in enumerate(rows):
        alone = bsp.bsp_superstep(lsrc, ldst, w, v, **kw)
        check(torch.equal(alone[0], got[0][b * p:(b + 1) * p])
              and torch.equal(alone[1], got[1][b * p:(b + 1) * p]),
              f"bsp_superstep batch {prog}: query {b} differs from its rows launched alone")
    return (lsrc, ldst, w, deg), val, n, got, rows


def compare_segment(op, lsrc, ldst, w, val, n):
    """One `ops` segment entry on the card (the kernel) and on host copies
    of the same inputs (the plain version); min and max bitwise, sum to
    rtol. Returns (kernel result, max abs err)."""
    from repro_torch.kernels import ops

    entry = getattr(ops, SEGMENT_ENTRIES[op])
    got = entry(lsrc, ldst, w, val, num_out=n)
    want = entry(lsrc.cpu(), ldst.cpu(), w.cpu(), val.cpu(), num_out=n).to(got.device)
    err = float((got.double() - want.double()).abs().max())
    if op == "sum":
        check(torch.allclose(got, want, rtol=SUM_RTOL, atol=SUM_ATOL),
              f"segment_reduce sum differs beyond rtol {SUM_RTOL}")
    else:
        check(torch.equal(got, want), f"segment_reduce {op} differs from the plain version")
    return got, err


def compare_bsp_sum_hub(dev):
    """The superstep's sum on a hub-heavy [p, E] stream: one destination
    owns 90 % of every worker's edges, values of both signs. Returns the
    max abs err against the plain version."""
    from repro_torch.kernels import bsp_superstep as bsp

    gen = torch.Generator(device=dev).manual_seed(11)
    p, n, E = PARTS, 1 << 14, 1 << 18
    other = torch.randint(0, n - 1, (p, E), generator=gen, device=dev)
    hub = torch.rand((p, E), generator=gen, device=dev) < 0.9
    ldst = torch.where(hub, 7, other).sort(dim=1).values.to(torch.int32)
    lsrc = torch.randint(0, n, (p, E), generator=gen, device=dev, dtype=torch.int32)
    w = torch.rand((p, E), generator=gen, device=dev)
    val = torch.rand((p, n), generator=gen, device=dev) * 10 - 5
    deg = torch.randint(0, 4, (p, n), generator=gen, device=dev).float()
    kw = dict(num_out=n, combine="sum", out_degree=deg)
    got, it = bsp.bsp_superstep(lsrc, ldst, w, val, **kw)
    want, want_it = bsp.bsp_superstep_plain(lsrc, ldst, w, val, **kw)
    check(torch.equal(it, want_it), "bsp_superstep sum on the hub stream: iteration counts")
    check(torch.allclose(got, want, rtol=SUM_RTOL, atol=SUM_ATOL),
          f"bsp_superstep sum on the hub stream differs beyond rtol {SUM_RTOL}")
    return float((got.double() - want.double()).abs().max())


def check_id_guard(dev):
    """segment_reduce and bsp_superstep (min, max, sum) on the card refuse
    out-of-range ids with ValueError (the kernels' guards and their flags),
    and a good call right after succeeds."""
    from repro_torch.kernels import ops

    E, n = 4096, 100
    lsrc = torch.arange(E, device=dev, dtype=torch.int32) % n
    ldst = torch.sort(lsrc).values
    w = torch.ones(E, device=dev)
    val = torch.ones(n, device=dev)
    for op in ("min", "sum"):
        entry = getattr(ops, SEGMENT_ENTRIES[op])
        for name, bad in (("lsrc", n), ("ldst", -1)):
            args = dict(lsrc=lsrc.clone(), ldst=ldst.clone())
            args[name][E // 3] = bad
            try:
                entry(args["lsrc"], args["ldst"], w, val, num_out=n)
            except ValueError as e:
                check(f"{name} has ids" in str(e), f"segment_reduce {op}: wrong refusal {e}")
            else:
                raise AssertionError(f"segment_reduce {op} took an out-of-range {name}")
        got = entry(lsrc, ldst, w, val, num_out=n)
        want = torch.full((n,), 1.0 if op == "min" else float(E // n), device=dev)
        want[: E % n] += 0.0 if op == "min" else 1.0
        check(torch.equal(got, want), f"segment_reduce {op}: a good call after a refused one")
    # The superstep: a [4, E] stream of the same edges a worker.
    p = 4
    ls, ld, wt = (x.repeat(p, 1).contiguous() for x in (lsrc, ldst, w))
    vals = torch.arange(p * n, device=dev, dtype=torch.float32).reshape(p, n) % 7
    deg = torch.ones((p, n), device=dev)
    for combine in ("min", "max", "sum"):
        kw = dict(num_out=n, combine=combine, inner_cap=10_000,
                  out_degree=deg if combine == "sum" else None)
        for name, bad in (("lsrc", n), ("ldst", -1)):
            args = dict(lsrc=ls.clone(), ldst=ld.clone())
            args[name][2, E // 3] = bad
            try:
                ops.bsp_superstep(args["lsrc"], args["ldst"], wt, vals, **kw)
            except ValueError as e:
                check(f"{name} has ids" in str(e), f"bsp_superstep {combine}: wrong refusal {e}")
            else:
                raise AssertionError(f"bsp_superstep {combine} took an out-of-range {name}")
        got, it = ops.bsp_superstep(ls, ld, wt, vals, **kw)
        want, want_it = ops.bsp_superstep(*(x.cpu() for x in (ls, ld, wt, vals)),
                                          **{k: (x.cpu() if torch.is_tensor(x) else x)
                                             for k, x in kw.items()})
        check(torch.equal(it.cpu(), want_it), f"bsp_superstep {combine}: a good call's iterations")
        check(torch.allclose(got.cpu(), want, rtol=SUM_RTOL, atol=SUM_ATOL)
              if combine == "sum" else torch.equal(got.cpu(), want),
              f"bsp_superstep {combine}: a good call after a refused one")


def check_membership_guard(dev):
    """ebg_membership on the card refuses ids -1 and 32·vw with ValueError
    (the kernel's guard and its flag), and a good call right after
    succeeds."""
    from repro_torch.kernels import ebg_score, ops

    gen = torch.Generator(device=dev).manual_seed(3)
    p, vw, E = 33, 40, 4096
    keep = torch.randint(-2**31, 2**31 - 1, (p, vw), generator=gen, device=dev,
                         dtype=torch.int32)
    ends = {n: torch.randint(0, 32 * vw, (E,), generator=gen, device=dev, dtype=torch.int32)
            for n in ("u", "v")}
    for name in ("u", "v"):
        for bad in (-1, 32 * vw):
            args = {n: t.clone() for n, t in ends.items()}
            args[name][E // 3] = bad
            try:
                ops.ebg_membership(keep, args["u"], args["v"])
            except ValueError as e:
                check(f"{name} has ids" in str(e), f"ebg_membership: wrong refusal {e}")
            else:
                raise AssertionError(f"ebg_membership took {name} id {bad}")
    got = ops.ebg_membership(keep, ends["u"], ends["v"])
    check(torch.equal(got, ebg_score.ebg_membership_plain(keep, ends["u"], ends["v"])),
          "ebg_membership: a good call after a refused one")


def pr_share(val, deg):
    """PageRank's per-edge source share, as the sum kernel's gather takes it."""
    return torch.where(deg > 0, val / deg, 0.0)


def keep_bits_of(u, v, part, num_parts, num_vertices):
    """The packed membership bitset a partition leaves: vertex x is in
    keep[i] when an edge of part i touches it."""
    from repro_torch.kernels import ops

    keep = torch.zeros((num_parts, num_vertices), dtype=torch.bool, device=u.device)
    keep[part.long(), u.long()] = True
    keep[part.long(), v.long()] = True
    return ops.pack_keep_bits(keep)


def compare_membership(keep, u, v):
    from repro_torch.kernels import ebg_score, ops

    got = ops.ebg_membership(keep, u, v)
    check(torch.equal(got, ebg_score.ebg_membership_plain(keep, u, v)),
          "ebg_membership differs from the plain version")
    return got


def attention_inputs(B, Hq, Hkv, D, S, dtype, dev, seed):
    """q, k, v made on the card from a seeded generator."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev, dtype=dtype)
            for shape in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]


def over_limit(got, want, rtol, atol) -> float:
    """max |got - want| / (atol + rtol |want|): at most 1 within the limit."""
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def compare_attention(q, k, v, softcap):
    """Kernel against plain version at ATTN_TOL, and the control against the
    same limit, which it must fail. Returns (kernel result, readings)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import decode_attn

    got = ops.decode_attention(q, k, v, softcap=softcap)
    want = decode_attn.decode_attention_plain(q, k, v, softcap=softcap).float()
    rtol, atol = ATTN_TOL[q.dtype]
    check(got.dtype == q.dtype and got.shape == q.shape, "decode_attention output type/shape")
    check(bool(torch.isfinite(got.float()).all()), "decode_attention gave non-finite values")
    reading = dict(max_abs_err=float((got.float() - want).abs().max()),
                   over_limit=over_limit(got.float(), want, rtol, atol),
                   control_over_limit=over_limit(ATTN_CONTROL * got.float(), want, rtol, atol))
    what = f"decode_attention {q.dtype} softcap={softcap}"
    check(reading["over_limit"] <= 1.0,
          f"{what} differs beyond rtol {rtol}, atol {atol}: {reading}")
    check(reading["control_over_limit"] > 1.0,
          f"{what}: the limit passes the control (output x {ATTN_CONTROL}): {reading}")
    return got, reading


def phase_new_kernels(g, pipe, sym, dirn, dev):
    """segment_reduce, ebg_membership and decode_attention against their
    plain versions on the smoke graph's state and the parity tests' shapes."""
    from repro_torch.graph import engine

    errs = {}
    for prog, sub, ops_ in (("cc", sym, ("min", "max")), ("pr", dirn, ("sum",))):
        (lsrc, ldst, w, deg), val, n = engine.kernel_inputs(sub, prog,
                                                            num_vertices=g.num_vertices)
        if deg is not None:
            val = pr_share(val, deg)
        for worker in (0, 1):
            for op in ops_:
                _, errs[f"segment_{op}/{prog}/w{worker}"] = compare_segment(
                    op, lsrc[worker], ldst[worker], w[worker], val[worker], n)
    # Hub-heavy: one destination owns 90 % of the edges (dst 7 of V + 1).
    gen = torch.Generator(device=dev).manual_seed(7)
    V, E = 1 << 14, 1 << 20
    other = torch.randint(0, V, (E,), generator=gen, device=dev)
    hub = torch.rand((E,), generator=gen, device=dev) < 0.9
    ldst = torch.where(hub, 7, other).sort().values.to(torch.int32)
    lsrc = torch.randint(0, V, (E,), generator=gen, device=dev, dtype=torch.int32)
    w = torch.rand((E,), generator=gen, device=dev)
    val = torch.rand((V + 1,), generator=gen, device=dev) * 5
    for op in ("min", "sum"):
        _, errs[f"segment_{op}/hub"] = compare_segment(op, lsrc, ldst, w, val, V + 1)
    log(f"kernels: segment_reduce == plain on the smoke CC/PR streams and a hub stream; "
        f"max |err| {errs}")

    order = pipe.result.order
    u = g.src[order].to(dev)
    v = g.dst[order].to(dev)
    keep = keep_bits_of(u, v, pipe.result.part.to(dev), PARTS, g.num_vertices)
    memb = compare_membership(keep, u, v)
    check(bool((memb.gather(0, pipe.result.part.to(dev).long()[None]) == 0).all()),
          "an edge's endpoints are missing from its own part's bitset")
    log(f"kernels: ebg_membership == plain on the smoke partition's bitset {tuple(keep.shape)}")

    for i, (B, Hq, Hkv, D, S) in enumerate(ATTN_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            for softcap in (0.0, 30.0):
                q, k, v = attention_inputs(B, Hq, Hkv, D, S, dtype, dev, seed=i)
                _, errs[f"attn/{B}x{Hq}x{Hkv}x{D}x{S}/{dtype}/cap{softcap}"] = \
                    compare_attention(q, k, v, softcap)
    for i, (B, Hq, Hkv, D, S) in enumerate(PADDED_ATTN_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            for softcap in (0.0, 30.0):
                q, k, v = attention_inputs(B, Hq, Hkv, D, S, dtype, dev, seed=100 + i)
                _, errs[f"attn/{B}x{Hq}x{Hkv}x{D}x{S}/{dtype}/cap{softcap}"] = \
                    compare_attention(q, k, v, softcap)
    log("kernels: decode_attention == plain at the parity shapes and head_dims 112, 16, 17 "
        "(f32, bf16, softcap 0/30)")
    return errs


def phase_kernels(dev):
    from repro_torch.api.pipeline import GraphPipeline
    from repro_torch.graph.build import build_subgraphs
    from repro_torch.graph.generate import rmat

    g = rmat(**SMOKE)
    nblocks = -(-g.num_edges // 256)
    for scorer, window in (("ebv", False), ("ebv", True), ("hdrf", False), ("greedy", False)):
        st, start = commit_blocks(g, scorer, window, dev, first=100, count=6)
        compare_commit_stream(start, st, 100, 8, window)
    commit_blocks(g, "ebv", False, dev, first=nblocks - 2, count=2)  # the padded tail block
    for scorer, window in (("ebv", False), ("hdrf", True)):  # p > 32: the block-wide kernel
        st, start = commit_blocks(g, scorer, window, dev, first=50, count=2, parts=64)
        compare_commit_stream(start, st, 50, 4, window)
    compare_transposes(dev)
    log("kernels: ebg_commit == plain on 30 smoke blocks (ebv frozen/window, hdrf, greedy; "
        "p=32 and p=64), as single blocks and as streams; its transposes == plain")

    pipe = GraphPipeline(g, device=dev).partition("ebg_chunked", parts=PARTS)
    sym = pipe.subgraphs_for(symmetrize=True)
    dirn = pipe.subgraphs_for(symmetrize=False)
    flat = build_subgraphs(g, pipe.result, symmetrize=True, addressing="flat", device=dev)
    errs = {}
    for prog, sub in (("cc", sym), ("reach", sym), ("reach", flat), ("sssp", dirn),
                      ("bfs", dirn), ("pr", dirn)):
        _, val, _, _, err = compare_superstep(sub, prog, g.num_vertices)
        errs[f"{prog}/{sub.addressing}"] = err
        if sub is flat:
            check(bool((val < 0).any()), "flat REACH must hand the kernel negative values")
    # Flat REACH end to end: the kernel sees raw negated global ids, and
    # must give what two-level (rank-compressed) REACH gives.
    two = pipe.run("reach")
    from repro_torch.graph import algorithms as alg

    vals, st = alg.run_program(flat, "reach", num_vertices=g.num_vertices)
    check(st.total_messages == two.stats.total_messages and st.supersteps == two.stats.supersteps,
          "flat REACH stats differ from two-level")
    check(np.array_equal(alg.scatter_to_global(flat, vals, g.num_vertices), two.to_global()),
          "flat REACH labels differ from two-level")
    errs["pr/hub"] = compare_bsp_sum_hub(dev)
    # One launch over a batch's B·p value rows on the shared streams.
    for prog, sub, sources in (("bfs", dirn, [0, 5, 17]), ("sssp", dirn, [3, 0]),
                               ("pr", dirn, [None, None])):
        compare_superstep_batch(sub, prog, g.num_vertices, sources)
    log(f"kernels: bsp_superstep == plain on the smoke streams and a hub stream; "
        f"max |err| {errs}")
    errs.update(phase_new_kernels(g, pipe, sym, dirn, dev))
    check_id_guard(dev)
    check_membership_guard(dev)
    log("kernels: segment_reduce, bsp_superstep and ebg_membership refuse out-of-range ids on "
        "the card, then take good ones")
    return errs


def same_run(a, b) -> bool:
    """Two runs (PipelineRuns, QueryResults) with equal values and every
    BSPStats field equal."""
    fields = ("messages_per_worker", "messages_per_step", "messages_per_step_worker",
              "inner_iters_per_step", "comp_work_per_worker")
    return (np.array_equal(a.values, b.values) and a.stats.supersteps == b.stats.supersteps
            and all(np.array_equal(getattr(a.stats, f), getattr(b.stats, f)) for f in fields))


def timed_run(pipe, prog, driver):
    """(run, wall s, host syncs) of one pipe.run, ended by a synchronize."""
    from repro_torch.graph import engine

    sync()
    syncs = engine.HOST_SYNCS[driver]
    t = time.perf_counter()
    r = pipe.run(prog, driver=driver)
    sync()
    return r, time.perf_counter() - t, engine.HOST_SYNCS[driver] - syncs


def compare_drivers(pipe, runs, label):
    """Each program's run by the fused driver (cold: `runs`, the first run,
    which captured its graph) again warm and by the host driver: values
    and every stat equal to the cold run's; the warm run captures nothing.
    Returns {program: walls and host syncs}."""
    from repro_torch.graph import engine

    out = {}
    for prog, cold in runs.items():
        captures = dict(engine.CAPTURES)
        warm, warm_s, warm_syncs = timed_run(pipe, prog, "fused")
        check(dict(engine.CAPTURES) == captures, f"{label} {prog}: a warm fused run captured")
        host, host_s, host_syncs = timed_run(pipe, prog, "host")
        check(same_run(warm, cold), f"{label} {prog}: warm fused run differs from the cold one")
        check(same_run(host, cold), f"{label} {prog}: host driver differs from the fused one")
        out[prog] = dict(supersteps=cold.stats.supersteps, fused_warm_s=warm_s,
                         fused_syncs=warm_syncs, host_s=host_s, host_syncs=host_syncs)
        log(f"drivers {label} {prog}: {cold.stats.supersteps} supersteps; fused (warm) "
            f"{warm_s * 1e3:.2f} ms, {warm_syncs} host syncs; host {host_s * 1e3:.2f} ms, "
            f"{host_syncs} host syncs; equal values and stats")
    return out


def phase_pinned(dev):
    from repro_torch.api.pipeline import GraphPipeline
    from repro_torch.graph.generate import make_graph, rmat

    times, drivers = {}, {}
    for name, pin in PINNED.items():
        t = time.perf_counter()
        g = rmat(**SMOKE) if name == "smoke" else make_graph(name)
        check((g.num_vertices, g.num_edges) == (pin["V"], pin["E"]), f"{name}: graph size")
        pipe = GraphPipeline(g, device=dev).partition("ebg_chunked", parts=PARTS)
        m = pipe.metrics
        got = tuple(f"{x:.6f}" for x in (m.replication_factor, m.edge_imbalance,
                                         m.vertex_imbalance))
        check(got == pin["metrics"], f"{name}: metrics {got} != {pin['metrics']}")
        check(pipe.default_source() == 0, f"{name}: default source")
        runs = {}
        for prog in PROGRAMS:
            r, cold_s, cold_syncs = timed_run(pipe, prog, "fused")
            got = (r.stats.supersteps, r.stats.total_messages)
            check(got == pin["runs"][prog], f"{name} {prog}: {got} != {pin['runs'][prog]}")
            if prog == "cc":
                check(r.num_components() == pin["components"], f"{name}: CC components")
            runs[prog] = r
            if name == "twitter_like":
                drivers[prog] = dict(fused_cold_s=cold_s, fused_cold_syncs=cold_syncs)
        if name == "twitter_like":
            # The host driver gives the pinned numbers too: its runs equal
            # the fused driver's (compare_drivers).
            for prog, row in compare_drivers(pipe, runs, name).items():
                drivers[prog].update(row)
        times[name] = time.perf_counter() - t
        log(f"pinned: {name} matches the reference ({times[name]:.1f} s)")
    return times, drivers


# ------------------------------------------------------ the paper's baselines


def np_splitmix(x: np.ndarray, seed: int) -> np.ndarray:
    """splitmix64 of non-negative int64 `x` in numpy uint64: the hash of the
    reference's `repro.core.baselines`, written out here as the oracle of
    the port's int64 version."""
    mix = np.uint64(0x9E3779B97F4A7C15)
    with np.errstate(over="ignore"):
        z = x.astype(np.uint64) + np.uint64(seed) * mix + mix
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def np_hash_family(name: str, src: np.ndarray, dst: np.ndarray, V: int, p: int,
                   seed: int = 0) -> np.ndarray:
    """The hash family's parts in numpy (int32), as the reference computes them."""
    src = src.astype(np.int64)
    dst = dst.astype(np.int64)
    if name == "hash":
        h = np_splitmix(src * 2654435761 + dst, seed)
        return (h % np.uint64(p)).astype(np.int32)
    if name == "dbh":
        deg = np.bincount(src, minlength=V) + np.bincount(dst, minlength=V)
        h = np_splitmix(np.where(deg[src] <= deg[dst], src, dst), seed)
        return (h % np.uint64(p)).astype(np.int32)
    pr = int(np.floor(np.sqrt(p)))
    while p % pr:
        pr -= 1
    pc = p // pr
    r = np_splitmix(src, seed) % np.uint64(pr)
    c = np_splitmix(dst, seed + 1) % np.uint64(pc)
    return (r * np.uint64(pc) + c).astype(np.int32)


def baseline_row(name, g, dev, pinned_metrics, pinned_cc, labels):
    """One partitioner on `g` through GraphPipeline on the card, then a
    symmetric build and CC, with the launch counts zeroed just before and
    read just after. Checks the pinned metrics, CC's supersteps and
    messages, and the labels against label propagation."""
    from repro_torch.api.pipeline import GraphPipeline
    from repro_torch.kernels import dispatch

    dispatch.reset_launches()
    t = time.perf_counter()
    pipe = GraphPipeline(g, device=dev).partition(name, parts=PARTS)
    res = pipe.result
    sync()
    part_s = time.perf_counter() - t
    check(res.part.device.type == "cuda", f"{name}: the partition is not on the card")
    m = pipe.metrics
    got = tuple(f"{x:.6f}" for x in (m.replication_factor, m.edge_imbalance, m.vertex_imbalance))
    check(got == pinned_metrics, f"baseline {name}: metrics {got} != {pinned_metrics}")
    t = time.perf_counter()
    pipe.subgraphs_for(symmetrize=True)
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    run = pipe.build(symmetrize=True).run("cc")
    sync()
    cc_s = time.perf_counter() - t
    launches = dict(dispatch.LAUNCHES)
    check(launches.get("bsp_superstep.min", 0) > 0,
          f"baseline {name}: CC launched bsp_superstep.min no time")
    steps = (run.stats.supersteps, run.stats.total_messages)
    check(steps == pinned_cc, f"baseline {name}: CC {steps} != {pinned_cc}")
    cov = g.covered_vertices()
    check(np.array_equal(run.to_global()[cov], labels[cov]),
          f"baseline {name}: CC labels differ from label propagation")
    row = dict(replication_factor=m.replication_factor, edge_imbalance=m.edge_imbalance,
               vertex_imbalance=m.vertex_imbalance, cc_supersteps=steps[0],
               cc_messages=steps[1], components=run.num_components(), partition_s=part_s,
               build_s=build_s, cc_s=cc_s, launches=launches)
    line = (f"baseline twitter_like p={PARTS} {name}: RF {got[0]} EI {got[1]} VI {got[2]} "
            f"CC {steps[0]} supersteps {steps[1]} messages; partition {part_s:.3f} s")
    print(line, flush=True)
    log(line)
    return row


def phase_baselines(dev):
    """The paper's baselines (hash, DBH, CVC, NE, METIS-like) beside
    ebg_chunked on twitter_like at p=32: the port's Table III/IV row for
    each, pinned to the JAX reference. hash/dbh/cvc partition on the card;
    NE and METIS-like run their loops on the host."""
    from repro_torch.graph.generate import make_graph

    g = make_graph("twitter_like")
    src = g.src.to(dev).long()
    dst = g.dst.to(dev).long()
    labels = oracle_labels(src, dst, g.num_vertices, "amin").cpu().numpy()
    del src, dst
    pin = PINNED["twitter_like"]
    rows = {"ebg_chunked": baseline_row("ebg_chunked", g, dev, pin["metrics"],
                                        pin["runs"]["cc"], labels)}
    for name, (metrics, cc) in PINNED_BASELINES.items():
        rows[name] = baseline_row(name, g, dev, metrics, cc, labels)
    return rows


def measure_hash_family(g, dev):
    """hash, DBH and CVC on the full-width graph on the card: each call's
    wall from host edges (the upload included) and its device time with
    the edges already on the card; `part` bitwise against the numpy
    splitmix64 above; the partition's metrics."""
    from repro_torch.core import PARTITIONERS, partition_metrics
    from repro_torch.core.types import Graph

    src, dst = g.src.numpy(), g.dst.numpy()
    on_card = Graph(src=g.src.to(dev), dst=g.dst.to(dev), num_vertices=g.num_vertices)
    out = {}
    for name in HASH_FAMILY:
        fn = PARTITIONERS[name]
        sync()
        t = time.perf_counter()
        res = fn(g, PARTS, device=dev)
        sync()
        wall_s = time.perf_counter() - t
        check(res.part.device.type == "cuda", f"{name}: the partition is not on the card")
        want = np_hash_family(name, src, dst, g.num_vertices, PARTS)
        check(np.array_equal(res.part.cpu().numpy(), want),
              f"{name} at full width differs from the numpy splitmix64")
        device_ms = cuda_ms(lambda: fn(on_card, PARTS, device=dev), reps=5)
        t = time.perf_counter()
        m = partition_metrics(g, res)
        metrics_s = time.perf_counter() - t
        out[name] = dict(wall_s=wall_s, device_ms=device_ms,
                         edges_per_s=g.num_edges / wall_s,
                         edges_per_s_on_card=g.num_edges / (device_ms / 1e3),
                         replication_factor=m.replication_factor,
                         edge_imbalance=m.edge_imbalance, vertex_imbalance=m.vertex_imbalance,
                         metrics_s=metrics_s)
        log(f"full: {name} == numpy splitmix64; {g.num_edges / wall_s:.4g} edges/s with the "
            f"upload, {out[name]['edges_per_s_on_card']:.4g} on the card; RF "
            f"{m.replication_factor:.6f} EI {m.edge_imbalance:.6f} VI {m.vertex_imbalance:.6f}")
        del res
    del on_card
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------- full width: oracles


def oracle_labels(src, dst, V, reduce):
    """Min (or max) label propagation over the undirected view, plain torch."""
    lab = torch.arange(V, device=src.device)
    while True:
        a = torch.minimum(lab[src], lab[dst]) if reduce == "amin" else torch.maximum(lab[src],
                                                                                      lab[dst])
        new = lab.scatter_reduce(0, src, a, reduce).scatter_reduce(0, dst, a, reduce)
        if torch.equal(new, lab):
            return lab
        lab = new


def oracle_hops(src, dst, V, source):
    dist = torch.full((V,), INF_I32, dtype=torch.int64, device=src.device)
    dist[source] = 0
    while True:
        d = dist[src]
        new = dist.scatter_reduce(0, dst, torch.where(d < INF_I32, d + 1, INF_I32), "amin")
        if torch.equal(new, dist):
            return dist
        dist = new


def oracle_pagerank(src, dst, V, iters=20, damping=0.85):
    outdeg = torch.bincount(src, minlength=V).double()
    rank = torch.full((V,), 1.0 / V, dtype=torch.float64, device=src.device)
    for _ in range(iters):
        share = torch.where(outdeg > 0, rank / outdeg.clamp(min=1), 0.0)
        rank = (1 - damping) / V + damping * torch.zeros_like(rank).index_add_(0, dst, share[src])
    return rank


def phase_full(dev, log2_edges):
    from repro_torch.api.pipeline import GraphPipeline
    from repro_torch.graph.generate import rmat
    from repro_torch.kernels import dispatch

    st = Stages()
    g = st("generate", rmat, num_edges=1 << log2_edges, **FULL)
    V = g.num_vertices
    log(f"full: {V} vertices, {g.num_edges} edges, p={PARTS}")

    # ---- the main path, with the launch counts zeroed just before it.
    dispatch.reset_launches()
    pipe = GraphPipeline(g, device=dev).partition("ebg_chunked", parts=PARTS)
    st("partition", lambda: pipe.result)
    m = st("metrics", lambda: pipe.metrics)
    runs = {}
    st("build_symmetric", pipe.subgraphs_for, symmetrize=True)
    for prog in ("cc", "reach"):
        runs[prog] = st(f"run_{prog}", pipe.run, prog)
    pipe.subgraphs_for(symmetrize=True)  # cached
    st("build_directed", pipe.subgraphs_for, symmetrize=False)
    for prog in ("sssp", "bfs", "pr"):
        runs[prog] = st(f"run_{prog}", pipe.run, prog)
    launches = dict(dispatch.LAUNCHES)
    log(f"full: launches on the main path {launches}")
    for k in ("ebg_commit", "ebg_commit.keep_to_memb", "ebg_commit.memb_to_keep",
              "bsp_superstep.min", "bsp_superstep.sum"):
        check(launches.get(k, 0) > 0, f"the main path launched {k} no time")

    # ---- what came out, against plain oracles on the card.
    t = time.perf_counter()
    src = g.src.to(dev).long()
    dst = g.dst.to(dev).long()
    cov = g.covered_vertices()
    cc = runs["cc"].to_global()[cov]
    check(np.array_equal(cc, oracle_labels(src, dst, V, "amin").cpu().numpy()[cov]),
          "CC labels differ from label propagation")
    reach = runs["reach"].to_global(reduce="max")[cov]
    check(np.array_equal(reach, oracle_labels(src, dst, V, "amax").cpu().numpy()[cov]),
          "REACH labels differ from max-label propagation")
    source = pipe.default_source()
    hops = oracle_hops(src, dst, V, source).cpu().numpy()[cov]
    check(np.array_equal(runs["bfs"].to_global()[cov], hops), "BFS differs from the oracle")
    unit = np.where(hops == INF_I32, np.float32(3.0e38), hops.astype(np.float32))
    check(np.array_equal(runs["sssp"].to_global()[cov], unit),
          "SSSP (unit weights) differs from the hop counts")
    pr = runs["pr"].to_global(reduce="sum")[cov]
    ref = oracle_pagerank(src, dst, V).cpu().numpy()[cov]
    check(np.isfinite(pr).all() and np.allclose(pr, ref, rtol=PR_ORACLE_RTOL, atol=0.0),
          "PageRank differs from a float64 power iteration")
    del src, dst
    components = runs["cc"].num_components()
    st.s["oracles"] = time.perf_counter() - t
    log(f"full: CC {components} components == label propagation; REACH, BFS, SSSP, PR "
        f"agree with their oracles ({st.s['oracles']:.1f} s)")

    t = time.perf_counter()
    drivers = compare_drivers(pipe, runs, "full")
    for prog, row in drivers.items():
        row["fused_cold_s"] = st.s[f"run_{prog}"]
    st.s["drivers"] = time.perf_counter() - t
    serve, batch_sources = phase_serve(g, pipe, dev)
    st.s["serve"] = serve["phase_s"]
    resilience = phase_resilience(pipe, runs)
    st.s["resilience"] = resilience["phase_s"]
    outofcore = phase_outofcore(g, dev)
    st.s["outofcore"] = outofcore["phase_s"]
    distributed = phase_distributed(pipe, runs, drivers, dev)
    st.s["distributed"] = distributed["phase_s"]

    summary = dict(
        vertices=V, edges=g.num_edges, parts=PARTS, stage_s=st.s, launches=launches,
        drivers=drivers, serve=serve, resilience=resilience, outofcore=outofcore,
        distributed=distributed,
        metrics=dict(replication_factor=m.replication_factor, edge_imbalance=m.edge_imbalance,
                     vertex_imbalance=m.vertex_imbalance),
        components=components, source=source,
        runs={p: dict(supersteps=r.stats.supersteps, messages=r.stats.total_messages,
                      max_mean=r.stats.max_mean,
                      inner_iters=r.stats.inner_iters_per_step.sum(axis=1).tolist())
              for p, r in runs.items()},
    )
    kernels = measure_kernels(g, pipe, runs, launches, dev, batch_sources, serve["launches"])
    for e in kernels:  # the launches on the two new paths, beside the main path's
        e["resilience_launches"] = resilience["launches"].get(e["name"], 0)
        e["outofcore_launches"] = outofcore["launches"].get(e["name"], 0)
        e["dist_launches"] = distributed["stepper_launches"].get(e["name"], 0)
        e["sharded_launches"] = distributed["sharded_launches"].get(e["name"], 0)
    next(e for e in kernels if e["name"] == "ebg_commit").update(
        outofcore_block=OUT_OF_CORE["block"],
        outofcore_stream_ms=outofcore["commit_stream_ms"],
        outofcore_stream_ms_per_block=outofcore["commit_ms_per_block"],
        outofcore_block_call_ms=outofcore["block_call_ms"])
    summary["hash_family"] = measure_hash_family(g, dev)
    return summary, kernels


def phase_serve(g, pipe, dev):
    """The serving tier at full width on the main path's directed build:
    a synthetic trace of point queries through GraphPipeline.serve (warm
    first: every (program, bucket) graph captured), launch counts zeroed
    just before and read just after. Every answer against the BFS oracle
    from its source; the first batch of each program against single runs
    of the host driver, values and stats bitwise. Returns (the report row
    with the capture seconds and launches, the first BATCH_B BFS sources)."""
    from repro_torch.graph import algorithms as alg
    from repro_torch.kernels import dispatch
    from repro_torch.serve.trace import synthetic_trace

    t0 = time.perf_counter()
    V = g.num_vertices
    trace = synthetic_trace(g, SERVE["queries"], rate_qps=SERVE["rate_qps"], mix=SERVE["mix"],
                            seed=SERVE["seed"])
    trace_s = time.perf_counter() - t0
    server = pipe.serve(max_batch=SERVE["max_batch"])
    check(server.buckets == (1, 2, 4, 8), f"serve buckets {server.buckets}")
    dispatch.reset_launches()
    sync()
    t = time.perf_counter()
    report = server.run_trace(trace)
    sync()
    replay_s = time.perf_counter() - t
    launches = dict(dispatch.LAUNCHES)
    check(launches.get("bsp_superstep.min", 0) > 0, "the serving path launched no min kernel")
    row = report.row()
    check(row["resilience"]["answered"] == SERVE["queries"], f"serve: {row['resilience']}")
    log(f"serve: {SERVE['queries']} queries in {row['batches']} batches (mean "
        f"{row['mean_batch']}), p50 {row['latency_p50_s']} s, p99 {row['latency_p99_s']} s, "
        f"captures {server.cache.compile_s:.2f} s; launches {launches}")

    # Every answer against the oracle from its source.
    t = time.perf_counter()
    sub = pipe.subgraphs_for(symmetrize=False)
    src = g.src.to(dev).long()
    dst = g.dst.to(dev).long()
    cov = g.covered_vertices()
    hops = {}
    results = [server.result(q) for q in range(SERVE["queries"])]
    for r in results:
        check(r.ok, f"serve: query {r.qid} failed")
        if r.source not in hops:
            hops[r.source] = oracle_hops(src, dst, V, r.source).cpu().numpy()[cov]
        want = hops[r.source]
        if r.program == "sssp":
            want = np.where(want == INF_I32, np.float32(3.0e38), want.astype(np.float32))
        check(np.array_equal(alg.scatter_to_global(sub, r.values, V)[cov], want),
              f"serve: query {r.qid} ({r.program} from {r.source}) differs from the oracle")
    del src, dst
    oracle_s = time.perf_counter() - t
    # The first batch of each program against single host-driver runs, and
    # its wall against the same queries' single fused runs (warm).
    t = time.perf_counter()
    first = {}
    for prog in ("bfs", "sssp"):
        mine = [r for r in results if r.program == prog]
        batch_wall = next(w for name, _, _, w in server._batch_log if name == prog)
        fused_s = 0.0
        for r in mine[:mine[0].batch]:
            check(same_run(r, pipe.run(prog, source=r.source, driver="host")),
                  f"serve: {prog} from {r.source} differs from its single host-driver run")
            sync()
            t1 = time.perf_counter()
            pipe.run(prog, source=r.source)
            sync()
            fused_s += time.perf_counter() - t1
        first[prog] = dict(queries=mine[0].batch, bucket=mine[0].bucket, batch_wall_s=batch_wall,
                           singles_fused_s=fused_s)
    singles_s = time.perf_counter() - t
    log(f"serve: all {len(results)} answers == the oracle ({oracle_s:.1f} s); the first batch "
        f"of each program == single host-driver runs; batch wall against the same queries' "
        f"single fused runs {first} ({singles_s:.1f} s)")
    bfs_sources = [r.source for r in results if r.program == "bfs"][:BATCH_B]
    out = dict(row, capture_s=server.cache.compile_s, trace_s=trace_s, replay_s=replay_s,
               oracle_s=oracle_s, singles_s=singles_s, first_batch=first, launches=launches,
               batch_log=[dict(program=n, queries=q, bucket=b, wall_s=w)
                          for n, q, b, w in server._batch_log],
               phase_s=time.perf_counter() - t0)
    return out, bfs_sources


# ----------------------------- full width: checkpoint/resume and out-of-core


def phase_resilience(pipe, runs):
    """Crash and resume at full width on the main path's builds: each
    program of RESILIENCE runs through GraphPipeline.run checkpointed every
    k supersteps with a crash planned at superstep s, twice — resumed by the
    fused driver, and resumed by the host driver. Each resumed run's values
    and every BSPStats field equal the main path's uninterrupted fused run,
    bitwise. Launch counts are zeroed just before and read just after the
    phase. Snapshots go to a temporary directory, removed at the end."""
    from repro_torch.checkpoint import ckpt as ckpt_mod
    from repro_torch.graph import engine
    from repro_torch.kernels import dispatch
    from repro_torch.resilience import FaultPlan, WorkerCrashError, resume_bsp

    t0 = time.perf_counter()
    save = ckpt_mod.save
    saves = dict(n=0, s=0.0)

    def timed_save(*a, **kw):  # the snapshot writes' wall, inside the crash runs
        t = time.perf_counter()
        out = save(*a, **kw)
        saves["s"] += time.perf_counter() - t
        saves["n"] += 1
        return out

    out = {}
    dispatch.reset_launches()
    ckpt_mod.save = timed_save
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
            for prog, every, crash in RESILIENCE:
                base = runs[prog]
                check(crash < base.stats.supersteps,
                      f"resilience {prog}: crash at {crash} is past the run's end")
                rows = {}
                for driver in ("fused", "host"):
                    ckpt = Path(tmp) / f"{prog}_{driver}"
                    captures = dict(engine.CAPTURES)
                    saves.update(n=0, s=0.0)
                    sync()
                    t = time.perf_counter()
                    try:
                        pipe.run(prog, checkpoint_every=every, ckpt_dir=ckpt,
                                 fault_plan=FaultPlan(crash_at_superstep=crash))
                        raise AssertionError(f"resilience {prog}: no crash at superstep {crash}")
                    except WorkerCrashError as e:
                        check(e.superstep == crash, f"resilience {prog}: crashed at {e.superstep}")
                    sync()
                    crash_s = time.perf_counter() - t
                    steps = sorted(int(d.name.split("_")[1]) for d in ckpt.glob("step_*"))
                    check(steps == list(range(0, crash + 1, every)),
                          f"resilience {prog}: snapshots at {steps}")
                    snap_bytes = sum(f.stat().st_size for f in (ckpt / f"step_{steps[-1]:08d}")
                                     .iterdir())
                    save_n, save_s = saves["n"], saves["s"]
                    t = time.perf_counter()
                    val, stats = resume_bsp(base.subgraphs, ckpt_dir=ckpt, driver=driver)
                    sync()
                    resume_s = time.perf_counter() - t
                    check(same_run(types.SimpleNamespace(values=val[:, :-1].cpu().numpy(),
                                                         stats=stats), base),
                          f"resilience {prog}: the run resumed by the {driver} driver differs "
                          "from the uninterrupted one")
                    new = {k: engine.CAPTURES[k] - captures.get(k, 0) for k in ("loops", "graphs")}
                    rows[driver] = dict(crash_run_s=crash_s, snapshots=steps,
                                        snapshot_bytes=snap_bytes, saves=save_n, save_s=save_s,
                                        resume_s=resume_s, resumed_from=steps[-1],
                                        new_captures=new)
                    log(f"resilience {prog}: crash at {crash} (k={every}) in {crash_s:.2f} s, "
                        f"{save_n} snapshots of {snap_bytes} bytes in {save_s:.3f} s; resumed by "
                        f"the {driver} driver from {steps[-1]} in {resume_s:.3f} s: equal values "
                        f"and stats; new loops/graphs {new}")
                out[prog] = dict(checkpoint_every=every, crash_at=crash,
                                 supersteps=base.stats.supersteps, **rows)
    finally:
        ckpt_mod.save = save
    launches = dict(dispatch.LAUNCHES)
    for k in ("bsp_superstep.min", "bsp_superstep.sum"):
        check(launches.get(k, 0) > 0, f"the resilience path launched {k} no time")
    log(f"resilience: launches {launches}")
    return dict(programs=out, launches=launches, phase_s=time.perf_counter() - t0)


def phase_outofcore(g, dev):
    """The out-of-core pipeline at full width: the graph written to a shard
    store on local disk, its degrees and the external degree-sum order,
    then partition_store (ebv, p=32, block 4,096) with its state on the
    card, launch counts zeroed just before and read just after. Against the
    in-memory driver's stream on the card (prepare_stream and one
    ebg_commit_stream, the body of streaming_chunked_partition): the order,
    the assignments in stream and input order and the counters, bitwise;
    the counters' RF beside partition_metrics'. Then, on twitter_like (the
    full-width build would pass the time limit), the streamed build from
    edge_part_stream against build_subgraphs on the same partition (every
    field), and CC on both. The store and the order's buckets go to a
    temporary directory, removed at the end."""
    from repro_torch.core import outofcore as oc
    from repro_torch.core.metrics import partition_metrics
    from repro_torch.core.streaming import prepare_stream
    from repro_torch.data import edgeshards as es
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import ebg_commit as ebg

    t0 = time.perf_counter()
    st = Stages()
    block = OUT_OF_CORE["block"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shards_") as tmp:
        store = st("oc_write", es.write_graph, g, Path(tmp) / "store",
                   shard_edges=OUT_OF_CORE["shard_edges"])
        deg = st("oc_degrees", es.degrees_from_shards, store)
        check(np.array_equal(deg, g.degrees()), "degrees_from_shards differs from the graph's")
        ordered = st("oc_order", es.degree_sum_stream, store, deg, workdir=Path(tmp) / "order")
        disk = sum(f.stat().st_size for f in Path(tmp).rglob("*") if f.is_file())
        dispatch.reset_launches()
        res = st("oc_partition", oc.partition_store, store, PARTS, "ebv", block=block,
                 degrees=deg, ordered=ordered, device=dev)
        launches = dict(dispatch.LAUNCHES)
        check(launches.get("ebg_commit", 0) > 0, "the out-of-core path launched ebg_commit no time")
        check(res.result.part.device.type == "cuda", "the out-of-core partition is not on the card")
        host_split = st("oc_host_side", outofcore_host_side, ordered, g.num_vertices, block, dev)
    log(f"outofcore: partition_store's host side alone (its group loop with no commit): "
        f"{host_split}")
    E = g.num_edges

    # The in-memory driver's stream at the same block, with its counters;
    # the kernel timed apart (CUDA events), and one block's wrapper call
    # (ebg_commit_block: argument checks, the id check, both transposes),
    # which partition_store would pay once a block if it fed blocks alone.
    timing = {}

    def in_memory():
        mem = prepare_stream(g, PARTS, "ebv", block=block, device=dev)
        keep, e_c, v_c = mem.new_state(PARTS, g.num_vertices)
        t0e, t1e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0e.record()
        parts = ebg.ebg_commit_stream(keep, e_c, v_c, mem.u, mem.v, mem.valid, mem.coef,
                                      block=block, balance=mem.balance)
        t1e.record()
        t1e.synchronize()
        timing["commit_stream_ms"] = t0e.elapsed_time(t1e)
        # The same stream at block 2,048, the largest block whose staging
        # fits the pipelined kernel at p = 32 (timing only; its padding is
        # whole blocks of 2,048 too).
        half = block // 2
        fresh = mem.new_state(PARTS, g.num_vertices)
        t0e.record()
        ebg.ebg_commit_stream(*fresh, mem.u, mem.v, mem.valid, mem.coef, block=half,
                              balance=mem.balance)
        t1e.record()
        t1e.synchronize()
        timing["commit_stream_ms_half_block"] = t0e.elapsed_time(t1e)
        timing["half_block"] = half
        mid = slice((res.num_blocks // 2) * block, (res.num_blocks // 2 + 1) * block)
        args = (keep, e_c, v_c, mem.u[mid], mem.v[mid], mem.valid[mid], mem.coef)
        timing["block_call_ms"] = cuda_ms(lambda: ebg.ebg_commit_block(*args), reps=20)
        return mem.order, parts[:E], e_c, v_c

    launches_partition = dict(launches)
    order, parts, e_c, v_c = st("oc_in_memory", in_memory)
    timing["commit_ms_per_block"] = timing["commit_stream_ms"] / res.num_blocks
    log(f"outofcore: the commit kernel at block {block}: {timing['commit_stream_ms']:.1f} ms "
        f"the stream, {timing['commit_ms_per_block'] * 1e3:.2f} µs a block; at block "
        f"{timing['half_block']}: {timing['commit_stream_ms_half_block']:.1f} ms the stream; one "
        f"ebg_commit_block call {timing['block_call_ms']:.3f} ms")
    check(np.array_equal(res.result.order.numpy(), order),
          "degree_sum_stream's permutation differs from degree_sum_order's")
    check(torch.equal(res.result.part, parts), "the out-of-core assignments differ (stream order)")
    in_input = np.empty(E, np.int32)
    in_input[order] = parts.cpu().numpy()
    check(np.array_equal(res.result.part_in_input_order(), in_input),
          "the out-of-core assignments differ (input order)")
    check(np.array_equal(res.e_count, e_c.cpu().numpy()) and
          np.array_equal(res.v_count, v_c.cpu().numpy()), "the out-of-core counters differ")
    m = st("oc_metrics", partition_metrics, g, res.result)
    check(np.array_equal(res.e_count, m.edges_per_part.astype(np.float32)),
          "the edge counters differ from partition_metrics'")
    check(bool((res.v_count >= m.vertices_per_part).all()),
          "a vertex counter is below partition_metrics' |V_i|")
    part_s = st.s["oc_partition"]
    log(f"outofcore: partition_store == the in-memory stream (order, parts, counters); "
        f"{launches.get('ebg_commit', 0)} ebg_commit launches, {E / part_s:.4g} edges/s "
        f"({E / (part_s + st.s['oc_order']):.4g} with the order); RF counters "
        f"{res.replication_factor:.6f}, partition_metrics {m.replication_factor:.6f}")
    row = dict(edges=E, blocks=res.num_blocks, disk_bytes=disk, stage_s=dict(st.s),
               launches=launches, partition_launches=launches_partition, **timing,
               host_side_s=host_split,
               edges_per_s=E / part_s,
               edges_per_s_with_order=E / (part_s + st.s["oc_order"]),
               rf_counters=res.replication_factor, rf_metrics=m.replication_factor,
               edge_imbalance=m.edge_imbalance, vertex_imbalance=m.vertex_imbalance)
    del res, parts, e_c, v_c, order
    row["build"] = outofcore_build(dev)
    # The phase's: both partition_store runs (full width, twitter_like) and
    # CC on the streamed build, each counted around its own call.
    for path in ("partition_launches", "cc_launches"):
        for k, v in row["build"][path].items():
            launches[k] = launches.get(k, 0) + v
    row["phase_s"] = time.perf_counter() - t0
    return row


def outofcore_host_side(ordered, num_vertices, block, dev):
    """partition_store's host work a group, timed by itself: the ordered
    stream's bucket reads and sorts, the intake validation, and the padding
    with its upload to the card (synchronized), with no commit."""
    from repro_torch.core import outofcore as oc
    from repro_torch.core.streaming import pad_blocks, validate_edge_stream

    group = block * max(1, oc.GROUP_EDGES // block)
    split = dict(read_s=0.0, validate_s=0.0, upload_s=0.0)
    blocks = ordered.iter_blocks(group)
    while True:
        t = time.perf_counter()
        item = next(blocks, None)
        split["read_s"] += time.perf_counter() - t
        if item is None:
            return split
        gsrc, gdst, _ = item
        t = time.perf_counter()
        validate_edge_stream(gsrc, gdst, num_vertices=num_vertices)
        split["validate_s"] += time.perf_counter() - t
        t = time.perf_counter()
        pad_blocks(gsrc, gdst, None, block, dev)
        sync()
        split["upload_s"] += time.perf_counter() - t


def outofcore_build(dev):
    """twitter_like through the out-of-core pipeline on the card, then the
    streamed build of its partition (symmetric) and CC: every SubgraphSet
    field against build_subgraphs on the same partition (the edge list in
    the partition's stream order), CC's labels and every stat against CC on
    that build and the labels against label propagation."""
    from repro_torch.core import outofcore as oc
    from repro_torch.core.types import Graph, PartitionResult
    from repro_torch.data import edgeshards as es
    from repro_torch.graph import algorithms as alg
    from repro_torch.graph.build import ARRAY_FIELDS, build_subgraphs
    from repro_torch.graph.build_stream import build_subgraphs_stream
    from repro_torch.graph.engine import run_bsp
    from repro_torch.graph.generate import make_graph
    from repro_torch.kernels import dispatch

    st = Stages()
    tw = make_graph("twitter_like")
    V = tw.num_vertices
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tw_") as tmp:
        store = es.write_graph(tw, Path(tmp) / "store", shard_edges=OUT_OF_CORE["shard_edges"])
        dispatch.reset_launches()
        res = st("tw_partition", oc.partition_store, store, PARTS, "ebv",
                 block=OUT_OF_CORE["block"], order_workdir=Path(tmp) / "order", device=dev)
        partition_launches = dict(dispatch.LAUNCHES)
        check(partition_launches.get("ebg_commit", 0) > 0,
              "partition_store on twitter_like launched ebg_commit no time")
        sub = st("tw_build_stream", build_subgraphs_stream,
                 lambda: res.edge_part_stream(OUT_OF_CORE["shard_edges"]), V, PARTS,
                 symmetrize=True, device=dev)
    order = res.result.order
    in_stream = Graph(src=tw.src[order], dst=tw.dst[order], num_vertices=V)
    ref = st("tw_build", build_subgraphs, in_stream,
             PartitionResult(part=res.result.part, num_parts=PARTS), symmetrize=True, device=dev)
    for f in ARRAY_FIELDS:
        check(torch.equal(getattr(sub, f), getattr(ref, f)), f"streamed build: field {f} differs")
    check((sub.num_parts, sub.max_v, sub.max_e, sub.max_msg, sub.addressing) ==
          (ref.num_parts, ref.max_v, ref.max_e, ref.max_msg, ref.addressing),
          "streamed build: sizes differ")
    dispatch.reset_launches()
    val, stats = st("tw_cc_stream", run_bsp, sub, "cc")
    cc_launches = dict(dispatch.LAUNCHES)
    check(cc_launches.get("bsp_superstep.min", 0) > 0, "CC on the streamed build launched no min")
    val2, stats2 = run_bsp(ref, "cc")
    check(same_run(types.SimpleNamespace(values=val.cpu().numpy(), stats=stats),
                   types.SimpleNamespace(values=val2.cpu().numpy(), stats=stats2)),
          "CC on the streamed build differs from CC on the in-memory build")
    cov = tw.covered_vertices()
    labels = oracle_labels(tw.src.to(dev).long(), tw.dst.to(dev).long(), V, "amin").cpu().numpy()
    got = alg.scatter_to_global(sub, val[:, :-1].cpu().numpy(), V)
    check(np.array_equal(got[cov], labels[cov]), "CC on the streamed build: labels differ")
    log(f"outofcore twitter_like: streamed build == build_subgraphs (every field); CC "
        f"{stats.supersteps} supersteps, {stats.total_messages} messages, == the in-memory "
        f"build's and label propagation; RF (counters) {res.replication_factor:.6f}; "
        f"launches: partition_store {partition_launches}, CC on the streamed build "
        f"{cc_launches}")
    return dict(edges=tw.num_edges, stage_s=dict(st.s), cc_supersteps=stats.supersteps,
                cc_messages=stats.total_messages, rf_counters=res.replication_factor,
                partition_launches=partition_launches, cc_launches=cc_launches)


# ------------------------------------------------------ the distributed path


def phase_distributed(pipe, runs, drivers, dev):
    """The distributed engine on a NCCL world of this process alone (rank 0
    on the card, a `file://` rendezvous in a temporary directory): the
    stepper at full width with all 32 subgraphs on rank 0 (CC and REACH on
    the symmetric build, SSSP, BFS and PR on the directed one), each held
    against the main path's fused run, values and every stat bitwise, its
    wall and host syncs beside the fused and host drivers'; then
    GraphPipeline.run(mode="dist") at p = 1 on twitter_like against
    mode="sim"; then partition_store's sharded layout on twitter_like
    (ebv, frozen, block 256, state on the card) against the replicated
    layout: the order, the parts and the counters, bitwise, and edges/s of
    each. Launch counts are zeroed just before each of those runs and read
    just after. With two cards or more, a NCCL world of 2 also runs the
    full-width CC stepper on two cards (`dist_world2`)."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", rank=0,
                                world_size=1, timeout=datetime.timedelta(seconds=300))
        try:
            mesh = make_host_mesh()
            # NCCL sets its communicator up at the first collective: pay it here.
            t = time.perf_counter()
            dist.all_reduce(torch.ones(1, device=dev))
            sync()
            out["nccl_setup_s"] = time.perf_counter() - t
            out["stepper"], out["stepper_launches"] = dist_stepper(pipe, runs, drivers, mesh)
            out["pipeline_p1"] = dist_pipeline_p1(mesh, dev)
            out["sharded"], out["sharded_launches"] = dist_sharded(mesh, dev, Path(tmp))
        finally:
            dist.destroy_process_group()
        out["world2"] = dist_world2(pipe, runs, Path(tmp))
    out["phase_s"] = time.perf_counter() - t0
    log(f"distributed: phase {out['phase_s']:.1f} s")
    return out


def dist_stepper(pipe, runs, drivers, mesh):
    """Each program through make_distributed_stepper at the main path's
    knobs (run_bsp's defaults), against its fused run."""
    from repro_torch.graph import engine
    from repro_torch.kernels import dispatch

    V = pipe.graph.num_vertices
    rows, launches = {}, {}
    for prog in PROGRAMS:
        P = engine.get_program(prog)
        sub = pipe.subgraphs_for(symmetrize=P.bidirectional)
        arrays, statics = engine.subgraphs_to_arrays(sub)
        runner = engine.make_distributed_stepper(
            mesh, "workers", P, statics, num_supersteps=P.default_steps or 200,
            inner_cap=10_000, num_vertices=V)
        init = P.init(sub, num_vertices=V,
                      source=pipe.default_source() if P.needs_source else None)
        edges = sub.edge_mask.sum(dim=1).cpu().numpy().astype(np.int64)
        row = dict(fused_warm_s=drivers[prog]["fused_warm_s"], host_s=drivers[prog]["host_s"])
        # Cold: the first call cuts the shard and builds its run plan;
        # warm: the same runner again. Launches are counted on the cold run.
        for run in ("cold", "warm"):
            syncs = engine.HOST_SYNCS["dist"]
            if run == "cold":
                dispatch.reset_launches()
            sync()
            t = time.perf_counter()
            val, _, steps, ms, its = runner(arrays, init)
            row[f"dist_{run}_s"] = time.perf_counter() - t
            row["dist_syncs"] = engine.HOST_SYNCS["dist"] - syncs
            if run == "cold":
                for k, v in dispatch.LAUNCHES.items():
                    launches[k] = launches.get(k, 0) + v
            stats = engine._assemble_stats(steps, ms[:steps].numpy().astype(np.int64),
                                           its[:steps].numpy().astype(np.int64), edges)
            check(same_run(types.SimpleNamespace(values=val[:, :-1].numpy(), stats=stats),
                           runs[prog]),
                  f"distributed {prog}: the stepper ({run}) differs from the fused run")
        row["supersteps"] = steps
        rows[prog] = row
        log(f"distributed {prog}: the stepper on NCCL (world 1, 32 subgraphs on rank 0) == the "
            f"fused run, cold and warm; {steps} supersteps, cold {row['dist_cold_s'] * 1e3:.2f} "
            f"ms, warm {row['dist_warm_s'] * 1e3:.2f} ms, {row['dist_syncs']} host syncs; fused "
            f"(warm) {row['fused_warm_s'] * 1e3:.2f} ms, host {row['host_s'] * 1e3:.2f} ms")
        del runner
    for k in ("bsp_superstep.min", "bsp_superstep.sum"):
        check(launches.get(k, 0) > 0, f"the distributed stepper launched {k} no time")
    log(f"distributed: stepper launches {launches}")
    return rows, launches


def dist_pipeline_p1(mesh, dev):
    from repro_torch.api.pipeline import GraphPipeline
    from repro_torch.graph.generate import make_graph

    pipe = GraphPipeline(make_graph("twitter_like"), device=dev).partition("ebg_chunked",
                                                                           parts=1)
    sim = pipe.run("cc")
    sync()
    t = time.perf_counter()
    d = pipe.run("cc", mode="dist", mesh=mesh)
    wall = time.perf_counter() - t
    check(same_run(d, sim), "mode='dist' at p = 1 differs from mode='sim' (twitter_like CC)")
    log(f"distributed: GraphPipeline.run('cc', mode='dist') at p = 1 on twitter_like == "
        f"mode='sim' ({d.stats.supersteps} supersteps, {wall * 1e3:.1f} ms)")
    return dict(supersteps=d.stats.supersteps, messages=d.stats.total_messages, dist_s=wall)


def dist_sharded(mesh, dev, tmp):
    """twitter_like's out-of-core partition with the bitset's rows sharded
    over the mesh (one launch and one all_gather a block) against the
    replicated layout (one launch a group of 256 blocks), both on one
    degree-sum order."""
    from repro_torch.core import outofcore as oc
    from repro_torch.data import edgeshards as es
    from repro_torch.graph.generate import make_graph
    from repro_torch.kernels import dispatch

    tw = make_graph("twitter_like")
    store = es.write_graph(tw, tmp / "store", shard_edges=OUT_OF_CORE["shard_edges"])
    deg = es.degrees_from_shards(store)
    ordered = es.degree_sum_stream(store, deg, workdir=tmp / "order")
    kw = dict(block=DIST_SHARDED_BLOCK, commit="frozen", degrees=deg, ordered=ordered,
              device=dev)
    sync()
    t = time.perf_counter()
    rep = oc.partition_store(store, PARTS, "ebv", **kw)
    sync()
    rep_s = time.perf_counter() - t
    dispatch.reset_launches()
    t = time.perf_counter()
    sh = oc.partition_store(store, PARTS, "ebv", state_layout="sharded", mesh=mesh, **kw)
    sync()
    sh_s = time.perf_counter() - t
    launches = dict(dispatch.LAUNCHES)
    for k in ("ebg_commit", "ebg_commit.keep_to_memb", "ebg_commit.memb_to_keep"):
        check(launches.get(k, 0) == sh.num_blocks, f"the sharded layout launched {k} "
              f"{launches.get(k, 0)} times, not once a block ({sh.num_blocks})")
    check(np.array_equal(sh.result.order.numpy(), rep.result.order.numpy()),
          "sharded layout: the order differs")
    check(torch.equal(sh.result.part, rep.result.part), "sharded layout: the parts differ")
    check(np.array_equal(sh.e_count, rep.e_count) and np.array_equal(sh.v_count, rep.v_count),
          "sharded layout: the counters differ")
    E = tw.num_edges
    row = dict(edges=E, block=DIST_SHARDED_BLOCK, blocks=sh.num_blocks, sharded_s=sh_s,
               replicated_s=rep_s, sharded_edges_per_s=E / sh_s, replicated_edges_per_s=E / rep_s)
    log(f"distributed: sharded out-of-core layout on twitter_like == replicated (order, parts, "
        f"counters); {sh.num_blocks} blocks of {DIST_SHARDED_BLOCK}: sharded {sh_s:.2f} s "
        f"({E / sh_s:.4g} edges/s), replicated {rep_s:.2f} s ({E / rep_s:.4g} edges/s); "
        f"launches {launches}")
    return row, launches


def dist_world2(pipe, runs, tmp):
    """With two cards or more: CC's full-width stepper on a NCCL world of
    2, one rank a card (this script's --dist-child mode), against the
    fused run."""
    from repro_torch.graph import engine

    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"distributed: {cards} card(s) here: no NCCL world of 2 runs (not a failure)")
        return dict(ran=False, cards=cards)
    sub = pipe.subgraphs_for(symmetrize=True)
    arrays, statics = engine.subgraphs_to_arrays(sub)
    work = tmp / "world2"
    work.mkdir()
    torch.save(dict(arrays={k: a.cpu() for k, a in arrays.items()}, statics=statics,
                    init=engine.init_cc(sub).cpu()), work / "input.pt")
    t = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dist-child",
                               str(work)], env=dict(os.environ, RANK=str(r), WORLD_SIZE="2",
                                                    LOCAL_RANK=str(r)))
             for r in range(2)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    check(codes == [0, 0], f"the NCCL world of 2 exited {codes}")
    got = torch.load(work / "output.pt")
    edges = sub.edge_mask.sum(dim=1).cpu().numpy().astype(np.int64)
    stats = engine._assemble_stats(got["steps"], got["ms"][:got["steps"]].numpy().astype(np.int64),
                                   got["its"][:got["steps"]].numpy().astype(np.int64), edges)
    check(same_run(types.SimpleNamespace(values=got["val"][:, :-1].numpy(), stats=stats),
                   runs["cc"]), "the NCCL world of 2: CC differs from the fused run")
    wall = time.perf_counter() - t
    log(f"distributed: a NCCL world of 2 on two cards ran CC at full width == the fused run "
        f"({wall:.1f} s with the processes' start)")
    return dict(ran=True, cards=cards, stepper_s=got["wall_s"], with_start_s=wall)


def dist_child(work: Path) -> int:
    """One rank of dist_world2: the stepper on the input's arrays."""
    import datetime

    import torch.distributed as dist

    from repro_torch.graph import engine
    from repro_torch.launch.mesh import make_host_mesh

    rank = int(os.environ["RANK"])
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{work}/rendezvous", rank=rank,
                            world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=datetime.timedelta(seconds=300))
    try:
        job = torch.load(work / "input.pt")
        dev = torch.device("cuda", rank)
        arrays = {k: a.to(dev) for k, a in job["arrays"].items()}
        runner = engine.make_distributed_stepper(make_host_mesh(), "workers", "cc",
                                                 job["statics"], num_supersteps=200,
                                                 inner_cap=10_000)
        t = time.perf_counter()
        val, _, steps, ms, its = runner(arrays, job["init"])
        wall = time.perf_counter() - t
        if rank == 0:
            torch.save(dict(val=val, steps=steps, ms=ms, its=its, wall_s=wall),
                       work / "output.pt")
    finally:
        dist.destroy_process_group()
    return 0


# -------------------------------------- full width: kernels at their shapes


def measure_kernels(g, pipe, runs, launches, dev, batch_sources, serve_launches):
    """Each kernel against its plain version at the main path's shapes,
    timed beside its bound, the plain version and the library call; the
    superstep's min also in the serving path's batched launch."""
    from repro_torch.kernels import bsp_superstep as bsp, ebg_commit as ebg

    B = 256
    order = pipe.result.order.numpy()
    nblocks = -(-g.num_edges // B)
    # ebg_commit: blocks from the middle of the full-width stream.
    mid = nblocks // 2
    stream, state = commit_blocks(g, "ebv", False, dev, first=mid, count=4, order=order)
    sl = slice(mid * B, (mid + 1) * B)
    args = (*state, stream.u[sl], stream.v[sl], stream.valid[sl], stream.coef)
    ms = cuda_ms(lambda: ebg.ebg_commit_block(*args), reps=50)
    plain_ms = cuda_ms(lambda: ebg.ebg_commit_block_plain(*args), reps=2)
    keep = state[0]
    block_bytes = 2 * nbytes(keep, state[1], state[2]) + nbytes(*args[3:]) + B * 4
    # The whole stream, as the main path runs it: one launch per 8192 blocks.
    fresh = stream.new_state(PARTS, g.num_vertices)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    parts = ebg.ebg_commit_stream(*fresh, stream.u, stream.v, stream.valid, stream.coef,
                                  block=B)
    t1.record()
    t1.synchronize()
    stream_ms = t0.elapsed_time(t1)
    check(torch.equal(parts[:g.num_edges].cpu(), pipe.result.part.cpu()),
          "a second full partition differs from the first")
    keep = fresh[0]  # the bitset the full stream leaves
    E = g.num_edges
    check(torch.equal(keep, keep_bits_of(stream.u[:E], stream.v[:E], parts[:E], PARTS,
                                         g.num_vertices)),
          "the stream's bitset is not its partition's")
    transpose_entries = measure_transposes(keep, launches)
    memb_entry = measure_membership(keep, stream.u[:MEMB_EDGES], stream.v[:MEMB_EDGES],
                                    launches)
    entries = [dict(
        name="ebg_commit", route="cuda", source="src/repro_torch/kernels/csrc/ebg_commit.cu",
        replaces="src/repro/kernels/ebg_commit.py:124", launches=launches["ebg_commit"],
        max_abs_err=0.0,  # compare_commit demands bitwise equality
        ms=ms, plain_ms=plain_ms,
        bound_ms=1e3 * block_bytes / HBM_BYTES_PER_S, bound_by="bytes", library_ms=None,
        shape=f"one block: p={PARTS}, B={B}, bitset {tuple(keep.shape)}",
        stream_ms=stream_ms, stream_ms_per_block=stream_ms / nblocks,
        **measure_commit_wide(dev),
    )] + transpose_entries
    del stream, state, args, fresh, parts, keep
    segment_entries = []

    # bsp_superstep: the first superstep of CC (min) and PR (sum).
    for prog, sym in (("cc", True), ("pr", False)):
        sub = pipe.subgraphs_for(symmetrize=sym)
        (lsrc, ldst, w, deg), val, n, got, err = compare_superstep(sub, prog, g.num_vertices)
        combine = "sum" if deg is not None else "min"
        kw = dict(num_out=n, combine=combine, inner_cap=10_000, out_degree=deg)
        ms = cuda_ms(lambda: bsp.bsp_superstep(lsrc, ldst, w, val, **kw), reps=3)
        # The same launches without the wrapper's read of the id flag.
        flag = torch.zeros((1,), dtype=torch.int32, device=dev)
        kernel_ms = cuda_ms(lambda: bsp.launch_flagged(lsrc, ldst, w, val, err=flag, **kw), reps=3)
        plain_ms = cuda_ms(lambda: bsp.bsp_superstep_plain(lsrc, ldst, w, val, **kw), reps=1)
        p, E = lsrc.shape
        io_bytes = nbytes(lsrc, ldst, w, val, deg) + nbytes(got[0], got[1])
        idx = ldst.long()
        extra = {}
        if combine == "min":
            # Passes the data needs: each worker runs its changing passes and
            # one more that finds nothing to change.
            passes = int((got[1] + 1).clamp(max=10_000).sum())
            ops = 2.0 * passes * E
            # The frontier: edges that took part in each lock-step pass.
            taken = torch.zeros((10_000,), dtype=torch.int64, device=dev)
            bsp.launch_flagged(lsrc, ldst, w, val, err=flag, taken=taken, **kw)
            rounds = int(got[1].max()) + 1
            taken = taken[:rounds].tolist()
            extra = dict(pass_edges=taken, active_edge_share=[x / (p * E) for x in taken],
                         edges_taken_share=sum(taken) / (passes * E))
            data = torch.where(w < 3.0e38, torch.gather(val, 1, lsrc.long()) + w, 3.0e38)
            scratch = val.clone()
            library_ms = cuda_ms(lambda: scratch.scatter_reduce_(1, idx, data, "amin"), reps=5)
            library = "Tensor.scatter_reduce_(amin), one pass"
        else:
            passes = p
            ops = 3.0 * p * E
            share = torch.where(deg > 0, val / deg, 0.0)
            data = (torch.gather(share, 1, lsrc.long()) * w).reshape(-1)
            flat = (idx + torch.arange(p, device=dev)[:, None] * n).reshape(-1)
            scratch = torch.zeros(p * n, device=dev)
            library_ms = cuda_ms(lambda: scratch.index_add_(0, flat, data), reps=5)
            library = "Tensor.index_add_"
        bound = max(io_bytes / HBM_BYTES_PER_S, ops / F32_FLOPS)
        entries.append(dict(
            name=f"bsp_superstep.{combine}", route="cuda",
            source="src/repro_torch/kernels/csrc/bsp_superstep.cu",
            replaces="src/repro/kernels/bsp_superstep.py:182",
            launches=launches[f"bsp_superstep.{combine}"], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=1e3 * bound,
            bound_by="bytes" if io_bytes / HBM_BYTES_PER_S >= ops / F32_FLOPS else "operations",
            library_ms=library_ms, library=library, kernel_ms=kernel_ms,
            shape=f"{prog} first superstep: stream [{p}, {E}], values [{p}, {n}]",
            # The stream's bytes once per pass each worker ran: the bound of a
            # kernel that reads its edges from device memory on every pass.
            worker_passes=passes, stream_pass_bound_ms=1e3 * passes * 12.0 * E / HBM_BYTES_PER_S,
            **extra,
        ))
        check(int(flag) == 0, f"bsp_superstep {prog}: the id guard fired on the main path's stream")
        entries[-1]["serve_launches"] = serve_launches.get(f"bsp_superstep.{combine}", 0)
        if combine == "min":
            entries[-1].update(measure_superstep_batch(pipe, batch_sources, g.num_vertices, dev))
        del data, scratch, idx
        segment_entries.append(measure_segment(prog, lsrc[0], ldst[0], w[0],
                                               val[0] if deg is None else pr_share(val, deg)[0],
                                               n, launches))
        del lsrc, ldst, w, deg, val, got
        torch.cuda.empty_cache()
    entries += segment_entries
    entries.append(memb_entry)
    entries += [measure_attention(dev, launches, *case) for case in ATTN_CASES]
    entries.append(measure_attention(dev, launches, "decode_attention.kimi_k2.softcap0", 8, 0.0,
                                     KIMI_K2, "kimi_k2"))
    for e in entries:
        e["ms_over_bound"] = e["ms"] / e["bound_ms"]
        log(f"kernel {e['name']}: {e['ms']:.4f} ms (kernel alone {e.get('kernel_ms')}; plain "
            f"{e['plain_ms']:.3f} ms, bound {e['bound_ms']:.4f} ms by {e['bound_by']}, "
            f"x{e['ms_over_bound']:.2f}; library {e['library_ms']})")
    return entries


def measure_superstep_batch(pipe, sources, num_vertices, dev):
    """bsp_superstep's min as the serving path launches it: the first
    superstep of B BFS queries over the directed build in one launch of
    B·p value rows on the shared streams. Bitwise against the plain version
    and against each query's rows launched alone; timed beside the B single
    launches and its bound (the stream read once, B·p value rows in and
    out)."""
    from repro_torch.kernels import bsp_superstep as bsp

    sub = pipe.subgraphs_for(symmetrize=False)
    B = len(sources)
    (lsrc, ldst, w, _), val, n, got, rows = compare_superstep_batch(sub, "bfs", num_vertices,
                                                                    sources)
    p, E = lsrc.shape
    kw = dict(num_out=n, combine="min", inner_cap=10_000)
    flag = torch.zeros((1,), dtype=torch.int32, device=dev)
    batch_ms = cuda_ms(lambda: bsp.launch_flagged(lsrc, ldst, w, val, err=flag, **kw), reps=3)
    singles_ms = [cuda_ms(lambda v=v: bsp.launch_flagged(lsrc, ldst, w, v, err=flag, **kw),
                          reps=3) for v in rows]
    check(int(flag) == 0, "bsp_superstep batch: the id guard fired")
    passes = int((got[1] + 1).clamp(max=10_000).sum())
    io_bytes = nbytes(lsrc, ldst, w, val) + nbytes(*got)
    ops = 2.0 * passes * E
    bound = max(io_bytes / HBM_BYTES_PER_S, ops / F32_FLOPS)
    log(f"kernel bsp_superstep.min batch B={B}: {batch_ms:.3f} ms against {sum(singles_ms):.3f} "
        f"ms for the {B} single launches; bound {1e3 * bound:.4f} ms")
    return dict(batch_B=B, batch_ms=batch_ms, batch_singles_ms=sum(singles_ms),
                batch_single_ms=singles_ms, batch_bound_ms=1e3 * bound,
                batch_bound_by="bytes" if io_bytes / HBM_BYTES_PER_S >= ops / F32_FLOPS
                else "operations",
                batch_max_abs_err=0.0,  # bitwise, checked above
                batch_worker_passes=passes,
                batch_shape=f"bfs first superstep, {B} queries: stream [{p}, {E}], "
                            f"values [{B * p}, {n}]")


def measure_segment(prog, lsrc, ldst, w, val, n, launches):
    """segment_reduce on one worker's stream of the main path's run of `prog`."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_reduce as seg

    op = "sum" if prog == "pr" else "min"
    entry = getattr(ops, SEGMENT_ENTRIES[op])
    got, err = compare_segment(op, lsrc, ldst, w, val, n)
    ms = cuda_ms(lambda: entry(lsrc, ldst, w, val, num_out=n), reps=20)
    # The same launches without the wrapper's read of the id flag.
    kernel_ms = cuda_ms(lambda: seg.launch_unchecked(lsrc, ldst, w, val, n, op), reps=20)
    plain_ms = cuda_ms(lambda: seg.segment_reduce_plain(lsrc, ldst, w, val, n, op=op), reps=3)
    E = lsrc.shape[0]
    idx = ldst.long()
    gathered = val[lsrc.long()]
    if op == "min":
        data = torch.where(w < ops.INF, gathered + w, ops.INF)
        scratch = val[:n].clone()
        library_ms = cuda_ms(lambda: scratch.scatter_reduce_(0, idx, data, "amin"), reps=20)
        library = "Tensor.scatter_reduce_(amin)"
    else:
        data = torch.where(w != 0.0, gathered * w, 0.0)
        scratch = torch.zeros(n, device=val.device)
        library_ms = cuda_ms(lambda: scratch.index_add_(0, idx, data), reps=20)
        library = "Tensor.index_add_"
    io_bytes = nbytes(lsrc, ldst, w, val, got)
    n_ops = 2.0 * E  # an add (or multiply) and a min (or add) an edge
    bound = max(io_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS)
    return dict(
        name=f"segment_reduce.{op}", route="cuda",
        source="src/repro_torch/kernels/csrc/segment_reduce.cu",
        replaces="src/repro/kernels/segment_reduce.py:94",
        launches=launches.get(f"segment_reduce.{op}", 0), max_abs_err=err, ms=ms,
        kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=1e3 * bound,
        bound_by="bytes" if io_bytes / HBM_BYTES_PER_S >= n_ops / F32_FLOPS else "operations",
        library_ms=library_ms, library=library,
        shape=f"worker 0 of the {prog} stream: {E} edges, {val.shape[0]} values, num_out {n}",
    )


def measure_commit_wide(dev):
    """ebg_commit past the block-wide kernel's shared memory: p=2048 parts
    and blocks of 8192 edges of the smoke graph's ebv stream (the workspace
    path). Two blocks through the stream entry, then one, frozen and then
    window, bitwise against the plain version; the frozen block timed."""
    from repro_torch.graph.generate import rmat
    from repro_torch.kernels import ebg_commit as ebg

    parts, block = WIDE_COMMIT["parts"], WIDE_COMMIT["block"]
    g = rmat(**SMOKE)
    out = {}
    for window in (False, True):
        t = time.perf_counter()
        st, start = commit_blocks(g, "ebv", window, dev, first=2, count=1, block=block,
                                  parts=parts)
        sync()
        compare_s = time.perf_counter() - t
        if not window:
            sl = slice(2 * block, 3 * block)
            args = (*start, st.u[sl], st.v[sl], st.valid[sl], st.coef)
            out["wide_block_ms"] = cuda_ms(lambda: ebg.ebg_commit_block(*args), reps=3)
            out["wide_plain_ms"] = cuda_ms(lambda: ebg.ebg_commit_block_plain(*args), reps=1,
                                           warmup=0)
        out[f"wide_check_s_{'window' if window else 'frozen'}"] = compare_s
    words = -(-g.num_vertices // 32)
    out["wide_shape"] = (f"one block: p={parts}, B={block}, bitset {(parts, words)}, "
                         f"the smoke graph's ebv stream from block 2")
    log(f"full: ebg_commit at p={parts}, block {block} == plain (frozen, window); "
        f"{out['wide_block_ms']:.2f} ms a block")
    return out


def measure_transposes(keep, launches):
    """The commit's two bitset transposes on the full partition's bitset."""
    from repro_torch.kernels import ebg_commit as ebg

    memb = compare_transposes(keep.device, keep)
    p = keep.shape[0]
    entries = []
    for name, fn, plain, src, dst in (
        ("ebg_commit.keep_to_memb", lambda: ebg.keep_bits_to_memb(keep),
         lambda: ebg.keep_bits_to_memb_plain(keep), keep, memb),
        ("ebg_commit.memb_to_keep", lambda: ebg.memb_to_keep_bits(memb, p),
         lambda: ebg.memb_to_keep_bits_plain(memb, p), memb, keep),
    ):
        io_bytes = nbytes(src, dst)
        n_ops = 2.0 * 32 * src.numel()  # a bit test and a ballot a bit of each word
        bound = max(io_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS)
        entries.append(dict(
            name=name, route="cuda", source="src/repro_torch/kernels/csrc/ebg_commit.cu",
            replaces="src/repro/kernels/ebg_commit.py:124", launches=launches.get(name, 0),
            max_abs_err=0.0,  # compare_transposes demands bitwise equality
            ms=cuda_ms(fn, reps=20), plain_ms=cuda_ms(plain, reps=2), bound_ms=1e3 * bound,
            bound_by="bytes" if io_bytes / HBM_BYTES_PER_S >= n_ops / F32_FLOPS else "operations",
            library_ms=None, library=None,
            shape=f"keep {tuple(keep.shape)} <-> memb {tuple(memb.shape)} int32",
        ))
    return entries


def measure_membership(keep, u, v, launches):
    """ebg_membership over the full partition's bitset and a stream slice:
    the wrapper's call (transpose, main kernel, the wait for the id flag),
    the main kernel alone and the transpose alone."""
    from repro_torch.kernels import ebg_score, ops

    got = compare_membership(keep, u, v)
    ms = cuda_ms(lambda: ops.ebg_membership(keep, u, v), reps=10)
    memb = ebg_score.keep_to_memb(keep)
    p = keep.shape[0]
    kernel_ms = cuda_ms(lambda: ebg_score.launch_main(memb, u, v, p), reps=10)
    transpose_ms = cuda_ms(lambda: ebg_score.keep_to_memb(keep), reps=20)
    _, err = ebg_score.launch_main(memb, u, v, p)
    check(int(err) == 0, "ebg_membership: the id guard fired on the stream's ids")
    plain_ms = cuda_ms(lambda: ebg_score.ebg_membership_plain(keep, u, v), reps=2)
    io_bytes = nbytes(keep, u, v, got)
    n_ops = 3.0 * got.numel()  # two bit tests and an add an output
    bound = max(io_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS)
    del memb
    return dict(
        name="ebg_membership", route="cuda",
        source="src/repro_torch/kernels/csrc/ebg_membership.cu",
        replaces="src/repro/kernels/ebg_score.py:35",
        launches=launches.get("ebg_membership", 0), max_abs_err=0.0,  # bitwise, checked
        ms=ms, plain_ms=plain_ms, bound_ms=1e3 * bound,
        bound_by="bytes" if io_bytes / HBM_BYTES_PER_S >= n_ops / F32_FLOPS else "operations",
        library_ms=None, library=None, kernel_ms=kernel_ms, transpose_ms=transpose_ms,
        shape=f"bitset {tuple(keep.shape)}, {u.shape[0]} edges -> {tuple(got.shape)} f32",
    )


def measure_attention(dev, launches, name, B, softcap, c=GEMMA2_27B, config="gemma2_27b"):
    """decode_attention at a config's attention widths (gemma2_27b's by
    default), bf16, batch B. At softcap 0, SDPA computes the same function
    and is timed beside it."""
    from repro_torch.kernels import decode_attn, ops

    Hq, Hkv, D, S = c["Hq"], c["Hkv"], c["D"], c["S"]
    q, k, v = attention_inputs(B, Hq, Hkv, D, S, torch.bfloat16, dev, seed=27)
    got, reading = compare_attention(q, k, v, softcap)
    ms = cuda_ms(lambda: ops.decode_attention(q, k, v, softcap=softcap), reps=20)
    plain_ms = cuda_ms(lambda: decode_attn.decode_attention_plain(q, k, v, softcap=softcap),
                       reps=2)
    library_ms = library = None
    if not softcap:
        q4, k4, v4 = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = cuda_ms(lambda: sdpa(q4, k4, v4, enable_gqa=True), reps=20)
        library = "F.scaled_dot_product_attention(enable_gqa=True)"
        del q4, k4, v4
    io_bytes = nbytes(q, k, v, got)
    n_ops = 4.0 * B * Hq * S * D  # q.k and p.v, a multiply and an add each
    bound = max(io_bytes / HBM_BYTES_PER_S, n_ops / BF16_FLOPS)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nsplit = decode_attn.split_count(B, S, Hkv, Hq // Hkv, sms,
                                     decode_attn.tile_keys(D, torch.bfloat16))
    del q, k, v, got
    torch.cuda.empty_cache()
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attn.cu",
        replaces="src/repro/kernels/decode_attn.py:61",
        launches=launches.get("decode_attention", 0), max_abs_err=reading["max_abs_err"], ms=ms,
        plain_ms=plain_ms, bound_ms=1e3 * bound,
        bound_by="bytes" if io_bytes / HBM_BYTES_PER_S >= n_ops / BF16_FLOPS else "operations",
        library_ms=library_ms, library=library,
        limit=f"rtol {ATTN_TOL[torch.bfloat16][0]}, atol {ATTN_TOL[torch.bfloat16][1]}",
        over_limit=reading["over_limit"], control_over_limit=reading["control_over_limit"],
        shape=f"{config} attention: B={B}, Hq={Hq}, Hkv={Hkv}, D={D}, S={S}, bf16, "
              f"softcap {softcap}, {nsplit} splits",
    )


# -------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full-log2-edges", type=int, default=26,
                    help="log2 of the full-width edge count (V stays 2^22)")
    ap.add_argument("--dist-child", type=Path, default=None,
                    help=argparse.SUPPRESS)  # one rank of the distributed phase's world of 2
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside the repository)

    if args.dist_child is not None:
        return dist_child(args.dist_child)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    build_s = phase_build()
    smoke_errs = phase_kernels(dev)
    pinned_s, pinned_drivers = phase_pinned(dev)
    t = time.perf_counter()
    baselines = phase_baselines(dev)
    baselines_s = time.perf_counter() - t
    summary, kernels = phase_full(dev, args.full_log2_edges)
    total = time.perf_counter() - t0
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(dict(
        card=smi, build_s=build_s, smoke_kernel_errors=smoke_errs, pinned_s=pinned_s,
        pinned_drivers=pinned_drivers,
        baselines=baselines, baselines_s=baselines_s, full=summary, kernels=kernels,
        total_s=total,
    ), indent=1))
    log(f"all phases passed in {total:.1f} s")

    print(smi)
    serve = summary["serve"]
    print(json.dumps({"serve": {k: serve[k] for k in (
        "queries", "wall_s", "throughput_qps", "latency_p50_s", "latency_p99_s", "batches",
        "mean_batch", "padding_waste", "supersteps_mean", "cache", "resilience", "capture_s")}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
