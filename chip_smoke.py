#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--full-log2-edges 26] [--lm-only]

Phases; a failed check raises and the script exits non-zero:

  0. analysis the static analyzer (repro_torch.analysis) over src/repro_torch
              with the committed baseline (analysis_baseline_torch.json,
              empty): no finding. KP01's parsed C entries and HS01's
              captured roots are kept; after the last phase every C entry
              the run loaded (dispatch._FUNCTIONS) must be one KP01
              checked, with the argtypes (count and types) KP01 held
              against csrc, and `_FusedLoop._chunk` must be a captured
              root that the run did capture (engine.CAPTURES["graphs"] >
              0; not under --lm-only, which runs no engine). Runs under
              --lm-only too. One {"analysis": ...} stdout line.
  1. build    compile the CUDA kernels of src/repro_torch/kernels/csrc with
              nvcc (one process per source, all at once) into build/kernels/.
  2. kernels  hold each kernel against its plain PyTorch version on the card,
              on the smoke graph's real state: ebg_commit over a range of
              blocks for ebv (frozen and window), hdrf and greedy, block by
              block and as one stream launch, and at p=64 (two chain
              warps) — bitwise; its two bitset transposes (bitwise);
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
  4b. commit_tiled
              ebg_commit past one patched tile and past one chain warp, on
              twitter_like (p=32 unless named; launch counts zeroed just
              before each timed stream and read just after: one launch a
              stream): window mode at blocks 48, 256 and 4,096 over the
              whole stream (patched tiles of 48 edges, and of 64 that cut
              the blocks), equal bitwise (parts, bitset, counters: any
              window block is the scan); HDRF's stream at block 2,048 (weighted,
              range: deferred tiles of 1,024); ebv at p = 64 and p = 256,
              block 4,096 (2 and 8 chain warps, deferred tiles). Each of
              the last three is held against the plain version on 2 blocks
              from the middle of its stream (from the state the kernel
              reaches there); each stream is timed whole (CUDA events)
              beside its bytes bound, into ebg_commit's kernels entry
              ("tiled"). It runs after the training phase, in the
              full-width graph's generation wait.
  5. full     the full-width path: R-MAT with LiveJournal's scale and skew
              (2^22 vertices, 2^26 edges; generated on the host in a thread
              that main starts after phase 0, beside phases 1-4), p=32,
              ebg_chunked (then the metrics and the directed build in
              threads beside the symmetric build), then CC, REACH,
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
              order, partition_store (ebv, block 256) with its state on
              the card, against the main path's in-memory ebg_chunked
              partition (block 256): the order and the assignments in
              stream and input order, bitwise; the edge counters equal to
              partition_metrics' edges per part, every vertex counter at
              least its |V_i|; edges/s and the counters' RF beside
              partition_metrics'. On twitter_like partition_store at its
              default block (4,096: deferred tiles of 1,024) against
              the in-memory stream at that block (order, assignments,
              counters, bitwise; the commit stream timed), then the
              streamed build of edge_part_stream against build_subgraphs
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
              transpose's (transpose_ms) beside the whole call; the two
              bitset transposes' entries their bare launches (kernel_ms)
              and, bitwise, the sharded out-of-core path's keep [32, 16]
              (sharded_ms, sharded_kernel_ms). Last, hash,
              DBH and CVC partition the full-width graph on the card,
              bitwise against a numpy splitmix64 written here, with their
              edges per second and metrics.
  5b. graph_dryrun
              the graph engine's production dry-run (after the distributed
              phase has destroyed its NCCL group): run_graph_dryrun at p =
              256 (16 x 16) and p = 512 (2 x 16 x 16), each inside a fake
              world of that many ranks in this process (rank 0; its
              collectives counted under record_collectives, none run),
              CC on a synthetic Friendster-scale shard on the card (8 M
              edges and 1 M vertices a rank, 2,048-slot message tables,
              labels below 2^24), launch counts zeroed just before each
              run and read just after. Checked: the recorded collectives
              equal the plan's (count and bytes, kind by kind); the bytes
              of the rank's tensors on the card equal the plan's arg_bytes;
              bsp_superstep.min launched; the first superstep (a second
              lowering, one superstep) bitwise equal to the same superstep
              with the min kernel's plain version on the card (the fake
              exchange is deterministic). The min kernel is then held
              against its plain version on that shard's first local stage
              and timed a pass beside its bound. One {"graph_dryrun": ...}
              stdout line with both records.
  5c. lm_dryrun
              the LM half of the dry-run (repro_torch.launch.dryrun). Its
              fake cells run in a process of their own (this script's
              --lm-dryrun-child), started after the build and run beside
              phases 2-5: lower_cell on the card's device type, rank 0 of a
              fake world of 256 (16 x 16) under FakeTensorMode, full width:
              llama3_2_3b x train_4k, prefill_32k and decode_32k, and
              train_4k at p = 512 (2 x 16 x 16); phi3_5_moe x train_4k under
              plan ep; mamba2_780m x long_500k. Each gives its record
              (per-device FLOPs, bytes, collectives, arg/temp/output bytes,
              roofline terms); a cell with no record (a .FAIL) fails
              the phase. Then, in this
              process, one real run: rank 0 of p = 256 for llama3_2_3b x
              decode_32k, its shards (bf16 weights, caches and tokens drawn
              from seed 0) on the card in a fake world, 8 decode steps from
              cache position 32,760, launch counts zeroed just before and
              read just after: decode_attention exactly 28 x 8 times; its
              first call (on the keys DTensor gathered) within ATTN_TOL of
              the plain version on the same inputs; the rank's bytes on the
              card equal to the fake decode cell's arg_bytes; the logits
              finite; torch.cuda.max_memory_allocated beside the fake
              temp_bytes. One {"lm_dryrun": ...} stdout line.
  6. lm       the LM serving path at full width: llama3_2_3b at its
              published widths (28 layers, d_model 3,072, 24 query heads
              over 8 KV heads), ~3.2 B bf16 parameters drawn on the card
              from a seeded generator, 8 prompts of 1,024 tokens from
              np.random.default_rng(0), 64 greedy tokens through
              repro_torch.launch.serve.generate (KV caches of 1,088 keys).
              The launch counts are zeroed just before the generate call
              and read just after: decode_attention must launch exactly 28
              x 64 times. The same call with the decode attention on its
              plain version (the test hook layers.plain_decode_attention)
              must give logits within LM_LOGIT_ATOL (bf16) and the same
              tokens at every step whose top-2 margin is above it, until a
              row's first near tie; the plain decode fed the kernel run's
              tokens, and one full forward of prompts and tokens, must
              give every step's logits within LM_LOGIT_ATOL (a control,
              another row's logits, must fail it). `python -m
              repro_torch.launch.serve --preset tiny` runs on the card in a
              process of its own (f32 parameters over bf16 caches). Then
              decode_attention on layer 0's live cache (keys [0, 1,088)),
              with a bf16 and an f32 query, against its plain version and
              timed beside its bound and SDPA. One {"lm_serve": ...}
              stdout line.
  7. lm_families
              the other LM families at their published widths, seeded random
              bf16 weights drawn on the card, B = 8, 32 greedy tokens; the
              launch counts zeroed just before each kernel run and read just
              after. phi3_5_moe (16 of its 32 layers: all 32 pass the card's
              memory; 16 experts top-2, prompts of 1,024) through generate:
              decode_attention exactly 16 x 32 times, 0 in the plain run;
              every step's logits against the plain attention fed the same
              tokens, and the same steps on a copy with capacity_factor 16
              (nothing drops) against its full forward, each within
              LM_FAMILY_ATOL with a control that fails it, over the (row,
              step) pairs whose experts the two runs chose alike in every
              layer (RouteSpy; a pair where a bf16 near-tie in the router
              chose another expert is counted, not compared); the EBV
              placement (core/placement.py) of layer 0's routing of the
              prefill's 8,192 tokens over 4 devices beside a seeded random
              one, with placement_report for both, and one decode step with
              that expert_perm and the expert weights moved to their slots,
              equal to the unpermuted step bit for bit. mamba2_780m whole
              (48 SSM layers, prompts of 1,024): no kernel launch, every
              decode step against the full forward. seamless_m4t_large_v2
              whole (24 + 24 layers) over 1,024 seeded random encoder frames,
              decoder prompts of 16: the serve steps take the encoder's
              output computed once; decode_attention exactly 24 x 32 x 2
              times (self- and cross-attention, G = 1); every step against
              the plain attention and against the full forward. Each
              model's prefill s, decode ms a token (p50, p99), tokens/s and
              peak memory. decode_attention's kernels entries at phi3's
              step, seamless's self- and cross-attention, and the D = 512
              build (no config path), each held at the whole range and at
              key ranges with NaN outside, timed beside its bound and SDPA;
              and head_dim 1,024 on the wide source (decode_attn_wide.cu:
              B 2, Hq 8 over 2, 2,048 keys; bf16 and f32 q, softcap 0 and
              50), against the plain version, timed (the wrapper and the
              bare launch) beside its bound and SDPA (softcap 0). One
              {"lm_families": ...} stdout line.
  8. lm_train the LM training path: llama3_2_3b at its published widths
              (3.21 B f32 parameters drawn on the card from seed 0) for 6
              steps and mamba2_780m whole for 4, each on one repeated batch
              of B 2 x 1,024 tokens from the ported pipeline
              (repro_torch.data.pipeline), AdamW lr 3e-4, remat; the launch
              counts zeroed just before and read just after: no kernel
              launches (the training path runs no TPU-kernel counterpart);
              every loss and grad norm finite, the last loss below the
              first; ms a step (CUDA events), tokens/s, TFLOP/s against the
              f32 peak, peak memory. Then each of the ten configs at
              reduced_config: one train step on the card against the same
              step on the CPU (loss and grad norm within their limits).
              Then the launcher (repro_torch.launch.train, preset small) in
              deterministic mode, in a process of its own that alone sets
              CUBLAS_WORKSPACE_CONFIG: 6 steps checkpointed at 3 and 6, and
              a run resumed from the step-3 checkpoint alone, equal bit for
              bit (losses, parameters, optimizer state). One {"lm_train":
              ...} stdout line. It runs after the baselines phase, while the
              full-width graph's generation ends (it needs no graph), and
              last under `--lm-only`, which runs the analysis, the build,
              phase 5c and phases 6-8 alone.

Prints the card's name and power limit, the {"analysis": ...}, {"serve": ...},
{"graph_dryrun": ...}, {"lm_serve": ...},
{"lm_families": ...}, {"lm_train": ...} and {"kernels": [...]} lines, and last
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
It needs the repository around it and a CUDA card; without either it fails.
"""
from __future__ import annotations

import argparse
import atexit
import json
import os
import shutil
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
SHARDED_BITSET = (PARTS, 16)  # keep words of a block of 256 on the sharded out-of-core path
WIDE_COMMIT = dict(parts=2048, block=8192)  # past 1,024 parts: the WIDE kernel
# ebg_commit past one patched tile and one chain warp, on twitter_like: window
# blocks compared, HDRF's block, the parts and block of the multi-warp streams.
TILED_COMMIT = dict(window_blocks=(48, 256, 4096), hdrf_block=2048, parts=(64, 256),
                    parts_block=4096)

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
# The out-of-core pipeline: shards of 2^20 edges; at full width blocks of
# 256 (the main path's ebg_chunked block, which it is held against), on
# twitter_like blocks of 4,096 (partition_store's default: the commit
# kernel's deferred tiles), held against the in-memory stream at that block.
OUT_OF_CORE = dict(shard_edges=1 << 20, block=256, tw_block=4096)
# The sharded out-of-core layout's block on twitter_like (one launch and
# one all_gather a block).
DIST_SHARDED_BLOCK = 256
# The graph engine's dry-run (phase 5b): CC at the reference's dry-run knobs
# (launch/graph_dryrun.py: 4 supersteps, 64 inner passes) on the synthetic
# shard of seed 0, at p = 256 and p = 512.
GRAPH_DRYRUN = dict(program="cc", num_supersteps=4, inner_cap=64, seed=0)
# The LM serving phase: llama3_2_3b at its published widths (src/repro_torch/
# configs/llama3_2_3b.py), bf16 parameters drawn on the card from seed 0,
# B = 8 prompts of 1,024 tokens from np.random.default_rng(0) as the serving
# driver draws them, 64 greedy tokens, caches of 1,088 keys.
LM = dict(config="llama3_2_3b", batch=8, prompt_len=1024, new_tokens=64, seed=0)
# bf16 logits: a |logit| below 8 is a bf16 number 2^-5 from its neighbours;
# the kernel run, the plain run and the full forward may land up to four such
# steps apart (another order of f32 sums, then bf16 roundings through 28
# layers). Every comparison also holds a control, the same logits against
# another row's, which must fail the limit.
LM_LOGIT_ATOL = 0.125
# The other LM families (phase 7): B = 8, 32 greedy tokens, seeded random
# bf16 weights drawn on the card. phi3_5_moe (src/repro_torch/configs/
# phi3_5_moe.py, Microsoft's published Phi-3.5-MoE config) at its published
# widths with its depth cut from 32 to 16 layers (all 32 are ~84 GB in bf16,
# past the card's 80 GB), prompts of 1,024 tokens, its EBV placement over 4
# devices; the capacity_factor of the copy held against the full forward
# (16 = E: cap = T·k, nothing drops). mamba2_780m whole, prompts of 1,024
# (chunk 256; the full forward's 1,056 takes chunk 176). seamless_m4t_
# large_v2 whole (24 + 24 layers), 1,024 encoder frames, decoder prompts of
# 16 tokens.
LM_FAMILIES = dict(batch=8, new_tokens=32, seed=0)
PHI3 = dict(config="phi3_5_moe", n_layers=16, prompt_len=1024, nodrop_capacity_factor=16.0,
            devices=4)
MAMBA2 = dict(config="mamba2_780m", prompt_len=1024)
SEAMLESS = dict(config="seamless_m4t_large_v2", prompt_len=16, enc_frames=1024)
# Each model's bf16 logit limit; a control, the same logits against another
# row's, must fail it. phi3 and seamless: LM_LOGIT_ATOL's four bf16 steps
# at |logit| < 8. mamba2: 16 such steps. Its 48 layers round their outputs
# to bf16 one after another and a rounding moves the SSM state of every
# later position: decode and the full forward (another chunk, another order
# of f32 sums) came 0.246 apart on an H100 80GB HBM3 at 700 W. The
# algorithm itself is held in f32 (MAMBA2_F32_ATOL, the reference's
# decode ≡ forward tolerance).
LM_FAMILY_ATOL = {"phi3_5_moe": 0.125, "mamba2_780m": 0.5, "seamless_m4t_large_v2": 0.125}
MAMBA2_F32_ATOL = 2e-3
# decode_attention's D = 512 build: (B, Hq, Hkv, D, S) of a GQA decode step.
WIDE_ATTN = dict(B=8, Hq=32, Hkv=8, D=512, S=4096)
# Past 512: the wide source (decode_attn_wide.cu).
WIDEST_ATTN = dict(B=2, Hq=8, Hkv=2, D=1024, S=2048)
# The LM training phase (phase 8): f32 parameters drawn on the card from
# seed 0, as the training launcher initialises them; B = 2 sequences of
# 1,024 tokens from the ported pipeline, one batch repeated every step so
# that a falling loss shows the gradients flow; AdamW at lr 3e-4, warmup 1,
# cosine over the run; remat (one checkpoint segment a layer group).
# llama3_2_3b at its published widths (3.21 B parameters: with grads and
# two f32 states 51.4 GB) for 6 steps, mamba2_780m whole for 4.
LM_TRAIN = dict(batch=2, seq=1024, lr=3e-4, seed=0)
LM_TRAIN_MODELS = (("llama3_2_3b", 6), ("mamba2_780m", 4))
# The ten reduced configs, one train step on the card against the same step
# on the CPU (the same f32 weights and batch; no TF32): the loss within
# 1e-4 and the grad norm within 1e-4 of itself, the sums in another order.
# A MoE config takes the first data seed whose router top-k margins exceed
# 1e-3 on the CPU, so that no near tie picks another expert on the card.
# The LM dry-run's fake cells: (arch, shape, multi_pod, plan).
LM_DRYRUN_CELLS = (
    ("llama3_2_3b", "train_4k", False, "baseline"),
    ("llama3_2_3b", "prefill_32k", False, "baseline"),
    ("llama3_2_3b", "decode_32k", False, "baseline"),
    ("llama3_2_3b", "train_4k", True, "baseline"),
    ("phi3_5_moe", "train_4k", False, "ep"),
    ("mamba2_780m", "long_500k", False, "baseline"),
)
# Its real run: rank 0 of p = 256 on the card.
LM_DRYRUN_REAL = dict(arch="llama3_2_3b", shape="decode_32k", steps=8, seed=0)
LM_DRYRUN_CHILD_TIMEOUT = 900
TRAIN_CARD_LOSS_ATOL = 1e-4
TRAIN_CARD_NORM_RTOL = 1e-4
TRAIN_ROUTE_MARGIN = 1e-3
TRAIN_REDUCED = dict(batch=2, seq=32, enc_len=12)
# Resume, bit for bit: the launcher at preset small, checkpoints every 3 of 6
# steps, once through and once resumed from its step-3 checkpoint alone, in
# deterministic mode, which needs a fixed cuBLAS workspace set before cuBLAS
# starts. It runs in a process of its own (this script's --resume-child
# mode): with the setting in this process every LM decode step took 10-20 ms
# longer (an H100 80GB HBM3 at 700 W).
TRAIN_RESUME = ["--preset", "small", "--steps", "6", "--ckpt-every", "3", "--batch", "8",
                "--seq", "128", "--log-every", "100"]
RESUME_CUBLAS = ":4096:8"


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

CAPTURED_ROOT = "repro_torch.graph.engine._FusedLoop._chunk"


def phase_analysis(smi):
    """Phase 0: the static gate over the port's source, with the committed
    baseline; returns its record and KP01's bindings {(lib, symbol): argtypes}
    for `check_analysis_after`."""
    from repro_torch.analysis import all_checkers, apply_baseline, load_baseline
    from repro_torch.analysis.checkers.host_sync import captured_roots
    from repro_torch.analysis.checkers.kernel_parity import c_bindings
    from repro_torch.analysis.core import collect_files, load_modules, load_resources, run_checkers

    t = time.perf_counter()
    files = collect_files([ROOT / "src" / "repro_torch"], root=ROOT)
    modules = load_modules(files, rel_root=ROOT)
    resources = load_resources(files, rel_root=ROOT)
    findings = apply_baseline(run_checkers(modules, None, resources),
                              load_baseline(ROOT / "analysis_baseline_torch.json"))
    check(not findings, "analysis: findings in src/repro_torch:\n"
          + "\n".join(f.render() for f in findings))
    bindings = {}
    for b in c_bindings(modules, resources):
        check(b.c_arity == len(b.argtypes), f"analysis: {b.lib}.{b.symbol} unchecked")
        bindings[b.lib, b.symbol] = b.argtypes
    roots = captured_roots(modules)
    check(CAPTURED_ROOT in roots, f"analysis: {CAPTURED_ROOT} is not a captured root: {roots}")
    out = dict(files=len(files), findings=len(findings),
               checkers=[c.code for c in all_checkers()], c_entries_checked=len(bindings),
               captured_roots=roots, phase_s=time.perf_counter() - t, card=smi)
    log(f"analysis: {out['files']} files, 0 findings, {len(bindings)} C entries checked, "
        f"in {out['phase_s']:.2f} s")
    return out, bindings


def check_analysis_after(analysis, bindings, captured: bool):
    """After the last phase: every C entry the run loaded was checked by
    KP01 with the argtypes it was loaded with; with `captured`, the run
    captured the fused loop's chunk (HS01's root) into a CUDA graph."""
    import ctypes

    from repro_torch.graph import engine
    from repro_torch.kernels import dispatch

    for (lib, symbol), fn in sorted(dispatch._FUNCTIONS.items()):
        check((lib, symbol) in bindings, f"analysis: {lib}.{symbol} was loaded, not checked")
        want = tuple(getattr(ctypes, name) for name in bindings[lib, symbol])
        check(len(fn.argtypes) == len(want) and tuple(fn.argtypes) == want,
              f"analysis: {lib}.{symbol} loaded with {fn.argtypes}, KP01 checked {want}")
    analysis["c_entries_loaded"] = len(dispatch._FUNCTIONS)
    analysis["graphs_captured"] = engine.CAPTURES["graphs"]
    if captured:
        check(engine.CAPTURES["graphs"] > 0, "analysis: the run captured no CUDA graph")


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
    for scorer, window in (("ebv", False), ("hdrf", True)):  # p > 32: two chain warps
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


def timed(fn, *a, **kw):
    """(fn(*a, **kw), its wall in s): a stage run in a worker thread."""
    t = time.perf_counter()
    out = fn(*a, **kw)
    return out, time.perf_counter() - t


def phase_commit_tiled(dev):
    """ebg_commit past one patched tile and one chain warp on twitter_like
    (see the module's phase 4b). Returns the record, with its kernels
    entries."""
    from repro_torch.core.streaming import prepare_stream
    from repro_torch.graph.generate import make_graph
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import ebg_commit as ebg

    t0 = time.perf_counter()
    tw = make_graph("twitter_like")
    V, E = tw.num_vertices, tw.num_edges
    entries = []

    def timed_stream(st, parts, window, label):
        """The whole stream in one launch from a fresh state, timed; its
        (parts, keep_bits, e_count, v_count) and its entry."""
        state = st.new_state(parts, V)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        sync()
        dispatch.reset_launches()
        a.record()
        got = ebg.ebg_commit_stream(*state, st.u, st.v, st.valid, st.coef, block=st.block,
                                    balance=st.balance, window=window, wu=st.wu, wv=st.wv)
        b.record()
        b.synchronize()
        launches = dispatch.LAUNCHES.get("ebg_commit", 0)
        check(launches == 1, f"commit_tiled {label}: {launches} ebg_commit launches, not 1")
        ms = a.elapsed_time(b)
        nblocks = st.u.shape[0] // st.block
        io = nbytes(st.u, st.v, st.valid, got, *state) + nbytes(*state)
        if st.wu is not None:
            io += nbytes(st.wu, st.wv)
        entry = dict(shape=f"twitter_like {label}: p={parts}, block {st.block}, {nblocks} blocks",
                     launches=launches, ms=ms, us_per_block=1e3 * ms / nblocks,
                     bound_ms=1e3 * io / HBM_BYTES_PER_S, bound_by="bytes")
        entries.append(entry)
        log(f"commit_tiled: {entry['shape']}: {ms:.2f} ms, {entry['us_per_block']:.2f} µs a block")
        return [got[:E], *state]

    # Window mode: any block size is the scan.
    runs = [timed_stream(prepare_stream(tw, PARTS, "ebv", block=b, device=dev), PARTS, True,
                         "ebv window") for b in TILED_COMMIT["window_blocks"]]
    for name, *xs in zip(("parts", "keep_bits", "e_count", "v_count"), *runs):
        check(all(torch.equal(xs[0], x) for x in xs[1:]),
              f"commit_tiled: window {name} differs between blocks {TILED_COMMIT['window_blocks']}")
    del runs
    # HDRF at block 2,048, and ebv at p = 64 and 256: 2 blocks from the middle
    # of each stream against the plain version, then the whole stream timed.
    checks = [("hdrf", PARTS, TILED_COMMIT["hdrf_block"])] + [
        ("ebv", p, TILED_COMMIT["parts_block"]) for p in TILED_COMMIT["parts"]]
    for scorer, parts, block in checks:
        nblocks = -(-E // block)
        st, _ = commit_blocks(tw, scorer, False, dev, first=nblocks // 2, count=2, block=block,
                              parts=parts)
        timed_stream(st, parts, False, f"{scorer} frozen")
        del st
    log("commit_tiled: window blocks "
        f"{TILED_COMMIT['window_blocks']} equal (parts, bitset, counters); hdrf at block "
        f"{TILED_COMMIT['hdrf_block']} and ebv at p={TILED_COMMIT['parts']} == plain on 2 blocks")
    return dict(entries=entries, phase_s=time.perf_counter() - t0)


def phase_full(dev, graph):
    """`graph`: the future of the full-width R-MAT graph and its wall (main
    starts it in a thread after the analysis phase)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.api.pipeline import GraphPipeline
    from repro_torch.kernels import dispatch

    st = Stages()
    t = time.perf_counter()
    g, st.s["generate"] = graph.result()
    st.s["generate_wait"] = time.perf_counter() - t
    V = g.num_vertices
    log(f"full: {V} vertices, {g.num_edges} edges, p={PARTS} (generated in "
        f"{st.s['generate']:.1f} s, waited {st.s['generate_wait']:.1f} s)")

    # ---- the main path, with the launch counts zeroed just before it.
    dispatch.reset_launches()
    pipe = GraphPipeline(g, device=dev).partition("ebg_chunked", parts=PARTS)
    st("partition", lambda: pipe.result)
    # The metrics and the two builds are host numpy, which leaves the GIL
    # for most of its time: the metrics and the directed build run in
    # threads beside the symmetric build (each wall its own).
    t = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        metrics = pool.submit(timed, lambda: pipe.metrics)
        directed = pool.submit(timed, pipe.subgraphs_for, symmetrize=False)
        st("build_symmetric", pipe.subgraphs_for, symmetrize=True)
        m, st.s["metrics"] = metrics.result()
        _, st.s["build_directed"] = directed.result()
    st.s["builds_and_metrics"] = time.perf_counter() - t
    runs = {}
    for prog in ("cc", "reach"):
        runs[prog] = st(f"run_{prog}", pipe.run, prog)
    pipe.subgraphs_for(symmetrize=True)  # cached
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
    outofcore = phase_outofcore(g, pipe, m, dev)
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
        outofcore_block=OUT_OF_CORE["tw_block"], outofcore_edges=outofcore["build"]["edges"],
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


def phase_outofcore(g, pipe, m, dev):
    """The out-of-core pipeline at full width: the graph written to a shard
    store on local disk, its degrees and the external degree-sum order,
    then partition_store (ebv, p=32, block 256) with its state on the card,
    launch counts zeroed just before and read just after. Against the main
    path's in-memory ebg_chunked partition of the same graph (p = 32, block
    256: `pipe`, and its partition_metrics `m`): the order, the assignments
    in stream and input order, bitwise; the edge counters equal to
    partition_metrics' edges per part, bit for bit, and every vertex counter
    at least its |V_i|. Then, on twitter_like (the full-width build would
    pass the time limit), partition_store at its default block (4,096: the
    commit kernel's deferred tiles) against the in-memory stream at that
    block, and the
    streamed build from edge_part_stream against build_subgraphs on the
    same partition (every field), and CC on both. The store and the order's
    buckets go to a temporary directory, removed at the end."""
    from repro_torch.core import outofcore as oc
    from repro_torch.data import edgeshards as es
    from repro_torch.kernels import dispatch

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
    E = g.num_edges
    mem = pipe.result  # the main path's ebg_chunked partition (block 256)
    order = mem.order.numpy()
    check(np.array_equal(res.result.order.numpy(), order),
          "degree_sum_stream's permutation differs from the main path's degree-sum order")
    check(torch.equal(res.result.part, mem.part),
          "the out-of-core assignments differ (stream order)")
    check(np.array_equal(res.result.part_in_input_order(), mem.part_in_input_order()),
          "the out-of-core assignments differ (input order)")
    check(np.array_equal(res.e_count, m.edges_per_part.astype(np.float32)),
          "the edge counters differ from partition_metrics'")
    check(bool((res.v_count >= m.vertices_per_part).all()),
          "a vertex counter is below partition_metrics' |V_i|")
    part_s = st.s["oc_partition"]
    log(f"outofcore: partition_store == the main path's ebg_chunked (order, parts); edge "
        f"counters == partition_metrics'; {launches.get('ebg_commit', 0)} ebg_commit launches, "
        f"{E / part_s:.4g} edges/s ({E / (part_s + st.s['oc_order']):.4g} with the order); RF "
        f"counters {res.replication_factor:.6f}, partition_metrics {m.replication_factor:.6f}")
    row = dict(edges=E, blocks=res.num_blocks, block=block, disk_bytes=disk, stage_s=dict(st.s),
               launches=launches, partition_launches=dict(launches), edges_per_s=E / part_s,
               edges_per_s_with_order=E / (part_s + st.s["oc_order"]),
               rf_counters=res.replication_factor, rf_metrics=m.replication_factor,
               edge_imbalance=m.edge_imbalance, vertex_imbalance=m.vertex_imbalance)
    del res, order
    row["build"] = outofcore_build(dev)
    for k in ("commit_stream_ms", "commit_ms_per_block", "block_call_ms"):
        row[k] = row["build"][k]
    # The phase's: both partition_store runs (full width, twitter_like) and
    # CC on the streamed build, each counted around its own call.
    for path in ("partition_launches", "cc_launches"):
        for k, v in row["build"][path].items():
            launches[k] = launches.get(k, 0) + v
    row["phase_s"] = time.perf_counter() - t0
    return row


def outofcore_build(dev):
    """twitter_like through the out-of-core pipeline on the card, then the
    streamed build of its partition (symmetric) and CC: every SubgraphSet
    field against build_subgraphs on the same partition (the edge list in
    the partition's stream order), CC's labels and every stat against CC on
    that build and the labels against label propagation."""
    from repro_torch.core import outofcore as oc
    from repro_torch.core.streaming import prepare_stream
    from repro_torch.core.types import Graph, PartitionResult
    from repro_torch.data import edgeshards as es
    from repro_torch.graph import algorithms as alg
    from repro_torch.graph.build import ARRAY_FIELDS, build_subgraphs
    from repro_torch.graph.build_stream import build_subgraphs_stream
    from repro_torch.graph.engine import run_bsp
    from repro_torch.graph.generate import make_graph
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import ebg_commit as ebg

    st = Stages()
    tw = make_graph("twitter_like")
    V, block = tw.num_vertices, OUT_OF_CORE["tw_block"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tw_") as tmp:
        store = es.write_graph(tw, Path(tmp) / "store", shard_edges=OUT_OF_CORE["shard_edges"])
        dispatch.reset_launches()
        res = st("tw_partition", oc.partition_store, store, PARTS, "ebv", block=block,
                 order_workdir=Path(tmp) / "order", device=dev)
        partition_launches = dict(dispatch.LAUNCHES)
        check(partition_launches.get("ebg_commit", 0) > 0,
              "partition_store on twitter_like launched ebg_commit no time")
        sub = st("tw_build_stream", build_subgraphs_stream,
                 lambda: res.edge_part_stream(OUT_OF_CORE["shard_edges"]), V, PARTS,
                 symmetrize=True, device=dev)
    # partition_store at block 4,096 against the in-memory stream at that
    # block (prepare_stream and one ebg_commit_stream, the body of
    # streaming_chunked_partition): order, assignments and counters,
    # bitwise. The commit stream is timed apart (CUDA events), and one
    # block's wrapper call (ebg_commit_block: argument checks, the id
    # check, both transposes).
    timing = {}

    def in_memory():
        mem = prepare_stream(tw, PARTS, "ebv", block=block, device=dev)
        keep, e_c, v_c = mem.new_state(PARTS, V)
        t0e, t1e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0e.record()
        parts = ebg.ebg_commit_stream(keep, e_c, v_c, mem.u, mem.v, mem.valid, mem.coef,
                                      block=block, balance=mem.balance)
        t1e.record()
        t1e.synchronize()
        timing["commit_stream_ms"] = t0e.elapsed_time(t1e)
        mid = slice((res.num_blocks // 2) * block, (res.num_blocks // 2 + 1) * block)
        args = (keep, e_c, v_c, mem.u[mid], mem.v[mid], mem.valid[mid], mem.coef)
        timing["block_call_ms"] = cuda_ms(lambda: ebg.ebg_commit_block(*args), reps=20)
        return mem.order, parts[:tw.num_edges], e_c, v_c

    mem_order, mem_parts, e_c, v_c = st("tw_in_memory", in_memory)
    timing["commit_ms_per_block"] = timing["commit_stream_ms"] / res.num_blocks
    check(np.array_equal(res.result.order.numpy(), mem_order),
          "twitter_like: degree_sum_stream's permutation differs from degree_sum_order's")
    check(torch.equal(res.result.part, mem_parts),
          "twitter_like: the out-of-core assignments differ (stream order)")
    in_input = np.empty(tw.num_edges, np.int32)
    in_input[mem_order] = mem_parts.cpu().numpy()
    check(np.array_equal(res.result.part_in_input_order(), in_input),
          "twitter_like: the out-of-core assignments differ (input order)")
    check(np.array_equal(res.e_count, e_c.cpu().numpy()) and
          np.array_equal(res.v_count, v_c.cpu().numpy()),
          "twitter_like: the out-of-core counters differ")
    log(f"outofcore twitter_like: partition_store == the in-memory stream at block {block} "
        f"(order, parts, counters); the commit kernel {timing['commit_stream_ms']:.1f} ms the "
        f"stream, {timing['commit_ms_per_block'] * 1e3:.2f} µs a block; one ebg_commit_block "
        f"call {timing['block_call_ms']:.3f} ms")
    del mem_parts, e_c, v_c

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
    return dict(edges=tw.num_edges, block=block, blocks=res.num_blocks, stage_s=dict(st.s),
                cc_supersteps=stats.supersteps, cc_messages=stats.total_messages,
                rf_counters=res.replication_factor, partition_launches=partition_launches,
                cc_launches=cc_launches, **timing)


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
            val, _, steps, ms, its = runner.gather(runner(arrays, init))  # world 1: all rows
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
        r = runner.rows  # this rank's rows in, the whole set gathered out
        val, _, steps, ms, its = runner.gather(runner({k: a[r] for k, a in arrays.items()},
                                                      job["init"][r]))
        wall = time.perf_counter() - t
        if rank == 0:
            torch.save(dict(val=val, steps=steps, ms=ms, its=its, wall_s=wall),
                       work / "output.pt")
    finally:
        dist.destroy_process_group()
    return 0


# ------------------------------------------- the graph engine's dry-run


def phase_graph_dryrun(dev):
    """Phase 5b: the production dry-run at p = 256 and p = 512 (see the
    module docstring). Returns ({"p256": record, "p512": record, "launches":
    the path's launches, "phase_s": ...}, the min kernel's entry at the
    dry-run shape)."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch import graph_dryrun as gd

    t0 = time.perf_counter()
    out, launches, entry = {}, {}, None
    for multi_pod in (False, True):
        name = "p512" if multi_pod else "p256"
        dispatch.reset_launches()
        rec = gd.run_graph_dryrun(multi_pod=multi_pod, device=dev, **GRAPH_DRYRUN)
        got = dict(dispatch.LAUNCHES)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        # Three a superstep, the 2^24 guard's all-reduce before, the id flag's after.
        check(rec["collectives"] == rec["plan_collectives"]
              and rec["collectives_count"] == 3 * rec["supersteps"] + 2,
              f"graph_dryrun {name}: recorded collectives {rec['collectives']} "
              f"({rec['collectives_count']}) differ from the plan's {rec['plan_collectives']}")
        check(rec["device_arg_bytes"] == rec["arg_bytes"],
              f"graph_dryrun {name}: the rank's tensors hold {rec['device_arg_bytes']} bytes on "
              f"the card, the plan {rec['arg_bytes']}")
        check(rec["bsp_superstep_launches"] > 0
              and got.get("bsp_superstep.min", 0) == rec["bsp_superstep_launches"],
              f"graph_dryrun {name}: bsp_superstep.min launches {got}")
        first, shard_entry = dryrun_first_superstep(gd, multi_pod, dev, timed=entry is None)
        rec["first_superstep"] = first
        entry = entry or shard_entry
        out[name] = rec
        log(f"graph_dryrun {name}: {rec['supersteps']} supersteps, first "
            f"{rec['first_superstep_ms']:.3f} ms, then {rec['ms_per_superstep']} ms a superstep "
            f"({rec['superstep_ms']}), inner "
            f"passes that changed {rec['inner_iters_per_superstep']}; collectives == plan "
            f"({rec['collectives_count']}: {rec['collectives']}); arguments {rec['arg_bytes']} B "
            f"== plan, peak {rec['per_device_hbm_total']} B; link {rec['link_bytes_per_device']}"
            f" B a superstep; bound {rec['bottleneck']} {rec['bound_s'] * 1e6:.1f} us; first "
            f"superstep == plain version; launches {got}")
    out["launches"] = launches
    entry["launches"] = launches.get("bsp_superstep.min", 0)
    out["phase_s"] = time.perf_counter() - t0
    log(f"graph_dryrun: phase {out['phase_s']:.1f} s")
    return out, entry


class PlainSuperstep:
    """While entered, the superstep wrappers run the plain PyTorch version
    on CUDA tensors too (`kernels.bsp_superstep._run` patched): the same
    call with the ids checked on the host, no launch, nothing counted."""

    def __enter__(self):
        from repro_torch.kernels import bsp_superstep as bsp
        from repro_torch.kernels.dispatch import check_ids

        self._real = bsp._run

        def plain(lsrc, ldst, weight, val, num_out, combine, inner_cap, out_degree, err,
                  taken=None, live=None):
            check_ids(("lsrc", lsrc, num_out), ("ldst", ldst, num_out))
            return bsp.bsp_superstep_plain(lsrc, ldst, weight, val, num_out, combine=combine,
                                           inner_cap=inner_cap, out_degree=out_degree,
                                           live=live)

        bsp._run = plain
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import bsp_superstep as bsp

        bsp._run = self._real


def dryrun_first_superstep(gd, multi_pod, dev, timed):
    """The dry-run's first superstep (a lowering of one superstep on the
    same synthetic shard) through the min kernel and through its plain
    version, bitwise (values, messages, inner passes). With `timed`, also
    the min kernel's entry at this shard's first local stage."""
    kw = dict(GRAPH_DRYRUN, num_supersteps=1)
    with gd.lowered_dryrun(multi_pod=multi_pod, device=dev, **kw) as (low, arrays, init):
        arrays = {k: a[low.rows] for k, a in arrays.items()}  # this rank's rows
        init = init[low.rows]
        kern = low.stepper(arrays, init)
        with PlainSuperstep():
            plain = low.stepper(arrays, init)
        check(kern[2] == plain[2] == 1 and torch.equal(kern[0], plain[0])
              and torch.equal(kern[3], plain[3]) and torch.equal(kern[4], plain[4]),
              "graph_dryrun: the first superstep differs from the plain version's")
        first = dict(equal_to_plain=True, messages=int(kern[3][0].sum()),
                     inner_iters=int(kern[4][0].sum()))
        entry = measure_dryrun_min(low, arrays, init, dev) if timed else None
    return first, entry


def measure_dryrun_min(low, arrays, init, dev):
    """bsp_superstep.min at the dry-run's shape: one worker's CC stream of
    both directions over the synthetic shard ([1, 2 x 8,388,608] edges,
    1,048,577 values), bitwise against the plain version, timed beside its
    bound (the stream read once, the values in and out; two operations an
    edge a pass) and one scatter_reduce_ pass; ms a pass beside a pass's
    bound (the stream once)."""
    from repro_torch.graph import engine
    from repro_torch.kernels import bsp_superstep as bsp

    exec_prog, _ = engine._exec_view(engine.get_program(GRAPH_DRYRUN["program"]))
    plan = engine._plan_for(exec_prog, low.stepper.shard(arrays), 512)
    val = engine._to_f32(init.to(dev)).contiguous()
    cap = GRAPH_DRYRUN["inner_cap"]
    kw = dict(num_out=plan.num_out, combine="min", inner_cap=cap)
    lsrc, ldst, w = plan.lsrc, plan.ldst, plan.weight
    got = bsp.bsp_superstep(lsrc, ldst, w, val, **kw)
    want = bsp.bsp_superstep_plain(lsrc, ldst, w, val, **kw)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "bsp_superstep.min at the dry-run shape differs from the plain version")
    flag = torch.zeros((1,), dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: bsp.bsp_superstep(lsrc, ldst, w, val, **kw), reps=5)
    kernel_ms = cuda_ms(lambda: bsp.launch_flagged(lsrc, ldst, w, val, err=flag, **kw), reps=5)
    plain_ms = cuda_ms(lambda: bsp.bsp_superstep_plain(lsrc, ldst, w, val, **kw), reps=1)
    check(int(flag) == 0, "bsp_superstep.min: the id guard fired on the dry-run's shard")
    p, E = lsrc.shape
    passes = int((got[1] + 1).clamp(max=cap).sum())
    io_bytes = nbytes(lsrc, ldst, w, val) + nbytes(*got)
    ops = 2.0 * passes * E
    bound = max(io_bytes / HBM_BYTES_PER_S, ops / F32_FLOPS)
    pass_bound = max(12.0 * p * E / HBM_BYTES_PER_S, 2.0 * p * E / F32_FLOPS)
    taken = torch.zeros((cap,), dtype=torch.int64, device=dev)
    bsp.launch_flagged(lsrc, ldst, w, val, err=flag, taken=taken, **kw)
    taken = taken[:int(got[1].max()) + 1].tolist()
    data = torch.where(w < 3.0e38, torch.gather(val, 1, lsrc.long()) + w, 3.0e38)
    idx = ldst.long()
    scratch = val.clone()
    library_ms = cuda_ms(lambda: scratch.scatter_reduce_(1, idx, data, "amin"), reps=5)
    entry = dict(
        name="bsp_superstep.min.dryrun", route="cuda",
        source="src/repro_torch/kernels/csrc/bsp_superstep.cu",
        replaces="src/repro/kernels/bsp_superstep.py:182", launches=0, max_abs_err=0.0,
        ms=ms, plain_ms=plain_ms, bound_ms=1e3 * bound,
        bound_by="bytes" if io_bytes / HBM_BYTES_PER_S >= ops / F32_FLOPS else "operations",
        library_ms=library_ms, library="Tensor.scatter_reduce_(amin), one pass",
        kernel_ms=kernel_ms, worker_passes=passes, ms_per_pass=ms / passes,
        pass_bound_ms=1e3 * pass_bound, pass_edges=taken,
        shape=f"graph_dryrun CC first local stage, one worker: stream [{p}, {E}] (both "
              f"directions of {E // 2} edges), values [{val.shape[0]}, {plan.num_out}]",
    )
    log(f"kernel bsp_superstep.min.dryrun: {ms:.4f} ms ({passes} passes, {ms / passes:.4f} ms a "
        f"pass against {1e3 * pass_bound:.4f}); bound {1e3 * bound:.4f} ms; plain "
        f"{plain_ms:.3f} ms; scatter_reduce_ pass {library_ms:.4f} ms")
    return entry


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
    """ebg_commit past 1,024 parts: p=2048 parts and blocks of 8192 edges of
    the smoke graph's ebv stream (the WIDE kernel, its staging in the
    workspace). Two blocks through the stream entry, then one, frozen and then
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
            # bytes: the state read and written once, the block's edges, its parts
            io = 2 * nbytes(*start) + nbytes(*args[3:6]) + 4 * block
            out["wide_bound_ms"] = 1e3 * io / HBM_BYTES_PER_S
            out["wide_plain_ms"] = cuda_ms(lambda: ebg.ebg_commit_block_plain(*args), reps=1,
                                           warmup=0)
        out[f"wide_check_s_{'window' if window else 'frozen'}"] = compare_s
    words = -(-g.num_vertices // 32)
    out["wide_shape"] = (f"one block: p={parts}, B={block}, bitset {(parts, words)}, "
                         f"the smoke graph's ebv stream from block 2")
    log(f"full: ebg_commit at p={parts}, block {block} == plain (frozen, window); "
        f"{out['wide_block_ms']:.2f} ms a block")
    return out


def transpose_launch(src, dst, p, to_memb):
    """A zero-argument call of the transpose's C entry on fixed buffers (no
    checks, allocation or count), for kernel_ms; checked to launch once."""
    import ctypes

    from repro_torch.kernels.dispatch import c_function, cuda_stream_handle

    fn = c_function("ebg_commit", "ebg_memb_transpose",
                    [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    vw = (src if to_memb else dst).shape[1]
    args = (src.data_ptr(), dst.data_ptr(), p, vw, int(to_memb), cuda_stream_handle())
    check(fn(*args) == 0, "ebg_memb_transpose: the bare launch failed")
    return lambda: fn(*args)


def measure_transposes(keep, launches):
    """The commit's two bitset transposes on the full partition's bitset:
    the wrapper's call (ms) and the bare C launch (kernel_ms), back to back;
    also at the sharded out-of-core path's shape (a block's gathered bitset,
    keep [32, 16]), bitwise against the plain versions, where a launch is
    all there is to time."""
    from repro_torch.kernels import ebg_commit as ebg

    memb = compare_transposes(keep.device, keep)
    gen = torch.Generator(device=keep.device).manual_seed(16)
    small = torch.randint(-2**31, 2**31 - 1, SHARDED_BITSET, generator=gen, device=keep.device,
                          dtype=torch.int32)
    small_memb = compare_transposes(keep.device, small)
    p = keep.shape[0]
    entries = []
    for name, fn, plain, src, dst, shapes in (
        ("ebg_commit.keep_to_memb", ebg.keep_bits_to_memb, ebg.keep_bits_to_memb_plain, keep,
         memb, ((keep, torch.empty_like(memb)), (small, torch.empty_like(small_memb)))),
        ("ebg_commit.memb_to_keep", lambda m: ebg.memb_to_keep_bits(m, p),
         lambda m: ebg.memb_to_keep_bits_plain(m, p), memb, keep,
         ((memb, torch.empty_like(keep)), (small_memb, torch.empty_like(small)))),
    ):
        to_memb = name.endswith("to_memb")
        io_bytes = nbytes(src, dst)
        n_ops = 20.0 * src.numel()  # the butterfly: 5 rounds of a shuffle, shifts, a select
        bound = max(io_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS)
        (big_in, big_out), (small_in, small_out) = shapes
        entries.append(dict(
            name=name, route="cuda", source="src/repro_torch/kernels/csrc/memb_transpose.cuh",
            replaces="src/repro/kernels/ebg_commit.py:124", launches=launches.get(name, 0),
            max_abs_err=0.0,  # compare_transposes demands bitwise equality
            ms=cuda_ms(lambda: fn(src), reps=50),
            kernel_ms=cuda_ms(transpose_launch(big_in, big_out, p, to_memb), reps=50),
            plain_ms=cuda_ms(lambda: plain(src), reps=2), bound_ms=1e3 * bound,
            bound_by="bytes" if io_bytes / HBM_BYTES_PER_S >= n_ops / F32_FLOPS else "operations",
            library_ms=None, library=None,
            shape=f"keep {tuple(keep.shape)} <-> memb {tuple(memb.shape)} int32",
            sharded_ms=cuda_ms(lambda: fn(small_in), reps=200),
            sharded_kernel_ms=cuda_ms(transpose_launch(small_in, small_out, p, to_memb),
                                      reps=200),
            sharded_bound_ms=1e3 * nbytes(small_in, small_out) / HBM_BYTES_PER_S,
            sharded_shape=f"keep {tuple(small.shape)} <-> memb {tuple(small_memb.shape)}: a "
                          f"block's gathered bitset on the sharded out-of-core path",
        ))
    log("full: transposes " + ", ".join(
        f"{e['name']} {e['ms']:.4f} ms (bare {e['kernel_ms']:.4f}; sharded shape "
        f"{e['sharded_ms']:.4f}, bare {e['sharded_kernel_ms']:.4f})" for e in entries))
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


# ------------------------------------------------------- the LM serving path


def lm_compare(got_toks, got, want_toks, want, tol):
    """Per row and step: max |logit error| until the row's first step whose
    top-2 margin in `want` is within tol (or whose tokens differ, which must
    then be such a step): (max error, the (row, step) pairs compared)."""
    top = want.float().topk(2, dim=-1).values
    margin = (top[..., 0] - top[..., 1]).cpu()
    err = (got.float() - want.float()).abs().amax(dim=-1).cpu()
    worst, compared = 0.0, 0
    for b in range(want_toks.shape[0]):
        for t in range(want_toks.shape[1]):
            worst = max(worst, float(err[b, t]))
            compared += 1
            if int(got_toks[b, t]) != int(want_toks[b, t]):
                check(float(margin[b, t]) <= tol,
                      f"lm: row {b} step {t} took another token at a top-2 margin of "
                      f"{float(margin[b, t])} > {tol}")
                break
            if float(margin[b, t]) <= tol:
                break
    return worst, compared


def lm_generate(cfg, params, prompt, plain=False, N=None):
    """One generate call through the serving entry point, N new tokens
    (LM's by default): (tokens [B, N],
    logits [B, N + 1, vocab] of the prefill and each decode step, prefill
    ms, per-token decode ms, host wall s), each step timed by a CUDA event
    recorded as it is enqueued."""
    import contextlib

    from repro_torch.launch.serve import generate
    from repro_torch.models import layers

    N = LM["new_tokens"] if N is None else N
    events, logits = [], []

    def on_step(t, lg):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        logits.append(lg)

    start = torch.cuda.Event(enable_timing=True)
    sync()
    t0 = time.perf_counter()
    start.record()
    with layers.plain_decode_attention() if plain else contextlib.nullcontext():
        toks = generate(cfg, params, prompt, N, prompt.shape[1] + N, on_step=on_step)
    sync()
    wall = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return toks, torch.stack(logits, dim=1), start.elapsed_time(events[0]), step_ms, wall


def phase_lm(dev):
    """The LM serving path at full width through `repro_torch.launch.serve`:
    the kernel run (launch counts zeroed just before it and read just after),
    the same call on the plain decode attention, every step's logits against
    the full forward, the CLI's tiny preset (f32 over bf16 caches) in a
    process of its own, and decode_attention's kernel entries on the live
    cache."""
    from repro_torch import configs
    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer
    from repro_torch.serve.padding import bucket_size, pad_batch_rows

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get_config(LM["config"])
    B, S0, N = LM["batch"], LM["prompt_len"], LM["new_tokens"]
    t = time.perf_counter()
    params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(LM["seed"]),
                                     torch.bfloat16)
    sync()
    init_s = time.perf_counter() - t
    n_params = sum(p.numel() for p in params.parameters())
    # The config's count leaves out the final norm's d_model scales.
    check(n_params == cfg.num_params() + cfg.d_model,
          f"lm: {n_params} parameters, the config counts {cfg.num_params()} + {cfg.d_model}")
    bucket = bucket_size(B)
    prompt = pad_batch_rows(np.random.default_rng(0).integers(0, cfg.vocab, (B, S0)), bucket)
    prompt = torch.from_numpy(prompt).to(dev)
    lm_generate(cfg, params, prompt[:, :64])  # warm-up: cuBLAS, the allocator

    dispatch.reset_launches()
    toks, logits, prefill_ms, step_ms, wall = lm_generate(cfg, params, prompt)
    launches = dict(dispatch.LAUNCHES)
    want = cfg.n_layers * N
    check(launches.get("decode_attention", 0) == want,
          f"lm: decode_attention launched {launches.get('decode_attention', 0)} times in the "
          f"generate call, not n_layers x new tokens = {want}")
    check(toks.shape == (bucket, N) and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          "lm: tokens out of shape or range")
    check(logits.shape == (bucket, N + 1, cfg.vocab) and bool(torch.isfinite(logits).all()),
          "lm: logits not finite or out of shape")
    log(f"lm: {cfg.name} generate: prefill {prefill_ms:.1f} ms, decode p50 "
        f"{np.percentile(step_ms, 50):.2f} ms a token, {want} decode_attention launches")

    # The same call, its decode attention on the plain version.
    dispatch.reset_launches()
    ptoks, plogits, _, plain_step_ms, _ = lm_generate(cfg, params, prompt, plain=True)
    check(dispatch.LAUNCHES.get("decode_attention", 0) == 0,
          "lm: the plain run launched the kernel")
    plain_err, compared = lm_compare(toks, logits, ptoks, plogits, LM_LOGIT_ATOL)
    check(plain_err <= LM_LOGIT_ATOL, f"lm: kernel run's logits differ from the plain run's "
                                      f"by {plain_err} > {LM_LOGIT_ATOL}")
    tokens_equal = int((toks == ptoks).all(dim=1).sum())
    # Decode ≡ full forward: every step's logits against one forward of the
    # prompt and the generated tokens (the reference's tests/test_models.py
    # check, at full width).
    full, _ = transformer.forward(cfg, params, tokens=torch.cat([prompt, toks.long()], dim=1))
    full = full[:, S0 - 1:]  # position S0 - 1 + t is step t's
    full_err_all = float((logits.float() - full.float()).abs().max())
    last_err = float((logits[:, -1].float() - full[:, -1].float()).abs().max())
    control = float((logits[:, -1].float() - full[:, -1].roll(1, dims=0).float()).abs().max())
    del full
    check(full_err_all <= LM_LOGIT_ATOL,
          f"lm: decode logits differ from the full forward by {full_err_all} > {LM_LOGIT_ATOL}")
    check(control > LM_LOGIT_ATOL, f"lm: the limit passes the control (another row's logits, "
                                   f"{control})")
    log(f"lm: kernel == plain run over {compared} (row, step) pairs (max |logit err| "
        f"{plain_err:.4f}; {tokens_equal}/{bucket} rows' tokens equal), == full forward at "
        f"every step (max {full_err_all:.4f}; last step {last_err:.4f}; control {control:.2f})")

    # The plain decode attention fed the kernel run's tokens: every step's
    # logits comparable, near-ties or not; its caches feed the kernel entries.
    dispatch.reset_launches()
    _, forced, _, _, _, caches = lm_steps(cfg, params, prompt, N, forced=toks, plain=True)
    check(dispatch.LAUNCHES.get("decode_attention", 0) == 0,
          "lm: the teacher-forced plain run launched the kernel")
    forced_err = float((logits.float() - forced.float()).abs().max())
    forced_tokens = int((forced[:, :N].float().argmax(dim=-1) == toks).sum())
    check(forced_err <= LM_LOGIT_ATOL, f"lm: kernel run's logits differ from the plain "
                                       f"decode's on the same tokens by {forced_err}")
    log(f"lm: == plain decode on the kernel run's tokens at every step (max |logit err| "
        f"{forced_err:.4f}; {forced_tokens}/{bucket * N} greedy tokens equal)")
    entries = measure_lm_attention(cfg, caches[0], launches.get("decode_attention"), dev)
    del params, logits, plogits, forced, caches
    torch.cuda.empty_cache()

    # The CLI on the card: the tiny preset, f32 parameters over bf16 caches.
    t = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--preset", "tiny"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    cli_s = time.perf_counter() - t
    check(cli.returncode == 0 and "generated 128 tokens" in cli.stdout,
          f"lm: python -m repro_torch.launch.serve --preset tiny failed:\n{cli.stdout}\n"
          f"{cli.stderr}")
    log(f"lm: the serve CLI (--preset tiny) on the card in {cli_s:.1f} s: "
        f"{cli.stdout.splitlines()[0]}")
    decode_s = sum(step_ms) / 1e3
    out = dict(
        config=cfg.name, params=n_params, dtype="bfloat16", batch=B, bucket=bucket,
        prompt_len=S0, new_tokens=N, max_seq=S0 + N, init_s=init_s,
        prefill_s=prefill_ms / 1e3, decode_ms_p50=float(np.percentile(step_ms, 50)),
        decode_ms_p99=float(np.percentile(step_ms, 99)),
        plain_decode_ms_p50=float(np.percentile(plain_step_ms, 50)),
        tokens_per_s=B * N / decode_s, tokens_per_s_with_prefill=B * N / wall,
        generate_wall_s=wall, launches=launches,
        max_abs_logit_err_plain=plain_err, plain_pairs_compared=compared,
        plain_rows_tokens_equal=tokens_equal,
        max_abs_logit_err_teacher_forced=forced_err, teacher_forced_tokens_equal=forced_tokens,
        max_abs_logit_err_full_forward=full_err_all,
        max_abs_logit_err_full_forward_last=last_err, control_err=control,
        logit_atol=LM_LOGIT_ATOL, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        cli_s=cli_s, cli=cli.stdout.strip(),
    )
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"lm: phase {out['phase_s']:.1f} s")
    return out, entries


def attention_entry(name, q, k, v, end, ranges, launches, shape, launches_of, softcap=0.0):
    """decode_attention's kernels entry for one decode shape: q [B, Hq, D]
    over keys [0, end) of k, v [B, S, Hkv, D] (a live cache read in place,
    or a fresh K and V), held against the plain version at ATTN_TOL with
    its x1.01 control, also at each key range of `ranges` on a copy of k
    and v that is NaN outside it; timed beside its bound, the plain version
    and, without a softcap, SDPA on the same keys (a bf16 query)."""
    from repro_torch.kernels import decode_attn, ops

    B, Hq, D = q.shape
    Hkv = k.shape[2]

    def held(kc, vc, lo, hi):
        got = ops.decode_attention(q, kc, vc, start=lo, end=hi, softcap=softcap)
        want = decode_attn.decode_attention_plain(q, k[:, lo:hi], v[:, lo:hi],
                                                  softcap=softcap).float()
        rtol, atol = ATTN_TOL[q.dtype]
        check(got.dtype == q.dtype and bool(torch.isfinite(got.float()).all()),
              f"{name} keys [{lo}, {hi}): output type or values")
        reading = dict(max_abs_err=float((got.float() - want).abs().max()),
                       over_limit=over_limit(got.float(), want, rtol, atol),
                       control_over_limit=over_limit(ATTN_CONTROL * got.float(), want, rtol,
                                                     atol))
        check(reading["over_limit"] <= 1.0,
              f"{name} keys [{lo}, {hi}) differs from the plain version: {reading}")
        check(reading["control_over_limit"] > 1.0,
              f"{name} keys [{lo}, {hi}): the limit passes the control")
        return got, reading

    got, reading = held(k, v, 0, end)
    at_ranges = {}
    for lo, hi in ranges:
        kn, vn = k.clone(), v.clone()
        for t in (kn, vn):
            t[:, :lo] = float("nan")
            t[:, hi:] = float("nan")
        at_ranges[f"[{lo}, {hi})"] = held(kn, vn, lo, hi)[1]
        del kn, vn
    ms = cuda_ms(lambda: ops.decode_attention(q, k, v, start=0, end=end, softcap=softcap),
                 reps=50)
    # The launch without the wrapper's checks and the custom op's dispatch.
    launch_ms = cuda_ms(lambda: decode_attn._decode_attention_cuda(q, k, v, softcap, 0, end),
                        reps=50)
    plain_ms = cuda_ms(lambda: decode_attn.decode_attention_plain(q, k[:, :end], v[:, :end],
                                                                  softcap=softcap), reps=5)
    library_ms = None
    if not softcap:
        q4, k4, v4 = q.to(k.dtype)[:, :, None], k[:, :end].transpose(1, 2), \
            v[:, :end].transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = cuda_ms(lambda: sdpa(q4, k4, v4, enable_gqa=True), reps=50)
    io_bytes = nbytes(q, got) + 2 * B * end * Hkv * D * k.element_size()
    n_ops = 4.0 * B * Hq * end * D
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS
    bound = max(io_bytes / HBM_BYTES_PER_S, n_ops / peak)
    source = decode_attn.kernel_source(D)
    if source == "decode_attn":
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        nsplit = decode_attn.split_count(B, end, Hkv, Hq // Hkv, sms,
                                         decode_attn.tile_keys(D, k.dtype))
        plan = f"{nsplit} splits"
    else:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        plan = (f"{decode_attn.wide_split_count(B, end, Hkv, Hq // Hkv, sms)} splits, "
                f"{decode_attn.wide_stages(Hq // Hkv, k.dtype)} stages (an H100's rule)")
    rtol, atol = ATTN_TOL[q.dtype]
    return dict(
        name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{source}.cu",
        replaces="src/repro/kernels/decode_attn.py:61", launches=launches,
        launches_of=launches_of, max_abs_err=reading["max_abs_err"], ms=ms, launch_ms=launch_ms,
        plain_ms=plain_ms, bound_ms=1e3 * bound,
        bound_by="bytes" if io_bytes / HBM_BYTES_PER_S >= n_ops / peak else "operations",
        library_ms=library_ms,
        library="F.scaled_dot_product_attention(enable_gqa=True), bf16 q" if library_ms
        is not None else "none computes the softcap",
        limit=f"rtol {rtol}, atol {atol}", over_limit=reading["over_limit"],
        control_over_limit=reading["control_over_limit"], key_ranges_nan_outside=at_ranges,
        softcap=softcap,
        shape=f"{shape}: B={B}, Hq={Hq}, Hkv={Hkv}, D={D}, keys [0, {end}) of "
              f"[{B}, {k.shape[1]}, {Hkv}, {D}] {str(k.dtype).replace('torch.', '')}, q "
              f"{str(q.dtype).replace('torch.', '')}, {plan}",
    )


def measure_lm_attention(cfg, cache, lm_launches, dev):
    """decode_attention at the LM path's shapes: a bf16 query (and an f32
    one, the f32-over-bf16 build) over all 1,088 keys of layer 0's live
    cache, written by the serving steps; timed beside its bound, the plain
    version and SDPA on the same keys. Each is also held at key ranges the
    decode steps read, [0, 1,025) and [0, 1,057), and one from a start past
    0, on a copy of the cache whose rows outside the range are NaN."""
    B = LM["batch"]
    k, v, end = cache.k, cache.v, cache.pos
    check(end == LM["prompt_len"] + LM["new_tokens"] == k.shape[1],
          "lm: the cache is not full after the decode steps")
    gen = torch.Generator(device=dev).manual_seed(21)
    ranges = ((0, LM["prompt_len"] + 1), (0, LM["prompt_len"] + 33), (37, end - 27))
    entries = []
    for name, qt in (("decode_attention.llama3_2_3b", torch.bfloat16),
                     ("decode_attention.llama3_2_3b.f32q", torch.float32)):
        q = torch.randn((B, cfg.n_heads, cfg.head_dim_), generator=gen, device=dev).to(qt)
        entries.append(attention_entry(
            name, q, k, v, end, ranges, lm_launches, "llama3_2_3b decode step, layer 0's live "
            "cache", "decode_attention in the lm phase's generate call"))
        del q
    return entries


# ------------------------------------------------- the other LM families


class RouteSpy:
    """Records the experts each MoE router call chooses (`models.moe.route`,
    patched while the spy is entered): one [T, k] tensor of expert ids a
    call, each token's ids sorted, so that two runs' choices compare as
    sets. A run makes one call a MoE layer a forward, in layer order."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe

        self._real = moe.route

        def spy(cfg, router, xf):
            out = self._real(cfg, router, xf)
            self.calls.append(out[2].sort(dim=-1).values)
            return out

        moe.route = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route = self._real

    def by_position(self, moe_layers, B):
        """[moe_layers, B, positions, k]: each layer's choices over the
        run's positions (a prefill or a full forward: B·S tokens a call; a
        decode step: B)."""
        per = [[] for _ in range(moe_layers)]
        for i, c in enumerate(self.calls):
            per[i % moe_layers].append(c.reshape(B, -1, c.shape[-1]))
        return torch.stack([torch.cat(x, dim=1) for x in per])


def lm_steps(cfg, params, prompt, N, *, forced=None, plain=False, enc=None):
    """The serving steps (`make_prefill_step`, then N `make_serve_step`
    calls): greedy, or fed `forced` [B, N] (teacher-forced). `enc`: the
    encoder-decoder's inputs, {"enc_embeds": frames} for the prefill and
    {"enc_out": ...} for the steps. Returns (tokens [B, N], logits [B, N+1,
    vocab], prefill ms, per-step ms (CUDA events recorded as each step is
    enqueued), host wall s, the caches)."""
    import contextlib

    from repro_torch.models import layers, steps

    enc = enc or {}
    S0 = prompt.shape[1]
    prefill_batch = dict(tokens=prompt, **{k: v for k, v in enc.items() if k == "enc_embeds"})
    step_enc = {k: v for k, v in enc.items() if k == "enc_out"}
    events, out, toks = [], [], []
    start = torch.cuda.Event(enable_timing=True)
    sync()
    t0 = time.perf_counter()
    start.record()
    with torch.no_grad(), layers.plain_decode_attention() if plain else contextlib.nullcontext():
        logits, caches = steps.make_prefill_step(cfg, S0 + N)(params, prefill_batch)
        serve = steps.make_serve_step(cfg)
        for t in range(N + 1):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            out.append(logits)
            if t == N:
                break
            tok = forced[:, t:t + 1].long() if forced is not None else \
                torch.argmax(logits, dim=-1)[:, None]
            toks.append(tok)
            logits, caches = serve(params, caches, dict(token=tok, pos=S0 + t, **step_enc))
    sync()
    wall = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return (torch.cat(toks, dim=1), torch.stack(out, dim=1), start.elapsed_time(events[0]),
            step_ms, wall, caches)


def logit_check(label, got, want, atol, mask=None):
    """Max |logit error| of got against want [B, N+1, vocab] over the (row,
    step) pairs of `mask` (all by default), within atol; a control (want's
    last step rolled to another row) must fail it. Returns (max error,
    pairs compared, control, each step's max error over its compared rows)."""
    err = (got.float() - want.float()).abs().amax(dim=-1).cpu()  # [B, N+1]
    mask = torch.ones_like(err, dtype=torch.bool) if mask is None else mask
    worst = float(err[mask].max()) if bool(mask.any()) else 0.0
    per_step = [float(err[:, t][mask[:, t]].max()) if bool(mask[:, t].any()) else None
                for t in range(err.shape[1])]
    control = float((got[:, -1].float() - want[:, -1].roll(1, dims=0).float()).abs().max())
    check(worst <= atol, f"{label}: logits differ by {worst} > {atol}; by step: {per_step}")
    check(control > atol, f"{label}: the limit passes the control (another row's logits, "
                          f"{control})")
    return worst, int(mask.sum()), control, per_step


def family_stats(B, N, prefill_ms, step_ms, wall):
    decode_s = sum(step_ms) / 1e3
    return dict(prefill_s=prefill_ms / 1e3, decode_ms_p50=float(np.percentile(step_ms, 50)),
                decode_ms_p99=float(np.percentile(step_ms, 99)), tokens_per_s=B * N / decode_s,
                tokens_per_s_with_prefill=B * N / wall, generate_wall_s=wall,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def lm_family_prompt(cfg, B, S0, dev):
    from repro_torch.serve.padding import bucket_size, pad_batch_rows

    rng = np.random.default_rng(LM_FAMILIES["seed"])
    prompt = pad_batch_rows(rng.integers(0, cfg.vocab, (B, S0)), bucket_size(B))
    return torch.from_numpy(prompt).to(dev)


def phase_lm_families(dev):
    """The MoE (with EBV expert placement), SSM and encoder-decoder families
    on the card, each at its published widths with seeded random bf16
    weights drawn there, B = 8, 32 greedy tokens (module docstring, phase
    7). Returns (record, kernels entries)."""
    t_phase = time.perf_counter()
    out, entries = {}, []
    out["phi3_5_moe"], e = family_phi3(dev)
    entries += e
    out["mamba2_780m"] = family_mamba2(dev)
    out["seamless_m4t_large_v2"], e = family_seamless(dev)
    entries += e
    entries.append(measure_wide_attention(dev))
    entries.append(measure_widest_attention(dev))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"lm_families: phase {out['phase_s']:.1f} s")
    return out, entries


def family_phi3(dev):
    """phi3_5_moe, 16 of its 32 layers at the published widths: generate
    (kernel launches exact), every step against the plain attention fed the
    same tokens and, on a copy with capacity_factor 16 (nothing drops),
    against the full forward; the comparisons skip the (row, step) pairs
    whose expert choice the two runs made differently in some layer (a
    bf16 near-tie in the router), and count them. Then the EBV placement of
    layer 0's prefill routing, and one decode step with that expert_perm
    and the weights permuted to match, equal to the unpermuted step."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core import placement
    from repro_torch.kernels import dispatch
    from repro_torch.models import moe, steps, transformer

    c = PHI3
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(configs.get_config(c["config"]), n_layers=c["n_layers"])
    nodrop = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=c["nodrop_capacity_factor"]))
    B, S0, N = LM_FAMILIES["batch"], c["prompt_len"], LM_FAMILIES["new_tokens"]
    atol = LM_FAMILY_ATOL[cfg.name]
    t = time.perf_counter()
    params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(
        LM_FAMILIES["seed"]), torch.bfloat16)
    sync()
    init_s = time.perf_counter() - t
    prompt = lm_family_prompt(cfg, B, S0, dev)
    lm_generate(cfg, params, prompt[:, :64], N=2)  # warm-up: cuBLAS, the allocator

    dispatch.reset_launches()
    with RouteSpy() as spy_k:
        toks, logits, prefill_ms, step_ms, wall = lm_generate(cfg, params, prompt, N=N)
    launches = dict(dispatch.LAUNCHES)
    want = cfg.n_layers * N
    check(launches.get("decode_attention", 0) == want,
          f"phi3: decode_attention launched {launches.get('decode_attention', 0)} times in the "
          f"generate call, not {want}")
    check(logits.shape == (B, N + 1, cfg.vocab) and bool(torch.isfinite(logits).all()),
          "phi3: logits not finite or out of shape")
    stats = family_stats(B, N, prefill_ms, step_ms, wall)
    log(f"lm_families: phi3_5_moe ({cfg.n_layers} layers) generate: prefill "
        f"{prefill_ms:.1f} ms, decode p50 {stats['decode_ms_p50']:.2f} ms, {want} launches")

    # The same steps on the plain attention, fed the kernel run's tokens.
    dispatch.reset_launches()
    with RouteSpy() as spy_p:
        _, plain_logits, _, plain_step_ms, _, caches = lm_steps(cfg, params, prompt, N,
                                                                forced=toks, plain=True)
    check(dispatch.LAUNCHES.get("decode_attention", 0) == 0, "phi3: the plain run launched")
    rk = spy_k.by_position(cfg.n_layers, B)
    same = (rk == spy_p.by_position(cfg.n_layers, B)).all(-1).all(0).cpu()  # [B, S0 + N]
    plain_err, plain_pairs, plain_control, plain_steps = logit_check(
        "phi3 kernel vs plain", logits, plain_logits, atol, same[:, S0 - 1:])
    cap = moe.capacity(cfg, B * S0)
    prefill_drops = [int((torch.bincount(rk[layer, :, :S0].reshape(-1),
                                         minlength=cfg.moe.num_experts) - cap).clamp(min=0)
                         .sum()) for layer in range(cfg.n_layers)]
    # Layer 0's prefill routing → the EBV placement over 4 devices, beside a
    # seeded random placement.
    pairs = placement.routing_pairs(rk[0, :, :S0].reshape(-1, cfg.moe.top_k))
    E, D = cfg.moe.num_experts, c["devices"]
    t = time.perf_counter()
    perm = placement.ebg_expert_placement(pairs, E, D)
    place_s = time.perf_counter() - t
    rand = np.argsort(np.random.default_rng(LM_FAMILIES["seed"]).random(E))
    reports = {"ebv": placement.placement_report(pairs, perm, E, D),
               "random": placement.placement_report(pairs, rand, E, D)}
    log(f"lm_families: phi3 kernel == plain over {plain_pairs} (row, step) pairs (max |logit "
        f"err| {plain_err:.4f}; {same[:, S0 - 1:].numel() - plain_pairs} pairs with another "
        f"expert choice); prefill drops at capacity_factor {cfg.moe.capacity_factor}: "
        f"{sum(prefill_drops)}; placement {reports}")

    # Decode ≡ full forward where nothing drops: the kernel's steps on the
    # capacity_factor 16 copy, fed the same tokens, against one full forward.
    dispatch.reset_launches()
    with RouteSpy() as spy_t:
        _, forced_logits, _, _, _, caches = lm_steps(nodrop, params, prompt, N, forced=toks)
    check(dispatch.LAUNCHES.get("decode_attention", 0) == want, "phi3: forced kernel launches")
    with RouteSpy() as spy_f:
        full, _ = transformer.forward(nodrop, params, tokens=torch.cat([prompt, toks], dim=1))
    full = full[:, S0 - 1:]
    same_f = (spy_t.by_position(cfg.n_layers, B) ==
              spy_f.by_position(cfg.n_layers, B)).all(-1).all(0).cpu()
    full_err, full_pairs, full_control, full_steps = logit_check("phi3 decode vs full forward",
                                                     forced_logits, full, atol,
                                                     same_f[:, S0 - 1:])
    del full, forced_logits, plain_logits

    # One decode step with the placement's expert_perm and the experts'
    # weights moved to their slots (in place, then back): the unpermuted
    # step's logits, bit for bit.
    perm_t = torch.from_numpy(perm).to(dev)
    serve = steps.make_serve_step(cfg)
    last = dict(token=toks[:, -1:].long(), pos=S0 + N - 1)

    def step():
        for cache in caches:
            cache.pos = S0 + N - 1
        return serve(params, caches, dict(last))[0]

    base = step()

    def move(index):
        for layer in params.layers:
            for name in ("w_gate", "w_in", "w_out"):
                w = getattr(layer.moe, name)
                moved = torch.empty_like(w)
                moved[index] = w
                w.copy_(moved)

    real_ep = moe.moe_ffn_ep
    move(perm_t)
    try:
        moe.moe_ffn_ep = lambda cfg_, p, x, group=None: moe.moe_ffn(cfg_, p, x,
                                                                   expert_perm=perm_t)
        permuted = step()
    finally:
        moe.moe_ffn_ep = real_ep
        move(torch.argsort(perm_t))
    gap = float((permuted.float() - base.float()).abs().max())
    check(torch.equal(permuted, base), f"phi3: the permuted-expert step differs from the "
                                       f"unpermuted one by {gap}")
    check(torch.equal(step(), base), "phi3: the weights did not come back")
    log(f"lm_families: phi3 decode == full forward (capacity_factor "
        f"{nodrop.moe.capacity_factor}) over {full_pairs} pairs (max {full_err:.4f}; control "
        f"{full_control:.2f}); the permuted-expert step == the unpermuted one")

    entries = [attention_entry(
        "decode_attention.phi3_5_moe", torch.randn((B, cfg.n_heads, cfg.head_dim_), device=dev,
                                                   generator=torch.Generator(device=dev)
                                                   .manual_seed(35)).to(torch.bfloat16),
        caches[0].k, caches[0].v, S0 + N, ((0, S0 + 1), (37, S0 + 5)), want,
        "phi3_5_moe decode step, layer 0's live cache",
        "decode_attention in the lm_families phase's phi3_5_moe generate call")]
    n_params = sum(p.numel() for p in params.parameters())
    del params, caches
    torch.cuda.empty_cache()
    rec = dict(config=cfg.name, n_layers=cfg.n_layers, published_layers=32, params=n_params,
               batch=B, prompt_len=S0, new_tokens=N, capacity_factor=cfg.moe.capacity_factor,
               init_s=init_s, **stats, plain_decode_ms_p50=float(np.percentile(plain_step_ms, 50)),
               launches=launches, logit_atol=atol,
               max_abs_logit_err_plain=plain_err, plain_pairs_compared=plain_pairs,
               plain_pairs_other_experts=int(same[:, S0 - 1:].numel() - plain_pairs),
               plain_control_err=plain_control, plain_err_by_step=plain_steps,
               max_abs_logit_err_full_forward=full_err, full_pairs_compared=full_pairs,
               full_err_by_step=full_steps,
               full_pairs_other_experts=int(same_f[:, S0 - 1:].numel() - full_pairs),
               full_prompt_positions_other_experts=int((~same_f[:, :S0 - 1]).sum()),
               full_control_err=full_control, prefill_drops=prefill_drops, prefill_cap=cap,
               placement=dict(devices=D, experts=E, tokens=int(pairs.shape[0]), s=place_s,
                              perm=perm.tolist(), **reports),
               permuted_step_equal=True)
    return rec, entries


def family_mamba2(dev):
    """mamba2_780m whole: generate launches no kernel; every decode step
    against the full forward (chunked SSD over prompt and tokens)."""
    from repro_torch import configs
    from repro_torch.kernels import dispatch
    from repro_torch.models import ssm, transformer

    c = MAMBA2
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get_config(c["config"])
    B, S0, N = LM_FAMILIES["batch"], c["prompt_len"], LM_FAMILIES["new_tokens"]
    for S in (S0, S0 + N):  # the chunked SSD's chunk: never the loop of chunk 1
        check(ssm.pick_chunk(S, cfg.ssm.chunk) > 1, f"mamba2: a length {S} takes chunk 1")
    atol = LM_FAMILY_ATOL[cfg.name]
    t = time.perf_counter()
    params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(
        LM_FAMILIES["seed"]), torch.bfloat16)
    sync()
    init_s = time.perf_counter() - t
    prompt = lm_family_prompt(cfg, B, S0, dev)
    lm_generate(cfg, params, prompt[:, :64], N=2)
    dispatch.reset_launches()
    toks, logits, prefill_ms, step_ms, wall = lm_generate(cfg, params, prompt, N=N)
    launches = dict(dispatch.LAUNCHES)
    check(sum(launches.values()) == 0, f"mamba2: the SSM stack launched {launches}")
    check(logits.shape == (B, N + 1, cfg.vocab) and bool(torch.isfinite(logits).all()),
          "mamba2: logits not finite or out of shape")
    stats = family_stats(B, N, prefill_ms, step_ms, wall)
    full, _ = transformer.forward(cfg, params, tokens=torch.cat([prompt, toks], dim=1))
    full_err, pairs, control, full_steps = logit_check("mamba2 decode vs full forward", logits,
                                                       full[:, S0 - 1:], atol)
    n_params = sum(p.numel() for p in params.parameters())
    del params, full, logits
    torch.cuda.empty_cache()
    # The same weights unrounded (f32 draws of the same generator), the same
    # tokens: decode against the full forward, where no bf16 rounding hides
    # a fault.
    params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(
        LM_FAMILIES["seed"]), torch.float32)
    _, f32_logits, _, _, _, _ = lm_steps(cfg, params, prompt, N, forced=toks)
    full, _ = transformer.forward(cfg, params, tokens=torch.cat([prompt, toks], dim=1))
    f32_err, _, f32_control, f32_steps = logit_check("mamba2 f32 decode vs full forward",
                                                     f32_logits, full[:, S0 - 1:],
                                                     MAMBA2_F32_ATOL)
    log(f"lm_families: mamba2_780m generate: prefill {prefill_ms:.1f} ms (chunked SSD), "
        f"decode p50 {stats['decode_ms_p50']:.2f} ms; == full forward over {pairs} pairs (max "
        f"{full_err:.4f}; control {control:.2f}); in f32 max {f32_err:.2e}")
    del params, full, f32_logits
    torch.cuda.empty_cache()
    return dict(config=cfg.name, n_layers=cfg.n_layers, params=n_params, batch=B,
                prompt_len=S0, new_tokens=N, chunk=ssm.pick_chunk(S0, cfg.ssm.chunk),
                init_s=init_s, **stats, launches=launches, logit_atol=atol,
                max_abs_logit_err_full_forward=full_err, full_pairs_compared=pairs,
                full_control_err=control, full_err_by_step=full_steps,
                f32_logit_atol=MAMBA2_F32_ATOL, max_abs_logit_err_full_forward_f32=f32_err,
                f32_control_err=f32_control, f32_err_by_step=f32_steps)


def family_seamless(dev):
    """seamless_m4t_large_v2 whole, with 1,024 seeded random encoder frames
    (the audio frontend is a stub in both packages): the prefill with the
    frames, then serve steps given the encoder's output computed once
    (launches exact: self- and cross-attention); every step against the
    plain attention fed the same tokens and against the full forward."""
    from repro_torch import configs
    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer

    c = SEAMLESS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get_config(c["config"])
    B, S0, N = LM_FAMILIES["batch"], c["prompt_len"], LM_FAMILIES["new_tokens"]
    atol = LM_FAMILY_ATOL[cfg.name]
    gen = torch.Generator(device=dev).manual_seed(LM_FAMILIES["seed"])
    t = time.perf_counter()
    params = transformer.init_params(cfg, gen, torch.bfloat16)
    sync()
    init_s = time.perf_counter() - t
    frames = torch.randn((B, c["enc_frames"], cfg.d_model), generator=gen, device=dev).to(
        torch.bfloat16)
    prompt = lm_family_prompt(cfg, B, S0, dev)
    t = time.perf_counter()
    enc_out = transformer.encode(cfg, params, enc_embeds=frames)
    sync()
    encode_s = time.perf_counter() - t
    enc = dict(enc_embeds=frames, enc_out=enc_out)
    lm_steps(cfg, params, prompt[:, :4], 2, enc=enc)  # warm-up

    dispatch.reset_launches()
    toks, logits, prefill_ms, step_ms, wall, _ = lm_steps(cfg, params, prompt, N, enc=enc)
    launches = dict(dispatch.LAUNCHES)
    want = 2 * cfg.n_layers * N
    check(launches.get("decode_attention", 0) == want,
          f"seamless: decode_attention launched {launches.get('decode_attention', 0)} times, "
          f"not {want} (self and cross)")
    check(logits.shape == (B, N + 1, cfg.vocab) and bool(torch.isfinite(logits).all()),
          "seamless: logits not finite or out of shape")
    stats = family_stats(B, N, prefill_ms, step_ms, wall)
    dispatch.reset_launches()
    _, plain_logits, _, plain_step_ms, _, caches = lm_steps(cfg, params, prompt, N, forced=toks,
                                                            plain=True, enc=enc)
    check(dispatch.LAUNCHES.get("decode_attention", 0) == 0, "seamless: the plain run launched")
    plain_err, pairs, plain_control, plain_steps = logit_check("seamless kernel vs plain", logits,
                                                  plain_logits, atol)
    full, _ = transformer.forward(cfg, params, tokens=torch.cat([prompt, toks], dim=1),
                                  enc_out=enc_out)
    full_err, _, full_control, full_steps = logit_check("seamless decode vs full forward", logits,
                                            full[:, S0 - 1:], atol)
    log(f"lm_families: seamless generate: prefill {prefill_ms:.1f} ms (with the encoder), decode "
        f"p50 {stats['decode_ms_p50']:.2f} ms, {want} launches; == plain over {pairs} pairs (max "
        f"{plain_err:.4f}), == full forward (max {full_err:.4f}; controls {plain_control:.2f}, "
        f"{full_control:.2f})")
    del full, plain_logits, logits
    # The kernel entries: layer 0's self-attention cache, and its
    # cross-attention's fresh K and V over the encoder's output (G = 1).
    g2 = torch.Generator(device=dev).manual_seed(64)
    qs = [torch.randn((B, cfg.n_heads, cfg.head_dim_), generator=g2, device=dev).to(
        torch.bfloat16) for _ in range(2)]
    cross = params.layers[0].cross
    Se = enc_out.shape[1]
    ck = (enc_out @ cross.wk.reshape(cfg.d_model, -1)).reshape(B, Se, cfg.n_kv_heads,
                                                               cfg.head_dim_)
    cv = (enc_out @ cross.wv.reshape(cfg.d_model, -1)).reshape(B, Se, cfg.n_kv_heads,
                                                               cfg.head_dim_)
    of = "decode_attention in the lm_families phase's seamless serve loop (self and cross)"
    entries = [
        attention_entry("decode_attention.seamless_self", qs[0], caches[0].k, caches[0].v,
                        S0 + N, ((0, S0 + 1), (5, S0 + N - 8)), want,
                        "seamless_m4t_large_v2 decode step, layer 0's live self-attention cache",
                        of),
        attention_entry("decode_attention.seamless_cross", qs[1], ck, cv, Se,
                        ((0, Se // 2 + 1), (100, Se - 24)), want,
                        "seamless_m4t_large_v2 decode step, layer 0's cross-attention over the "
                        "encoder's output (fresh K and V, G = 1)", of),
    ]
    n_params = sum(p.numel() for p in params.parameters())
    del params, caches, enc_out, frames, ck, cv
    torch.cuda.empty_cache()
    return dict(config=cfg.name, n_layers=cfg.n_layers, n_enc_layers=cfg.n_enc_layers,
                params=n_params, batch=B, prompt_len=S0, enc_frames=c["enc_frames"],
                new_tokens=N, init_s=init_s, encode_s=encode_s, **stats,
                plain_decode_ms_p50=float(np.percentile(plain_step_ms, 50)), launches=launches,
                logit_atol=atol, max_abs_logit_err_plain=plain_err, plain_pairs_compared=pairs,
                plain_control_err=plain_control, plain_err_by_step=plain_steps,
                max_abs_logit_err_full_forward=full_err, full_control_err=full_control,
                full_err_by_step=full_steps), entries


def measure_wide_attention(dev):
    """decode_attention's DP = 512 build (head_dim 257-512; no config of
    either package reaches it) at WIDE_ATTN, bf16, held against the plain
    version at the whole cache and at key ranges with NaN outside, timed
    beside its bound and SDPA."""
    c = WIDE_ATTN
    q, k, v = attention_inputs(c["B"], c["Hq"], c["Hkv"], c["D"], c["S"], torch.bfloat16, dev,
                               seed=512)
    entry = attention_entry("decode_attention.d512", q, k, v, c["S"],
                            ((0, c["S"] // 2 + 1), (37, c["S"] - 96)), 0,
                            "the D = 512 build (no config path: head_dim <= 256 everywhere)",
                            "no path: no config of either package has head_dim > 256")
    del q, k, v
    torch.cuda.empty_cache()
    return entry


def wide_attention_launch(q, k, v, softcap, end):
    """A zero-argument call of decode_attn_wide.cu's C entry over keys [0,
    end) on fixed buffers (no checks, allocation, count or dispatch), for
    kernel_ms; checked to launch once."""
    import ctypes
    import math

    from repro_torch.kernels import decode_attn
    from repro_torch.kernels.dispatch import c_function, cuda_stream_handle

    (B, Hq, D), (S, Hkv) = q.shape, k.shape[1:3]
    G = Hq // Hkv
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    nsplit = decode_attn.wide_split_count(B, end, Hkv, G, sms)
    ws = torch.empty((max(decode_attn.wide_workspace_floats(B, Hkv, G, D, nsplit), 1),),
                     dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    fn = c_function("decode_attn_wide", "decode_attn_wide_launch",
                    [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 8
                    + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ws.data_ptr(), ws.numel(),
            B, S, 0, end, Hkv, G, D, decode_attn.DTYPE_CODES[q.dtype, k.dtype],
            1.0 / math.sqrt(D), float(softcap), nsplit, cuda_stream_handle())
    check(fn(*args) == 0, "decode_attn_wide: the bare launch failed")
    return lambda buffers=(ws, out): fn(*args)


def measure_widest_attention(dev):
    """decode_attention past head_dim 512, on `decode_attn_wide.cu` (no
    config of either package reaches it) at WIDEST_ATTN, bf16 k and v: a
    bf16 and an f32 query, softcap 0 and 50, each held against the plain
    version at ATTN_TOL with its x1.01 control (the first also at key
    ranges with NaN outside) and timed beside its bound, the wrapper's call
    (ms) and the bare C launch (kernel_ms); SDPA at softcap 0. One kernels
    entry, the bf16 query without softcap; the other three under
    `variants`."""
    c = WIDEST_ATTN
    q, k, v = attention_inputs(c["B"], c["Hq"], c["Hkv"], c["D"], c["S"], torch.bfloat16, dev,
                               seed=1024)
    shape = "head_dim 1,024 on the wide source (no config path)"
    launches_of = "no path: no config of either package has head_dim > 512"
    entry = attention_entry("decode_attention.d1024", q, k, v, c["S"],
                            ((0, c["S"] // 2 + 1), (37, c["S"] - 96)), 0, shape, launches_of)
    entry["kernel_ms"] = cuda_ms(wide_attention_launch(q, k, v, 0.0, c["S"]), reps=50)
    entry["variants"] = {}
    for qt, softcap in ((torch.float32, 0.0), (torch.bfloat16, 50.0), (torch.float32, 50.0)):
        qv = q.to(qt)
        e = attention_entry("decode_attention.d1024", qv, k, v, c["S"], (), 0, shape,
                            launches_of, softcap=softcap)
        e["kernel_ms"] = cuda_ms(wide_attention_launch(qv, k, v, softcap, c["S"]), reps=50)
        entry["variants"][f"q {str(qt).replace('torch.', '')}, softcap {softcap:g}"] = {
            key: e[key] for key in ("max_abs_err", "over_limit", "control_over_limit", "ms",
                                    "kernel_ms", "plain_ms", "bound_ms", "library_ms", "limit")}
    log(f"decode_attention at head_dim {c['D']} (wide source): {entry['ms']:.4f} ms, bare "
        f"{entry['kernel_ms']:.4f} (bound {entry['bound_ms']:.4f}, SDPA "
        f"{entry['library_ms']:.4f}); variants "
        + str({k_: (round(v_["ms"], 4), round(v_["kernel_ms"], 4))
               for k_, v_ in entry["variants"].items()}))
    del q, k, v
    torch.cuda.empty_cache()
    return entry


# ------------------------------------------------------------- LM training


def train_flops(cfg, B, S, remat):
    """Operations of one train step (forward, backward, and with remat the
    layers' forward again): 6 per parameter and token (the tied embedding
    counted once, as the unembedding's product), the attention products
    (QK^T and PV over all S x S scores, as the port computes them masked) and
    the SSD's four products, each at 3x its forward, plus 1x for remat."""
    T = B * S
    P = cfg.num_params()
    P_layers = P - cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    attn = ssd = 0
    for layer in range(cfg.n_layers):
        if cfg.group[layer % len(cfg.group)].kind == "attn":
            attn += 4.0 * B * S * S * cfg.n_heads * cfg.head_dim_
        else:
            s = cfg.ssm
            nh, cl = s.expand * cfg.d_model // s.head_dim, min(s.chunk, S)
            nc = S // cl
            ssd += 2.0 * B * nc * (cl * cl * s.d_state + nh * cl * cl * s.head_dim
                                   + 2 * nh * cl * s.head_dim * s.d_state)
    fwd_layers = 2.0 * P_layers * T + attn + ssd
    return 6.0 * P * T + 3 * (attn + ssd) + (fwd_layers if remat else 0.0)


def train_full_width(name, n_steps, dev):
    """One config at its published widths, trained n_steps on one repeated
    batch (LM_TRAIN): every loss and grad norm finite, the last loss below
    the first, no kernel launched; ms a step (CUDA events), tokens/s,
    TFLOP/s against the f32 peak, peak memory."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, batch_at_step
    from repro_torch.kernels import dispatch
    from repro_torch.models import steps, transformer
    from repro_torch.optim.adam import AdamWConfig, init_opt_state

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get_config(name)
    B, S = LM_TRAIN["batch"], LM_TRAIN["seq"]
    t = time.perf_counter()
    params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(
        LM_TRAIN["seed"]), torch.float32)
    n_params = sum(p.numel() for p in params.parameters())
    opt = AdamWConfig(lr=LM_TRAIN["lr"], warmup_steps=1, total_steps=n_steps)
    state = init_opt_state(params, opt)
    batch = batch_at_step(DataConfig(cfg.vocab, S, B, seed=LM_TRAIN["seed"]), 0, device=dev)
    step_fn = steps.make_train_step(cfg, opt, remat=True)
    sync()
    init_s = time.perf_counter() - t
    dispatch.reset_launches()
    losses, norms, lrs, step_ms = [], [], [], []
    for _ in range(n_steps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        params, state, m = step_fn(params, state, batch)
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        lrs.append(float(m["lr"]))
    launches = dict(dispatch.LAUNCHES)
    check(sum(launches.values()) == 0, f"lm_train {name}: the training path launched {launches}")
    check(bool(np.isfinite(losses).all() and np.isfinite(norms).all()),
          f"lm_train {name}: a loss or grad norm is not finite: {losses} {norms}")
    check(losses[-1] < losses[0], f"lm_train {name}: the loss did not fall: {losses}")
    flops = train_flops(cfg, B, S, remat=True)
    p50 = float(np.percentile(step_ms, 50))
    out = dict(config=name, params=n_params, dtype="float32", batch=B, seq=S, steps=n_steps,
               remat=True, init_s=init_s, losses=losses, grad_norms=norms, lrs=lrs,
               step_ms=step_ms, step_ms_p50=p50, tokens_per_s=B * S / (p50 / 1e3),
               flops_per_step=flops, tflops_per_s=flops / (p50 / 1e3) / 1e12,
               floor_ms=1e3 * flops / F32_FLOPS, launches=launches,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"lm_train {name}: {n_params / 1e9:.3f} B f32 parameters, losses "
        f"{[round(x, 4) for x in losses]}, {p50:.1f} ms a step at p50 (floor "
        f"{out['floor_ms']:.0f} ms), {out['tflops_per_s']:.1f} TFLOP/s, peak "
        f"{out['peak_gb']:.1f} GB")
    del params, state, batch, step_fn
    torch.cuda.empty_cache()
    return out


class MarginSpy:
    """The least top-k margin (the k-th router logit less the next) of every
    MoE router call while entered (`models.moe.route`, patched)."""

    def __enter__(self):
        from repro_torch.models import moe

        self.least, self._real = float("inf"), moe.route

        def spy(cfg, router, xf):
            out = self._real(cfg, router, xf)
            top = torch.topk(out[0].detach(), cfg.moe.top_k + 1, dim=-1).values
            self.least = min(self.least, float((top[:, -2] - top[:, -1]).min()))
            return out

        moe.route = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route = self._real


def train_reduced_card_vs_cpu(dev):
    """Each of the ten configs at reduced_config: one train step (remat) on
    the card against the same step on the CPU, the same weights (drawn on
    the CPU, zero norms and biases replaced by seeded noise) and batch (the
    pipeline's, with seeded embeds for a frontend config and encoder frames
    for the encoder-decoder): the loss and the grad norm within their
    limits; no kernel launched on the card."""
    import copy

    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, batch_at_step
    from repro_torch.kernels import dispatch
    from repro_torch.models import steps, transformer
    from repro_torch.optim.adam import AdamWConfig, init_opt_state

    c = TRAIN_REDUCED
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    out, launches = {}, {}
    for name in configs.ARCHS:
        cfg = configs.reduced_config(name)
        base = transformer.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
        gen = torch.Generator().manual_seed(1)
        for t in base.parameters():
            if not t.any():
                t.data = 0.1 * torch.randn(t.shape, generator=gen)

        def batch_of(seed):
            b = batch_at_step(DataConfig(cfg.vocab, c["seq"], c["batch"], seed=seed), 0,
                              device="cpu")
            g = torch.Generator().manual_seed(seed + 100)
            if cfg.frontend:
                b["embeds"] = torch.randn((c["batch"], c["seq"], cfg.d_model), generator=g)
                del b["tokens"]
            if cfg.is_encdec:
                b["enc_embeds"] = torch.randn((c["batch"], c["enc_len"], cfg.d_model),
                                              generator=g)
            return b

        def one_step(device, batch):
            params = copy.deepcopy(base).to(device)
            state = init_opt_state(params, opt)
            fn = steps.make_train_step(cfg, opt, remat=True)
            params, state, m = fn(params, state, {k: v.to(device) for k, v in batch.items()})
            return float(m["loss"]), float(m["grad_norm"]), params

        for seed in range(8):
            batch = batch_of(seed)
            with MarginSpy() as spy:
                want = one_step("cpu", batch)
            if cfg.moe is None or spy.least > TRAIN_ROUTE_MARGIN:
                break
        check(cfg.moe is None or spy.least > TRAIN_ROUTE_MARGIN,
              f"lm_train {name}: no data seed with router margins above {TRAIN_ROUTE_MARGIN}")
        dispatch.reset_launches()
        got = one_step(dev, batch)
        sync()
        for k, v in dispatch.LAUNCHES.items():
            launches[k] = launches.get(k, 0) + v
        loss_err = abs(got[0] - want[0])
        norm_err = abs(got[1] - want[1]) / want[1]
        param_err = max(float((a.detach().cpu() - b.detach()).abs().max())
                        for a, b in zip(got[2].parameters(), want[2].parameters()))
        check(loss_err <= TRAIN_CARD_LOSS_ATOL and norm_err <= TRAIN_CARD_NORM_RTOL,
              f"lm_train {name}: card against CPU: loss {got[0]} vs {want[0]}, grad norm "
              f"{got[1]} vs {want[1]}")
        out[name] = dict(data_seed=seed, loss=got[0], loss_cpu=want[0], loss_err=loss_err,
                         grad_norm=got[1], grad_norm_cpu=want[1], grad_norm_rel_err=norm_err,
                         max_abs_param_err=param_err,
                         route_margin=None if cfg.moe is None else spy.least)
    check(sum(launches.values()) == 0, f"lm_train: the reduced configs launched {launches}")
    log(f"lm_train: ten reduced configs, card == CPU (max loss err "
        f"{max(r['loss_err'] for r in out.values()):.2e}, max grad-norm rel err "
        f"{max(r['grad_norm_rel_err'] for r in out.values()):.2e})")
    return out, launches


def start_train_resume(work: Path):
    """Start the resume check (module docstring, phase 8) in a process of
    its own (--resume-child), with CUBLAS_WORKSPACE_CONFIG set for it
    alone; `finish_train_resume` reads its result."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=RESUME_CUBLAS, PYTHONPATH=str(ROOT / "src"))
    log_file = open(work / "child.log", "w")
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--resume-child",
                             str(work)], env=env, stdout=log_file, stderr=subprocess.STDOUT)
    return proc, log_file, time.perf_counter()


def finish_train_resume(started, work: Path):
    """Wait for the resume child; its losses of steps 3-5 and its step-6
    checkpoint (parameters, both states, the step) equal the uninterrupted
    run's, bit for bit."""
    proc, log_file, t = started
    try:
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log_file.close()
    child_log = (work / "child.log").read_text()
    check(rc == 0 and (work / "resume.json").exists(),
          f"lm_train resume: the child exited {rc}:\n{child_log[-4000:]}")
    rec = json.loads((work / "resume.json").read_text())
    check(rec["resumed_losses"] == rec["losses"][3:],
          f"lm_train resume: losses {rec['resumed_losses']} differ from {rec['losses'][3:]}")
    check(not rec["differ"], f"lm_train resume: leaves differ at step 6: {rec['differ'][:5]}")
    check(rec["step"] == 6, "lm_train resume: the step-6 checkpoint's step")
    rec["wall_s"] = time.perf_counter() - t
    log(f"lm_train resume: preset small, 6 steps == 3 + resumed 3, bit for bit "
        f"({rec['leaves']} leaves, losses {[round(x, 4) for x in rec['losses']]}); ops without "
        f"a deterministic CUDA version: {rec['nondeterministic_ops'] or 'none'}; "
        f"{rec['wall_s']:.1f} s in its own process")
    return rec


def resume_child(work: Path) -> int:
    """The resume check's process: the launcher on the card in
    deterministic mode (warnings on, each op without a deterministic CUDA
    version named), TRAIN_RESUME once through with checkpoints at steps 3
    and 6, and once resumed from a directory holding only the step-3
    checkpoint; writes what it found to resume.json."""
    import contextlib
    import shutil
    import warnings

    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import train
    from repro_torch.models import transformer
    from repro_torch.optim.adam import AdamWConfig, init_opt_state

    check(os.environ.get("CUBLAS_WORKSPACE_CONFIG") == RESUME_CUBLAS,
          "the resume child needs CUBLAS_WORKSPACE_CONFIG set before cuBLAS starts")
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught, contextlib.redirect_stdout(sys.stderr):
        warnings.simplefilter("always")
        a, b = work / "a", work / "b"
        full = train.main(TRAIN_RESUME + ["--ckpt-dir", str(a)])
        b.mkdir()
        shutil.copytree(a / "step_00000003", b / "step_00000003")
        resumed = train.main(TRAIN_RESUME + ["--ckpt-dir", str(b), "--resume"])
        cfg = train.preset_config("small")
        # The checkpoints compared on the host, leaf by leaf.
        like_params = transformer.init_params(cfg, torch.Generator(), torch.float32)
        like = train.train_state(like_params, init_opt_state(like_params, AdamWConfig()))
        got, want = ckpt.restore(b, 6, like), ckpt.restore(a, 6, like)
        leaves = list(zip(ckpt._flatten_with_paths(got), ckpt._flatten_with_paths(want)))
        differ = [ka for (ka, x), (_, y) in leaves if not torch.equal(x, y)]
    nondet = sorted({str(w.message).split("\n")[0] for w in caught
                     if "deterministic" in str(w.message)})
    (work / "resume.json").write_text(json.dumps(dict(
        losses=full, resumed_losses=resumed, leaves=len(leaves), differ=differ,
        step=int(got["opt"]["step"]), nondeterministic_ops=nondet)))
    return 0


def phase_lm_train(dev):
    """The LM training path on the card (module docstring, phase 8).
    Returns its record; the launch counts of each run are zeroed just before
    it and read just after."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 1e9
    log(f"lm_train: {left:.2f} GB still allocated from the earlier phases")
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        # The resume child (a 12 M-parameter model, ~10 s with its start)
        # runs beside llama's first step, which the step's p50 leaves out.
        started = start_train_resume(Path(tmp))
        for name, n_steps in LM_TRAIN_MODELS:
            out[name] = train_full_width(name, n_steps, dev)
        out["reduced"], reduced_launches = train_reduced_card_vs_cpu(dev)
        out["resume"] = finish_train_resume(started, Path(tmp))
    launches = dict(reduced_launches)
    for name, _ in LM_TRAIN_MODELS:
        for k, v in out[name]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    out["allocated_at_start_gb"] = left
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"lm_train: phase {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------- the LM dry-run


def cell_tag(arch, shape, multi_pod, plan) -> str:
    return f"{arch}__{shape}__{'mp' if multi_pod else 'sp'}__{plan}"


def start_lm_dryrun_cells(work: Path):
    """Start the LM dry-run's fake cells in a process of their own (this
    script's --lm-dryrun-child): (process, its log file, start time)."""
    work.mkdir(parents=True, exist_ok=True)
    logf = open(work / "child.log", "w")
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--lm-dryrun-child", str(work)], stdout=logf,
                            stderr=subprocess.STDOUT)
    atexit.register(lambda: proc.poll() is None and proc.kill())  # a failed phase stops it
    log(f"lm_dryrun: the fake cells started in process {proc.pid}")
    return proc, logf, time.perf_counter()


def lm_dryrun_child(work: Path) -> int:
    """Each of LM_DRYRUN_CELLS through lower_cell on the card's device type:
    its record as <tag>.json, or its error as <tag>.FAIL (as the
    reference's dry-run writes them), and its wall in walls.json."""
    import traceback

    from repro_torch.launch import dryrun

    torch.cuda.set_device(0)
    walls = {}
    for arch, shape, multi_pod, plan in LM_DRYRUN_CELLS:
        tag = cell_tag(arch, shape, multi_pod, plan)
        t = time.perf_counter()
        try:
            rec, _, _, _ = dryrun.lower_cell(arch, shape, multi_pod=multi_pod, plan=plan)
            (work / f"{tag}.json").write_text(json.dumps(rec, indent=1))
        except Exception as e:  # the cell's failure is its result
            traceback.print_exc()
            (work / f"{tag}.FAIL").write_text(f"{type(e).__name__}: {e}")
        walls[tag] = time.perf_counter() - t
        print(f"{tag}: {walls[tag]:.1f} s", flush=True)
    (work / "walls.json").write_text(json.dumps(walls))
    return 0


class FirstAttention:
    """While entered, keeps the inputs and the output of the first
    decode_attention CUDA launch (`kernels.decode_attn._decode_attention_cuda`
    wrapped; the launch and its count as they were)."""

    def __enter__(self):
        from repro_torch.kernels import decode_attn

        self.first = None
        self._real = real = decode_attn._decode_attention_cuda

        def keep(q, k, v, softcap, start, end):
            out = real(q, k, v, softcap, start, end)
            if self.first is None:
                self.first = (q.clone(), k[:, start:end].clone(), v[:, start:end].clone(),
                              softcap, out.clone())
            return out

        decode_attn._decode_attention_cuda = keep
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import decode_attn

        decode_attn._decode_attention_cuda = self._real


def phase_lm_dryrun(dev, child, smi):
    """Phase 5c: the real rank-0 decode run here, then the fake cells'
    records from the child process. Returns the phase's record."""
    from repro_torch import configs
    from repro_torch.kernels import decode_attn, dispatch
    from repro_torch.launch import dryrun

    t_phase = time.perf_counter()
    real = dict(LM_DRYRUN_REAL)
    torch.cuda.empty_cache()
    dispatch.reset_launches()
    with FirstAttention() as first:
        run = dryrun.run_rank0(real["arch"], real["shape"], steps=real["steps"], device=dev,
                               seed=real["seed"])
    launches = dict(dispatch.LAUNCHES)
    n_layers = configs.get_config(real["arch"]).n_layers
    want = n_layers * real["steps"]
    check(launches.get("decode_attention", 0) == want,
          f"lm_dryrun: decode_attention launched {launches.get('decode_attention', 0)} times in "
          f"the rank-0 run, not {n_layers} layers x {real['steps']} steps = {want}")
    check(run["logits_finite"], "lm_dryrun: the rank-0 run's logits are not finite")
    q, k, v, softcap, got = first.first
    plain = decode_attn.decode_attention_plain(q, k, v, softcap=softcap).float()
    rtol, atol = ATTN_TOL[q.dtype]
    reading = dict(shape=dict(q=list(q.shape), k=list(k.shape)),
                   max_abs_err=float((got.float() - plain).abs().max()),
                   over_limit=over_limit(got.float(), plain, rtol, atol))
    check(reading["over_limit"] <= 1.0,
          f"lm_dryrun: the first decode_attention call differs from the plain version: {reading}")
    log(f"lm_dryrun real: rank 0 of p = 256, {real['arch']} x {real['shape']}, "
        f"{real['steps']} steps: decode_attention {want} launches; first call {reading}; "
        f"arguments {run['arg_bytes']} B on the card; peak {run['max_memory_allocated']} B; "
        f"step s {[round(x, 4) for x in run['step_s']]}")

    proc, logf, t_child = child
    try:
        code = proc.wait(timeout=max(1.0, LM_DRYRUN_CHILD_TIMEOUT
                                     - (time.perf_counter() - t_child)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise RuntimeError("lm_dryrun: the fake cells' process timed out")
    finally:
        logf.close()
    work = Path(logf.name).parent
    check(code == 0, f"lm_dryrun: the fake cells' process exited {code}:\n"
                     f"{(work / 'child.log').read_text()[-4000:]}")
    walls = json.loads((work / "walls.json").read_text())
    cells = {}
    for arch, shape, multi_pod, plan in LM_DRYRUN_CELLS:
        tag = cell_tag(arch, shape, multi_pod, plan)
        fail = work / f"{tag}.FAIL"
        check(not fail.exists(), f"lm_dryrun {tag} failed: "
                                 f"{fail.read_text()[:2000] if fail.exists() else ''}")
        rec = json.loads((work / f"{tag}.json").read_text())
        check(rec["raw_flops_uncorrected"] == rec["flops_per_device"] > 0
              and rec["arg_bytes"] > 0, f"lm_dryrun {tag}: record {rec}")
        cells[tag] = rec
        log(f"lm_dryrun {tag}: arg {rec['arg_bytes']} B, temp {rec['temp_bytes']} B, out "
            f"{rec['output_bytes']} B; {rec['flops_per_device']:.4e} FLOP, "
            f"{rec['hbm_bytes_per_device']:.4e} B, link {rec['link_bytes_per_device']:.4e} B "
            f"a device; {rec['bottleneck']} {rec['bound_s']:.4f} s; useful "
            f"{rec['useful_flops_frac']:.4f}; {walls[tag]:.1f} s")
    fake_decode = cells[cell_tag(real["arch"], real["shape"], False, "baseline")]
    check(fake_decode.get("arg_bytes") == run["arg_bytes"],
          f"lm_dryrun: the rank's {run['arg_bytes']} B on the card differ from the fake "
          f"record's arg_bytes {fake_decode.get('arg_bytes')}")
    real_rec = dict(real, launches=launches, first_call=reading, arg_bytes=run["arg_bytes"],
                    arg_bytes_equal_fake=True, max_memory_allocated=run["max_memory_allocated"],
                    fake_temp_bytes=fake_decode["temp_bytes"], step_s=run["step_s"],
                    start_pos=run["start_pos"], logits_local_shape=run["logits_local_shape"])
    out = dict(cells=cells, cell_walls_s=walls, real=real_rec,
               child_wall_s=time.perf_counter() - t_child, launches=launches,
               phase_s=time.perf_counter() - t_phase, card=smi)
    log(f"lm_dryrun: phase {out['phase_s']:.1f} s here, the child's cells "
        f"{sum(walls.values()):.1f} s beside the other phases")
    return out


# -------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full-log2-edges", type=int, default=26,
                    help="log2 of the full-width edge count (V stays 2^22)")
    ap.add_argument("--dist-child", type=Path, default=None,
                    help=argparse.SUPPRESS)  # one rank of the distributed phase's world of 2
    ap.add_argument("--resume-child", type=Path, default=None,
                    help=argparse.SUPPRESS)  # the lm_train phase's resume check
    ap.add_argument("--lm-dryrun-child", type=Path, default=None,
                    help=argparse.SUPPRESS)  # the lm_dryrun phase's fake cells
    ap.add_argument("--lm-only", action="store_true",
                    help="run the build, the LM dry-run and the three LM phases (serving, "
                         "families, training) alone (a quick check of those paths; the full "
                         "run is the script without flags)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside the repository)

    if args.dist_child is not None:
        return dist_child(args.dist_child)
    if args.resume_child is not None:
        return resume_child(args.resume_child)
    if args.lm_dryrun_child is not None:
        return lm_dryrun_child(args.lm_dryrun_child)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    analysis, bindings = phase_analysis(smi)
    pool = None
    if not args.lm_only:
        from concurrent.futures import ThreadPoolExecutor

        from repro_torch.graph.generate import rmat

        # The full-width R-MAT graph (host numpy, 4-5 minutes, set-up) is
        # generated in a thread beside phases 1-4, which wait on nvcc, the
        # card and their own host loops. It starts after the analysis phase,
        # host Python that it would slow.
        pool = ThreadPoolExecutor(max_workers=1)
        graph = pool.submit(timed, rmat, num_edges=1 << args.full_log2_edges, **FULL)
    child_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_lm_dryrun_"))
    lm_train = None
    try:
        build_s = phase_build()
        record = dict(card=smi, build_s=build_s)
        # The LM dry-run's fake cells run beside phases 2-5 (host work).
        lm_dryrun_child_proc = start_lm_dryrun_cells(child_dir)
        kernels = []
        if not args.lm_only:
            record["smoke_kernel_errors"] = phase_kernels(dev)
            record["pinned_s"], record["pinned_drivers"] = phase_pinned(dev)
            t = time.perf_counter()
            record["baselines"] = phase_baselines(dev)
            record["baselines_s"] = time.perf_counter() - t
            # The training phase needs no graph: it runs while the generation
            # thread ends (its figures are the card's: CUDA events a step).
            lm_train = phase_lm_train(dev)
            torch.cuda.empty_cache()
            record["commit_tiled"] = phase_commit_tiled(dev)
            record["full"], kernels = phase_full(dev, graph)
            next(e for e in kernels if e["name"] == "ebg_commit")["tiled"] = (
                record["commit_tiled"]["entries"])
    finally:
        if pool is not None:  # a failed phase leaves the generation to end on its own
            pool.shutdown(wait=False)
    if not args.lm_only:
        record["graph_dryrun"], dryrun_entry = phase_graph_dryrun(dev)
        for e in kernels:  # the dry-run path's launches beside the main path's
            e["dryrun_launches"] = record["graph_dryrun"]["launches"].get(e["name"], 0)
        kernels.append(dryrun_entry)
    record["lm_dryrun"] = phase_lm_dryrun(dev, lm_dryrun_child_proc, smi)
    shutil.rmtree(child_dir, ignore_errors=True)
    lm, lm_kernels = phase_lm(dev)
    for e in kernels:  # the LM path's launches beside the main path's
        e["lm_launches"] = lm["launches"].get(e["name"],
                                              lm["launches"].get(e["name"].split(".")[0], 0))
    kernels += lm_kernels
    for e in kernels:  # the LM dry-run's real rank-0 run
        e["lm_dryrun_launches"] = record["lm_dryrun"]["launches"].get(e["name"].split(".")[0], 0)
    families, family_kernels = phase_lm_families(dev)
    kernels += family_kernels
    for e in kernels:  # and the lm_families path's, model by model
        kernel = e["name"].split(".")[0]
        e["lm_families_launches"] = {name: rec["launches"].get(kernel, 0)
                                     for name, rec in families.items() if name != "phase_s"}
    if lm_train is None:  # --lm-only: last, as the other LM phases
        lm_train = phase_lm_train(dev)
    for e in kernels:  # the training path's: 0 for every kernel (checked in the phase)
        e["lm_train_launches"] = lm_train["launches"].get(e["name"].split(".")[0], 0)
    check_analysis_after(analysis, bindings, captured=not args.lm_only)
    total = time.perf_counter() - t0
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(dict(
        record, analysis=analysis, lm=lm, lm_families=families, lm_train=lm_train,
        kernels=kernels, total_s=total), indent=1))
    log(f"all phases passed in {total:.1f} s")

    print(smi)
    print(json.dumps({"analysis": analysis}))
    if "full" in record:
        serve = record["full"]["serve"]
        print(json.dumps({"serve": {k: serve[k] for k in (
            "queries", "wall_s", "throughput_qps", "latency_p50_s", "latency_p99_s", "batches",
            "mean_batch", "padding_waste", "supersteps_mean", "cache", "resilience",
            "capture_s")}}))
    if "graph_dryrun" in record:
        print(json.dumps({"graph_dryrun": dict(record["graph_dryrun"], card=smi)}))
    print(json.dumps({"lm_dryrun": lm_dryrun_line(record["lm_dryrun"])}))
    print(json.dumps({"lm_serve": lm_line(lm, smi)}))
    print(json.dumps({"lm_families": families_line(families, smi)}))
    print(json.dumps({"lm_train": train_line(lm_train, smi, total)}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


def lm_dryrun_line(rec):
    """The {"lm_dryrun": ...} stdout line: each fake cell's figures (or
    its failure) and the real rank-0 run."""
    keys = ("arg_bytes", "temp_bytes", "output_bytes", "flops_per_device",
            "hbm_bytes_per_device", "link_bytes_per_device", "model_flops_per_device",
            "useful_flops_frac", "bottleneck", "bound_s", "compute_s", "memory_s",
            "collective_s", "compile_s")
    cells = {tag: ({k: c[k] for k in keys} | {"collectives": c["collectives"]}
                   if "FAIL" not in c else c) for tag, c in rec["cells"].items()}
    real = {k: v for k, v in rec["real"].items() if k != "launches"}
    return dict(cells=cells, real=real, launches=rec["launches"], phase_s=rec["phase_s"],
                child_wall_s=rec["child_wall_s"], card=rec["card"])


def lm_line(lm, smi):
    """The {"lm_serve": ...} stdout line."""
    keys = ("config", "batch", "prompt_len", "new_tokens", "prefill_s", "decode_ms_p50",
            "decode_ms_p99", "tokens_per_s", "tokens_per_s_with_prefill",
            "max_abs_logit_err_plain", "max_abs_logit_err_full_forward", "logit_atol",
            "phase_s")
    return dict({k: lm[k] for k in keys}, launches=lm["launches"].get("decode_attention", 0),
                card=smi)


def train_line(rec, smi, total):
    """The {"lm_train": ...} stdout line: each full-width model's losses and
    speed, the reduced configs' largest card-against-CPU errors, the resume,
    the launches, the phase's wall and the script's."""
    keys = ("params", "batch", "seq", "steps", "losses", "grad_norms", "step_ms_p50",
            "tokens_per_s", "tflops_per_s", "floor_ms", "peak_gb")
    out = {name: {k: rec[name][k] for k in keys} for name, _ in LM_TRAIN_MODELS}
    red = rec["reduced"]
    out["reduced_card_vs_cpu"] = dict(
        configs=len(red), max_loss_err=max(r["loss_err"] for r in red.values()),
        max_grad_norm_rel_err=max(r["grad_norm_rel_err"] for r in red.values()),
        loss_atol=TRAIN_CARD_LOSS_ATOL, grad_norm_rtol=TRAIN_CARD_NORM_RTOL)
    out["resume_bit_for_bit"] = dict(leaves=rec["resume"]["leaves"],
                                     nondeterministic_ops=rec["resume"]["nondeterministic_ops"])
    return dict(out, launches=rec["launches"], phase_s=rec["phase_s"], total_s=total, card=smi)


def families_line(families, smi):
    """The {"lm_families": ...} stdout line: a model's speed, launches and
    its largest logit errors against its limit."""
    keys = ("n_layers", "prefill_s", "decode_ms_p50", "decode_ms_p99", "tokens_per_s",
            "peak_gb", "logit_atol", "max_abs_logit_err_plain", "max_abs_logit_err_full_forward")
    out = {name: dict({k: rec[k] for k in keys if k in rec},
                      launches=rec["launches"].get("decode_attention", 0))
           for name, rec in families.items() if name != "phase_s"}
    return dict(out, phase_s=families["phase_s"], card=smi)


if __name__ == "__main__":
    sys.exit(main())
