"""Superstep checkpoint/resume for the BSP engine (port of
`repro.resilience.bsp`): segmented execution with bit-identical recovery.

`run_bsp_resilient` runs the SAME programs as `engine.run_bsp` (it is
what `run_bsp(..., checkpoint_every=k, ckpt_dir=...)` delegates to) but
drives the loop in segments: every `checkpoint_every` supersteps the
value carry plus the per-step `BSPStats` rows are snapshotted through
`repro_torch.checkpoint.ckpt`, and an injected `FaultPlan` crash kills
the run with a `WorkerCrashError`. `resume_bsp` restores the latest
checkpoint and continues — final values AND stats are bit-identical to
an uninterrupted run, on either driver.

A segment is `engine._run_segment`, the same runner a whole run of
either driver is: on the fused driver one run of the cached loop
(`engine._fused_loop` with max_supersteps = the segment's length), on
the card a replay of its captured CUDA graph, with the carry, counters
and stats on the device and one host read of them a segment; on the
host driver its loop (`engine._host_steps`) started at the segment's
first superstep. Between segments the carry stays on the
device; a snapshot copies it to the host.

Why segments compose exactly: with exchange_period=1 the delta-message
reference is always the step's entry value, so a step's counts depend
only on the state it starts from; with bounded staleness (period > 1)
checkpoints fall on exchange-period boundaries
(`checkpoint_every % exchange_period == 0`), where the last step
exchanged and the last-exchanged snapshot IS the value. The fused loop
returns each query's converged flag, so a run that converges exactly on
a segment boundary stops instead of paying a phantom superstep.

Checkpoints hold EXEC-domain values in the reference's dtypes: int32
programs as int32 (the kernels' f32 view is converted back; the map is a
bijection on every value that occurs), max-combine programs negated, and
two-level label programs rank-encoded, with the codec's table in
`codec_uniq`. A side `resume.json` records the program, the driver, the
engine knobs and a subgraph fingerprint, with the reference's keys:
`compute_backend` is written as "ref" — the reference's name for its
kernel path, whose plain oracle the port's kernels hold to — and read
but not used (the port has one local stage). A checkpoint written by
either package resumes in the other.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.graph import engine
from repro_torch.resilience.faults import FaultPlan, WorkerCrashError

RESUME_META = "resume.json"
# What `resume.json` calls the port's local stage (the reference's kernel
# path; see the module docstring).
COMPUTE_BACKEND = "ref"


@dataclasses.dataclass
class _SegState:
    """The carry between segments (and across crash/resume)."""

    val: torch.Tensor  # [p, max_v+1] f32 exec values on the run's device
    # (rank-encoded when a two-level label run carries a codec)
    int32: bool  # the program's values are int32 (snapshots store them so)
    done: int  # supersteps completed
    msgs: list  # [k, p] int64 per-segment message blocks
    iters: list  # [k, p] int64 per-segment inner-iteration blocks
    converged: bool
    codec: object = None  # engine._ValueCodec for two-level label programs

    def stack(self, p: int) -> tuple[np.ndarray, np.ndarray]:
        if not self.msgs:
            z = np.zeros((0, p), np.int64)
            return z, z.copy()
        return np.concatenate(self.msgs, axis=0), np.concatenate(self.iters, axis=0)


def _sub_fingerprint(sub) -> dict:
    return {
        "num_parts": int(sub.num_parts),
        "max_v": int(sub.max_v),
        "max_e": int(sub.max_e),
        "max_msg": int(sub.max_msg),
        "addressing": str(sub.addressing),
    }


def _ckpt_tree(state: _SegState, p: int) -> dict:
    msgs, iters = state.stack(p)
    val = engine._to_i32(state.val) if state.int32 else state.val
    # The rank codec's table rides in the snapshot: the carry holds ENCODED
    # values, and the codec may have been built from a caller-supplied
    # init_val that resume cannot re-derive.
    table = state.codec.table if state.codec is not None else torch.zeros((0,), dtype=torch.int32)
    return {
        "val": val.cpu().numpy(),
        "msgs": msgs,
        "iters": iters,
        "converged": np.int32(state.converged),
        "codec_uniq": table.cpu().numpy().astype(np.int32),
    }


def _write_meta(ckpt_dir, sub, prog, knobs: dict) -> None:
    meta = {"program": prog.name, "sub": _sub_fingerprint(sub), **knobs}
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    (d / RESUME_META).write_text(json.dumps(meta, indent=2))


def _run_segments(sub, prog, exec_prog, negate, state: _SegState, *, max_supersteps,
                  inner_cap, exchange_period, tol, num_vertices, driver, checkpoint_every,
                  ckpt_dir, fault_plan, block_e=512):
    p = sub.num_parts
    crash_at = None
    if fault_plan is not None and fault_plan.crash_at_superstep is not None:
        crash_at = int(fault_plan.crash_at_superstep)
    if checkpoint_every and ckpt_dir is not None and state.done == 0:
        ckpt.save(ckpt_dir, 0, _ckpt_tree(state, p))

    while not state.converged and state.done < max_supersteps:
        if crash_at is not None and state.done >= crash_at:
            # The doomed superstep is due: the worker dies before it can
            # complete (everything since the last checkpoint is lost —
            # resume_bsp recomputes it bit-identically).
            raise WorkerCrashError(superstep=state.done, ckpt_dir=ckpt_dir)
        stop = max_supersteps
        if checkpoint_every:
            stop = min(stop, (state.done // checkpoint_every + 1) * checkpoint_every)
        if crash_at is not None:
            stop = min(stop, crash_at)
        # Segment boundaries are exchange-period boundaries, so the value IS
        # the last-exchanged snapshot the delta counter references.
        state.val, msgs, iters, _, steps, state.converged = engine._run_segment(
            driver, exec_prog, sub, state.val, start=state.done, count=stop - state.done,
            inner_cap=inner_cap, exchange_period=exchange_period, tol=tol,
            num_vertices=num_vertices, block_e=block_e,
        )
        state.msgs.append(msgs)
        state.iters.append(iters)
        state.done += steps
        if checkpoint_every and ckpt_dir is not None and state.done % checkpoint_every == 0:
            ckpt.save(ckpt_dir, state.done, _ckpt_tree(state, p))

    msgs_sw, iters_sw = state.stack(p)
    edges = sub.edge_mask.sum(dim=1).cpu().numpy().astype(np.int64)
    stats = engine._assemble_stats(state.done, msgs_sw, iters_sw, edges)
    return engine._from_exec(prog, state.val, negate, state.codec), stats


def _check_ft_args(checkpoint_every, ckpt_dir, exchange_period) -> None:
    if checkpoint_every is not None:
        if int(checkpoint_every) < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every!r}")
        if ckpt_dir is None:
            raise ValueError("checkpoint_every needs ckpt_dir= (where snapshots go)")
        if int(checkpoint_every) % int(exchange_period) != 0:
            raise ValueError(
                f"checkpoint_every={checkpoint_every} must be a multiple of "
                f"exchange_period={exchange_period}: segments only compose exactly "
                "at exchange boundaries (the delta-message reference is the "
                "exchanged snapshot)"
            )
    elif ckpt_dir is not None:
        raise ValueError("ckpt_dir needs checkpoint_every= (snapshot cadence)")


def run_bsp_resilient(
    sub,
    program,
    init_val=None,
    *,
    max_supersteps: Optional[int] = None,
    inner_cap: int = 10_000,
    exchange_period: int = 1,
    tol: float = 0.0,
    num_vertices: int = 0,
    source=None,
    driver: str = "fused",
    block_e: int = 512,
    checkpoint_every: Optional[int] = None,
    ckpt_dir=None,
    fault_plan: Optional[FaultPlan] = None,
):
    """`engine.run_bsp` with superstep checkpointing and deterministic
    fault injection — the same (values, BSPStats) contract and results,
    bit for bit (the loop runs in composable segments). Raises
    `WorkerCrashError` when the fault plan's crash comes due; `resume_bsp`
    continues from the last checkpoint in `ckpt_dir`."""
    prog = engine.get_program(program)
    engine.check_int32_kernel_labels(prog, sub)
    engine.check_pagerank_num_vertices(prog, num_vertices)
    engine.check_driver(driver)
    _check_ft_args(checkpoint_every, ckpt_dir, exchange_period)
    if max_supersteps is None:
        max_supersteps = prog.default_steps or 200
    engine._check_staleness(prog, exchange_period)
    # The run_bsp boundary: negation, the two-level codec (so every
    # checkpoint holds kernel-ready values) and the kernels' f32 view.
    exec_prog, val, negate, codec = engine._exec_values(prog, sub, init_val, num_vertices,
                                                        source)
    state = _SegState(val=val, int32=prog.dtype == "int32", done=0, msgs=[], iters=[],
                      converged=False, codec=codec)
    if checkpoint_every and ckpt_dir is not None:
        _write_meta(ckpt_dir, sub, prog, {
            "driver": driver, "compute_backend": COMPUTE_BACKEND,
            "max_supersteps": int(max_supersteps), "inner_cap": int(inner_cap),
            "exchange_period": int(exchange_period), "tol": float(tol),
            "num_vertices": int(num_vertices), "checkpoint_every": int(checkpoint_every),
            "block_e": int(block_e),
        })
    return _run_segments(
        sub, prog, exec_prog, negate, state, max_supersteps=max_supersteps,
        inner_cap=inner_cap, exchange_period=exchange_period, tol=tol,
        num_vertices=num_vertices, driver=driver, checkpoint_every=checkpoint_every,
        ckpt_dir=ckpt_dir, fault_plan=fault_plan, block_e=block_e,
    )


def resume_bsp(
    sub,
    *,
    ckpt_dir,
    driver: Optional[str] = None,
    fault_plan: Optional[FaultPlan] = None,
):
    """Restore the latest checkpoint in `ckpt_dir` and run the BSP loop to
    completion on the device of `sub`. Returns (values,
    BSPStats) bit-identical to the uninterrupted run — including the stats
    of the supersteps that ran BEFORE the crash (they are part of the
    snapshot).

    `driver` defaults to the crashed run's but may be overridden (the two
    drivers are bit for bit equal — e.g. resume on the host driver after
    a fused-path crash). The snapshot may come from the reference's
    `run_bsp_resilient` on any of its backends."""
    d = Path(ckpt_dir)
    meta_path = d / RESUME_META
    if not meta_path.exists():
        raise FileNotFoundError(
            f"no {RESUME_META} in {d} — was this run started with checkpoint_every=/ckpt_dir=?"
        )
    meta = json.loads(meta_path.read_text())
    prog = engine.get_program(meta["program"])
    engine.check_int32_kernel_labels(prog, sub)
    drv = engine.check_driver(meta["driver"] if driver is None else driver)
    fp = _sub_fingerprint(sub)
    if fp != meta["sub"]:
        raise ValueError(
            f"checkpoint in {d} was written for a different build: "
            f"checkpoint {meta['sub']} vs this SubgraphSet {fp}"
        )
    step = ckpt.latest_step(d)
    if step is None:
        raise FileNotFoundError(f"no published checkpoint under {d}")
    exec_prog, negate = engine._exec_view(prog)
    p = sub.num_parts
    dt = torch.int32 if prog.dtype == "int32" else torch.float32
    like = {
        "val": torch.zeros((0,), dtype=dt, device=sub.device),
        "msgs": np.zeros((0, 0), np.int64),
        "iters": np.zeros((0, 0), np.int64),
        "converged": np.int32(0),
        "codec_uniq": torch.zeros((0,), dtype=torch.int32, device=sub.device),
    }
    tree = ckpt.restore(d, step, like)
    val, table = tree["val"], tree["codec_uniq"]
    if val.shape[0] != p:
        raise ValueError(f"checkpoint value carry has {val.shape[0]} workers, build has {p}")
    if table.numel():
        codec = engine._ValueCodec(table=table)
    else:
        # No codec rode along (a reference run on its exact "xla" backend,
        # or BFS-style unit-weight carries): the restored exec values cross
        # the kernels' value boundary here, as a fresh run's init does — a
        # label program is rank-encoded over the labels it still holds
        # (every later value is one of them), the rest are bound-checked.
        val, codec = engine._kernel_value_boundary(prog, sub, val)
    if prog.dtype == "int32":
        val = engine._to_f32(val)
    state = _SegState(
        val=val.contiguous(), int32=prog.dtype == "int32", done=int(step),
        msgs=[np.asarray(tree["msgs"], np.int64).reshape(-1, p)],
        iters=[np.asarray(tree["iters"], np.int64).reshape(-1, p)],
        converged=bool(int(tree["converged"])), codec=codec,
    )
    return _run_segments(
        sub, prog, exec_prog, negate, state,
        max_supersteps=int(meta["max_supersteps"]), inner_cap=int(meta["inner_cap"]),
        exchange_period=int(meta["exchange_period"]), tol=float(meta["tol"]),
        num_vertices=int(meta["num_vertices"]), driver=drv,
        checkpoint_every=int(meta["checkpoint_every"]), ckpt_dir=d, fault_plan=fault_plan,
        block_e=int(meta.get("block_e", 512)),
    )
