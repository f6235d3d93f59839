"""Deterministic fault injection: a seeded `FaultPlan` plus the named
error vocabulary the fault-tolerant drivers raise (the port's own copy of
`repro.resilience.faults`; its draws are the reference's for the same
seed, stream and index).

Failure is a first-class, replayable INPUT here, not an accident: every
fault draw is a pure function of (seed, stream name, draw index), so a
chaos scenario replays bit-for-bit from its seed — no wall-clock or
process-state nondeterminism (clocks come from the serving tier's
explicit virtual time). Stream names are hashed with crc32, NOT Python's
`hash()` (which is salted by PYTHONHASHSEED and would break replay
across processes).

The plan vocabulary:

  * crash_at_superstep s  — the BSP run dies when about to execute
    superstep s (0-based: exactly s supersteps complete first), raising
    `WorkerCrashError`; `resume_bsp` (resilience/bsp.py) continues from
    the run's last checkpoint.
  * transient_error_prob q — an execution attempt in the serving tier
    fails with `TransientBackendError` with probability q, optionally
    targeted at one compute backend / driver path (so degradation to
    another level genuinely clears the fault). `max_transient_faults`
    bounds the total injected count — the deterministic way to script
    "fail twice, then succeed".
  * straggler_delay_s / straggler_prob — a micro-batch is charged an
    extra latency before executing (results unchanged; only time moves).
  * malformed_batch_prob — a micro-batch arrives corrupted and must be
    re-formed (`MalformedBatchError`, retryable).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import numpy as np


class FaultError(RuntimeError):
    """Base of every injected/named fault raised by repro_torch.resilience."""


class WorkerCrashError(FaultError):
    """A BSP worker died; `superstep` counts the supersteps that
    completed before the crash. `ckpt_dir` (when checkpointing was on)
    names where a resumed run can pick it back up."""

    def __init__(self, superstep: int, ckpt_dir=None):
        self.superstep = int(superstep)
        self.ckpt_dir = ckpt_dir
        where = f" (resume from {ckpt_dir})" if ckpt_dir is not None else ""
        super().__init__(
            f"worker crashed after completing superstep {superstep}{where}"
        )


class TransientBackendError(FaultError):
    """A retryable backend failure (the injected stand-in for a flaky
    device, a preempted worker, or a lost RPC)."""


class MalformedBatchError(FaultError):
    """A message micro-batch arrived corrupted; re-forming it (a retry)
    clears the fault."""


class LoadShedError(FaultError):
    """Admission rejected a query: the bounded queue is full
    (reject-newest policy)."""


def _stream_entropy(stream: str) -> int:
    # crc32, not hash(): PYTHONHASHSEED salts str hashing per process,
    # which would make "deterministic" fault schedules unreplayable.
    return zlib.crc32(stream.encode("utf-8"))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Frozen, seeded chaos schedule. Every method is a pure function of
    (seed, stream, index) — calling it twice with the same arguments
    returns the same answer, and two plans with the same seed are the
    same plan."""

    seed: int = 0
    crash_at_superstep: Optional[int] = None
    transient_error_prob: float = 0.0
    max_transient_faults: Optional[int] = None
    transient_target_backend: Optional[str] = None
    transient_target_driver: Optional[str] = None  # "batch" | "host"
    straggler_prob: float = 0.0
    straggler_delay_s: float = 0.0
    malformed_batch_prob: float = 0.0

    def __post_init__(self):
        for name in ("transient_error_prob", "straggler_prob", "malformed_batch_prob"):
            v = getattr(self, name)
            if not 0.0 <= float(v) <= 1.0:
                raise ValueError(f"FaultPlan.{name} must be in [0, 1], got {v!r}")
        if self.crash_at_superstep is not None and int(self.crash_at_superstep) < 0:
            raise ValueError(
                f"FaultPlan.crash_at_superstep must be >= 0, got {self.crash_at_superstep!r}"
            )
        if self.straggler_delay_s < 0:
            raise ValueError(
                f"FaultPlan.straggler_delay_s must be >= 0, got {self.straggler_delay_s!r}"
            )
        if self.max_transient_faults is not None and int(self.max_transient_faults) < 0:
            raise ValueError(
                f"FaultPlan.max_transient_faults must be >= 0, got {self.max_transient_faults!r}"
            )

    # ------------------------------------------------------------- draws

    def draw(self, stream: str, index: int) -> float:
        """Uniform [0, 1) draw `index` of `stream` — pure and replayable."""
        ss = np.random.SeedSequence((int(self.seed), _stream_entropy(stream), int(index)))
        return float(np.random.default_rng(ss).random())

    # ---------------------------------------------------------- schedule

    def should_crash(self, superstep: int) -> bool:
        """True when the run is about to execute the doomed superstep
        (i.e. `superstep` supersteps have already completed)."""
        return self.crash_at_superstep is not None and int(superstep) >= int(
            self.crash_at_superstep
        )

    def transient_fault(
        self, attempt: int, *, backend: Optional[str] = None, driver: Optional[str] = None
    ) -> bool:
        """Whether execution attempt `attempt` (a global counter the
        caller advances per attempt) fails with a transient error. A
        targeted plan only faults the named compute backend / driver
        path, so degrading away from the target genuinely recovers."""
        if self.transient_error_prob <= 0.0:
            return False
        if self.transient_target_backend is not None and backend != self.transient_target_backend:
            return False
        if self.transient_target_driver is not None and driver != self.transient_target_driver:
            return False
        if self.max_transient_faults is not None:
            # Count prior faults of this stream deterministically: the
            # draws are pure, so replaying them IS the fault ledger.
            fired = sum(
                1 for i in range(int(attempt))
                if self.draw("transient", i) < self.transient_error_prob
            )
            if fired >= int(self.max_transient_faults):
                return False
        return self.draw("transient", attempt) < self.transient_error_prob

    def malformed_batch(self, attempt: int) -> bool:
        if self.malformed_batch_prob <= 0.0:
            return False
        return self.draw("malformed", attempt) < self.malformed_batch_prob

    def straggler_delay(self, batch_index: int) -> float:
        """Extra seconds charged to the batch's clock (0.0 = no straggler)."""
        if self.straggler_prob <= 0.0 or self.straggler_delay_s <= 0.0:
            return 0.0
        if self.draw("straggler", batch_index) < self.straggler_prob:
            return float(self.straggler_delay_s)
        return 0.0
