"""repro_torch.resilience — deterministic fault injection, superstep
checkpoint/resume, and the retry/backoff/circuit-breaker vocabulary the
serving tier degrades with (port of `repro.resilience`).

  * `FaultPlan` — a seeded, frozen chaos schedule (worker crash at
    superstep s, transient backend errors, stragglers, malformed
    batches); every draw is a pure function of (seed, stream, index), the
    reference's draws for the same seed, so scenarios replay bit for bit.
  * `run_bsp_resilient` / `resume_bsp` — segmented BSP execution on the
    fused loop (a CUDA graph on the card) or the host driver that
    snapshots the value carry + stats through
    `repro_torch.checkpoint.ckpt` and recovers from an injected crash to
    a final state bit-identical to an uninterrupted run. Reached from
    `run_bsp(..., checkpoint_every=k, ckpt_dir=...)` and therefore from
    `GraphPipeline.run`. Checkpoints move between this package and the
    reference in both directions.
  * `RetryPolicy` / `CircuitBreaker` — bounded retry with deterministic
    backoff jitter and consecutive-failure degradation (batched fused
    loop -> per-query host driver) wired into `GraphQueryServer`.
"""
from repro_torch.resilience.bsp import resume_bsp, run_bsp_resilient
from repro_torch.resilience.faults import (
    FaultError,
    FaultPlan,
    LoadShedError,
    MalformedBatchError,
    TransientBackendError,
    WorkerCrashError,
)
from repro_torch.resilience.retry import CircuitBreaker, RetryPolicy

__all__ = [
    "CircuitBreaker",
    "FaultError",
    "FaultPlan",
    "LoadShedError",
    "MalformedBatchError",
    "RetryPolicy",
    "TransientBackendError",
    "WorkerCrashError",
    "resume_bsp",
    "run_bsp_resilient",
]
