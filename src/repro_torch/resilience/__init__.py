"""repro_torch.resilience — deterministic fault injection and the
retry/backoff/circuit-breaker vocabulary the serving tier degrades with
(port of `repro.resilience`; the checkpointed BSP driver, `bsp.py`, is
not ported yet).

  * `FaultPlan` — a seeded, frozen chaos schedule (worker crash at
    superstep s, transient backend errors, stragglers, malformed
    batches); every draw is a pure function of (seed, stream, index), the
    reference's draws for the same seed, so scenarios replay bit for bit.
  * `RetryPolicy` / `CircuitBreaker` — bounded retry with deterministic
    backoff jitter and consecutive-failure degradation (batched fused
    loop -> per-query host driver) wired into `GraphQueryServer`.
"""
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
]
