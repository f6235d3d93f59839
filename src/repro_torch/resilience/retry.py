"""Bounded retry with deterministic backoff, and the circuit breaker
driving graceful backend degradation.

(The port's own copy of `repro.resilience.retry`.) `RetryPolicy` is
frozen and pure: the exponential backoff jitter is a seeded draw keyed on
(seed, token), so a replayed trace charges the exact same waits to the
virtual clock. `CircuitBreaker` is the one deliberately stateful piece:
it counts consecutive failures per serving process and walks a
degradation ladder, in the port

    level 0: ("kernel", batched fused loop)   — fastest
    level 1: ("kernel", per-query host driver) — simplest

both on the pipeline's device (the port has no compute backend to drop
to: the reference's ladder is (backend, batch) → ("xla", batch) →
("xla", host)). Every level computes bit-identical results — the driver
parity suites pin fused≡host and batch≡singles — so degradation trades
latency, never answers. Transitions are logged on
`repro_torch.resilience` and recorded on `.transitions` for reports; recovery
is probe-based: after `probe_after` consecutive successes at a degraded
level the next batch probes one level up, and a probe success promotes.
"""
from __future__ import annotations

import dataclasses
import logging

from repro_torch.resilience.faults import FaultPlan

log = logging.getLogger("repro_torch.resilience")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with deterministic jitter.

    delay(attempt) = base_delay_s * multiplier**attempt * (1 + jitter*u)
    where u is a pure [0,1) draw keyed on (seed, token) — replayable."""

    max_retries: int = 3
    base_delay_s: float = 0.002
    multiplier: float = 2.0
    jitter: float = 0.1

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"RetryPolicy.max_retries must be >= 0, got {self.max_retries!r}")
        if self.base_delay_s < 0:
            raise ValueError(f"RetryPolicy.base_delay_s must be >= 0, got {self.base_delay_s!r}")
        if self.multiplier < 1.0:
            raise ValueError(f"RetryPolicy.multiplier must be >= 1, got {self.multiplier!r}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"RetryPolicy.jitter must be in [0, 1], got {self.jitter!r}")

    def backoff_s(self, attempt: int, *, seed: int = 0, token: int = 0) -> float:
        """Seconds to wait before retry number `attempt` (0-based).
        `token` disambiguates concurrent backoff series under one seed
        (the server passes its global attempt counter)."""
        u = FaultPlan(seed=seed).draw("backoff", token)
        return float(self.base_delay_s * (self.multiplier ** int(attempt)) * (1.0 + self.jitter * u))


class CircuitBreaker:
    """Consecutive-failure breaker over a fixed degradation ladder.

    `level` indexes the ladder (0 = full speed). `threshold` consecutive
    failures degrade one level; `probe_after` consecutive successes at a
    degraded level arm a probe of the level above, and a probe success
    promotes back up (a probe failure stays put without re-degrading)."""

    def __init__(self, *, threshold: int = 3, max_level: int = 1, probe_after: int = 2):
        if threshold < 1:
            raise ValueError(f"CircuitBreaker.threshold must be >= 1, got {threshold!r}")
        if max_level < 0:
            raise ValueError(f"CircuitBreaker.max_level must be >= 0, got {max_level!r}")
        if probe_after < 1:
            raise ValueError(f"CircuitBreaker.probe_after must be >= 1, got {probe_after!r}")
        self.threshold = int(threshold)
        self.max_level = int(max_level)
        self.probe_after = int(probe_after)
        self.level = 0
        self.transitions: list[tuple[str, int, int]] = []  # (kind, from, to)
        self._failures = 0
        self._successes = 0

    def should_probe(self) -> bool:
        """Whether the next execution should probe one level up."""
        return self.level > 0 and self._successes >= self.probe_after

    def record_failure(self, *, probe: bool = False) -> None:
        self._successes = 0
        if probe:
            # A failed probe proves the upper level is still broken; the
            # current level keeps working, so don't degrade further.
            log.info("circuit breaker: probe of level %d failed, staying at %d",
                     self.level - 1, self.level)
            return
        self._failures += 1
        if self._failures >= self.threshold and self.level < self.max_level:
            old = self.level
            self.level += 1
            self._failures = 0
            self.transitions.append(("degrade", old, self.level))
            log.warning(
                "circuit breaker: %d consecutive failures, degrading level %d -> %d",
                self.threshold, old, self.level,
            )

    def record_success(self, *, probe: bool = False) -> None:
        self._failures = 0
        if probe and self.level > 0:
            old = self.level
            self.level -= 1
            self._successes = 0
            self.transitions.append(("recover", old, self.level))
            log.info("circuit breaker: probe succeeded, recovering level %d -> %d",
                     old, self.level)
        else:
            self._successes += 1
