"""Admission queue + micro-batching flush policy for the query server
(port of `repro.serve.queue`).

Each registered program gets one lane; a query joins its program's lane
at admission. A lane flushes as a micro-batch when either

  * it holds `max_batch` queries (FULL flush — fires immediately on the
    admission that filled it), or
  * its oldest query has waited `max_delay_s` (DEADLINE flush — bounds
    the queue latency a lone query can pay waiting for batch-mates).

This is the standard throughput-vs-latency knob pair of batched serving;
the server pads each flushed batch to its bucket
(`repro_torch.serve.padding`) before execution.

`max_queue` bounds the total queued backlog: admission past the bound is
load-shed with a named `LoadShedError` (reject-newest — queued queries
keep their place; the arriving one is refused). The server records the
shed query as a `QueryFailure` instead of letting the backlog grow
without bound under overload.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.resilience.faults import LoadShedError


@dataclasses.dataclass(frozen=True)
class Query:
    """One admitted point query. `source` is None for source-free
    (whole-graph) programs; `t_arrival` is the admission timestamp the
    flush deadline and the latency accounting run on; `deadline` (when
    set) is the absolute instant after which the answer is worthless —
    the server drops the query with a named timeout result instead of
    executing it."""

    qid: int
    program: str
    source: Optional[int]
    t_arrival: float
    deadline: Optional[float] = None


class AdmissionQueue:
    def __init__(
        self, *, max_batch: int = 8, max_delay_s: float = 0.005,
        max_queue: Optional[int] = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_delay_s < 0:
            raise ValueError(f"max_delay_s must be >= 0, got {max_delay_s}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_s)
        self.max_queue = None if max_queue is None else int(max_queue)
        self._lanes: dict[str, list[Query]] = {}

    def __len__(self) -> int:
        return sum(len(lane) for lane in self._lanes.values())

    def push(self, query: Query) -> None:
        if self.max_queue is not None and len(self) >= self.max_queue:
            raise LoadShedError(
                f"admission queue is full ({self.max_queue} queued): query "
                f"{query.qid} shed (reject-newest)"
            )
        self._lanes.setdefault(query.program, []).append(query)

    def next_deadline(self) -> Optional[float]:
        """Earliest instant any lane's oldest query exhausts its wait
        budget (None when the queue is empty)."""
        heads = [lane[0].t_arrival for lane in self._lanes.values() if lane]
        return min(heads) + self.max_delay_s if heads else None

    def pop_full(self) -> list[list[Query]]:
        """Pop every full micro-batch (len == max_batch), oldest first."""
        batches = []
        for lane in self._lanes.values():
            while len(lane) >= self.max_batch:
                batches.append(lane[: self.max_batch])
                del lane[: self.max_batch]
        return batches

    def pop_due(self, now: float) -> list[list[Query]]:
        """Pop full batches plus every lane whose oldest query has waited
        past the deadline at time `now` (deadline batches may be partial —
        that is the padding the bucket policy absorbs)."""
        batches = self.pop_full()
        for lane in self._lanes.values():
            if lane and now >= lane[0].t_arrival + self.max_delay_s:
                batches.append(lane[:])
                lane.clear()
        return batches

    def pop_all(self) -> list[list[Query]]:
        """Drain everything (forced flush), chunked at max_batch."""
        batches = self.pop_full()
        for lane in self._lanes.values():
            if lane:
                batches.append(lane[:])
                lane.clear()
        return batches
