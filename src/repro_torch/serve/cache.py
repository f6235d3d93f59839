"""Warm executable cache for the serving tier (port of `repro.serve.cache`).

Keys are (program, padded batch, num_workers, padded shapes, value dtype,
engine knobs) tuples — everything that changes the captured loop. `get`
builds on first miss (on the card: captures the batched loop's CUDA
graph) and replays the stored executable forever after, counting
hits/misses and builds per key so a benchmark can assert the steady-state
claim: at most ONE capture per (program, bucket), and a hit rate that
approaches 1 as traffic flows. "compile" in the stats is a build.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable


@dataclasses.dataclass
class _Entry:
    value: object
    build_s: float
    hits: int = 0


class ExecutableCache:
    def __init__(self):
        self._entries: dict[tuple, _Entry] = {}
        self._compiles: collections.Counter = collections.Counter()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: tuple) -> bool:
        return key in self._entries

    def get(self, key: tuple, build: Callable[[], object]):
        """Cached value for `key`, calling `build` exactly once per key."""
        entry = self._entries.get(key)
        if entry is not None:
            entry.hits += 1
            self.hits += 1
            return entry.value
        self.misses += 1
        self._compiles[key] += 1
        t0 = time.perf_counter()
        value = build()
        self._entries[key] = _Entry(value=value, build_s=time.perf_counter() - t0)
        return value

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    @property
    def compile_s(self) -> float:
        return sum(e.build_s for e in self._entries.values())

    def stats(self) -> dict:
        """Machine-readable cache section for benchmark reports."""
        return {
            "keys": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hit_rate, 4),
            "compiles_per_key_max": max(self._compiles.values(), default=0),
            "compile_s": round(self.compile_s, 3),
        }
