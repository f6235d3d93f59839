"""The comparison that decides `correct`: each answer of the program
against the plain reference's, as numbers with limits.

Answers are per-vertex host arrays in global vertex order, as the
program's `to_global` gives them (float64; the program marks an
unreached vertex with its dtype's "infinity": 2**31 - 1 hop counts,
3e38 distances). Each function returns the number that is held to a
limit: a count of vertices that differ (exact answers, limit 0) or the
largest relative gap (float answers).
"""
from __future__ import annotations

import numpy as np

# Program values at or above these mean "unreached".
UNREACHED_HOPS = 2**31 - 1
UNREACHED_DIST = 1e38
# Distances below this are compared absolutely: a relative gap of two
# sums near 0 says nothing of the path.
DIST_FLOOR = 1e-6


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def labels_wrong(answer, ref) -> int:
    """Vertices whose label (a CC label, a hop count) differs."""
    a, r = _np(answer).astype(np.float64), _np(ref).astype(np.float64)
    if a.shape != r.shape:
        return int(max(a.size, r.size))
    return int(np.count_nonzero(a != r))


def hops_wrong(answer, ref) -> int:
    """Vertices whose hop count, or whether they were reached, differs."""
    a, r = _np(answer).astype(np.float64), _np(ref).astype(np.float64)
    if a.shape != r.shape:
        return int(max(a.size, r.size))
    a_un, r_un = a >= UNREACHED_HOPS, r >= UNREACHED_HOPS
    return int(np.count_nonzero((a_un != r_un) | (~a_un & (a != r))))


def reach_wrong(answer, ref) -> int:
    """Vertices that one side reached and the other did not (distances)."""
    a, r = _np(answer).astype(np.float64), _np(ref).astype(np.float64)
    if a.shape != r.shape:
        return int(max(a.size, r.size))
    return int(np.count_nonzero((a >= UNREACHED_DIST) != ~np.isfinite(r)))


def dist_gap(answer, ref) -> float:
    """Largest relative gap of a distance that both sides reached."""
    a, r = _np(answer).astype(np.float64), _np(ref).astype(np.float64)
    if a.shape != r.shape:
        return float("inf")
    both = (a < UNREACHED_DIST) & np.isfinite(r)
    if not both.any():
        return 0.0
    gap = np.abs(a[both] - r[both]) / np.maximum(np.abs(r[both]), DIST_FLOOR)
    return float(gap.max()) if np.isfinite(gap).all() else float("inf")


def rank_gap(answer, ref) -> float:
    """Largest relative gap of a rank (every reference rank is > 0)."""
    a, r = _np(answer).astype(np.float64), _np(ref).astype(np.float64)
    if a.shape != r.shape:
        return float("inf")
    gap = np.abs(a - r) / np.abs(r)
    return float(np.nan_to_num(gap, nan=np.inf).max())


class Checks:
    """The numbers a run compares, each beside its limit; a number passes
    when it is at most its limit (NaN never passes)."""

    def __init__(self, limits: dict):
        self.limits = dict(limits)
        self.values: dict = {}

    def worst(self, name: str, value) -> None:
        """Keep the worst (largest) reading of `name` over the answers."""
        if name not in self.limits:
            raise KeyError(f"no limit for check {name!r}")
        value = float(value)
        old = self.values.get(name)
        if old is None or not value <= old:
            self.values[name] = value

    def add(self, name: str, value) -> None:
        """Add to the count `name` (counts of wrong answers add up)."""
        if name not in self.limits:
            raise KeyError(f"no limit for check {name!r}")
        self.values[name] = self.values.get(name, 0.0) + float(value)

    @property
    def correct(self) -> bool:
        return bool(self.values) and all(
            self.values[k] <= self.limits[k] for k in self.values)

    def table(self) -> dict:
        return {k: {"value": self.values[k], "limit": self.limits[k]}
                for k in sorted(self.values)}

    def lines(self) -> list:
        return [f"check {k}: {self.values[k]!r} (limit {self.limits[k]!r})"
                for k in sorted(self.values)]
