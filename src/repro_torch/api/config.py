"""Frozen per-algorithm partitioner configs (port of `repro.api.config`).

The reference's `compute_backend` knob is not carried over: the port
dispatches by device instead (a CPU tensor runs the plain PyTorch version
of a kernel, a CUDA tensor runs the hand-written CUDA kernel), so the
configs hold only the algorithm's own knobs.
"""
from __future__ import annotations

import dataclasses
import math


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# Chunked-commit semantics: "frozen" scores every edge of a block against
# block-start membership; "window" replays each commit onto the block's
# later conflicted edges, making any block size bit-identical to the scan.
COMMIT_MODES = ("frozen", "window")


def check_commit_mode(commit) -> str:
    _require(commit in COMMIT_MODES, f"commit must be one of {COMMIT_MODES}, got {commit!r}")
    return commit


@dataclasses.dataclass(frozen=True)
class PartitionerConfig:
    """Base config. Subclasses override `validate` to raise ValueError."""

    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> None:  # pragma: no cover - overridden
        pass

    def replace(self, **changes) -> "PartitionerConfig":
        """Validated functional update (dataclasses.replace re-validates)."""
        return dataclasses.replace(self, **changes)

    def to_kwargs(self) -> dict:
        return dataclasses.asdict(self)


def _positive_finite(value, name: str) -> None:
    _require(
        isinstance(value, (int, float)) and math.isfinite(value) and value > 0,
        f"{name} must be finite and > 0, got {value!r}",
    )


def _validate_block_knobs(cfg) -> None:
    _require(
        isinstance(cfg.block, int) and not isinstance(cfg.block, bool) and cfg.block >= 1,
        f"block must be a positive int, got {cfg.block!r}",
    )
    _require(isinstance(cfg.sort_edges, bool), f"sort_edges must be a bool, got {cfg.sort_edges!r}")
    check_commit_mode(cfg.commit)


@dataclasses.dataclass(frozen=True)
class EBGConfig(PartitionerConfig):
    """EBV knobs (paper Algorithm 1; the modules call it EBG): alpha/beta
    weight the edge/vertex balance terms, `block` sizes the chunked
    variant's commit block, `sort_edges` toggles the §IV-C degree-sum
    order, `commit` picks the chunked commit semantics (COMMIT_MODES)."""

    alpha: float = 1.0
    beta: float = 1.0
    block: int = 256
    sort_edges: bool = True
    commit: str = "frozen"

    def validate(self) -> None:
        _positive_finite(self.alpha, "alpha")
        _positive_finite(self.beta, "beta")
        _validate_block_knobs(self)


# The paper calls the algorithm EBV; the modules call it EBG.
EBVConfig = EBGConfig


@dataclasses.dataclass(frozen=True)
class HDRFConfig(PartitionerConfig):
    """HDRF knobs [Petroni et al., CIKM'15]: `lam` weights the balance term,
    `eps` is the range normalizer's epsilon (1/(eps + max-min))."""

    lam: float = 1.0
    eps: float = 1.0
    block: int = 256
    sort_edges: bool = False
    commit: str = "frozen"

    def validate(self) -> None:
        _positive_finite(self.lam, "lam")
        _positive_finite(self.eps, "eps")
        _validate_block_knobs(self)


@dataclasses.dataclass(frozen=True)
class GreedyConfig(PartitionerConfig):
    """PowerGraph Greedy knobs [Gonzalez et al., OSDI'12]: HDRF's knobs
    minus the degree term's lambda."""

    eps: float = 1.0
    block: int = 256
    sort_edges: bool = False
    commit: str = "frozen"

    def validate(self) -> None:
        _positive_finite(self.eps, "eps")
        _validate_block_knobs(self)


def _validate_seed(seed) -> None:
    _require(isinstance(seed, int) and not isinstance(seed, bool) and seed >= 0,
             f"seed must be a non-negative int, got {seed!r}")


@dataclasses.dataclass(frozen=True)
class HashConfig(PartitionerConfig):
    """Hash-family baselines (random edge hash, DBH, CVC)."""

    seed: int = 0

    def validate(self) -> None:
        _validate_seed(self.seed)


@dataclasses.dataclass(frozen=True)
class NEConfig(PartitionerConfig):
    """Neighbor Expansion [Zhang et al., KDD'17]."""

    seed: int = 0

    def validate(self) -> None:
        _validate_seed(self.seed)


@dataclasses.dataclass(frozen=True)
class MetisLikeConfig(PartitionerConfig):
    """Multilevel METIS-style stand-in: coarsen to at most `coarsen_to`
    vertices, `refine_passes` label-propagation passes at the coarsest level."""

    seed: int = 0
    coarsen_to: int = 4096
    refine_passes: int = 6

    def validate(self) -> None:
        _validate_seed(self.seed)
        _require(
            isinstance(self.coarsen_to, int) and self.coarsen_to >= 2,
            f"coarsen_to must be an int >= 2, got {self.coarsen_to!r}",
        )
        _require(
            isinstance(self.refine_passes, int) and self.refine_passes >= 0,
            f"refine_passes must be a non-negative int, got {self.refine_passes!r}",
        )
