"""Partitioner decorator registry (port of `repro.api.registry`).

Partitioner modules self-register at import time:

    @register_partitioner("ebg", config=EBGConfig)
    def ebg_partition(graph, num_parts, *, alpha=1.0, ..., device=None): ...

The registry is the one source of enumeration: `repro_torch.core.PARTITIONERS`
(`RegistryFunctionView`), the paper benchmark's partitioner list
(`benchmark_partitioners`) and name validation (`partitioner_names`) are
views of it. `_ensure_builtins` imports `repro_torch.core` lazily the first
time the registry is queried (core modules import this one to register).

The reference's `jit_compatible` and `compute_backends` capabilities are
not carried over: both describe JAX's execution (tracing under `jax.jit`,
the "xla"/"ref"/"pallas" hot-path choice), and the port runs eagerly and
dispatches by device, with no `compute_backend`.
"""
from __future__ import annotations

import dataclasses
import inspect
from collections.abc import Mapping
from typing import Callable, Optional

from repro_torch.api.config import PartitionerConfig


def check_num_parts(num_parts) -> None:
    if not isinstance(num_parts, int) or isinstance(num_parts, bool) or num_parts < 1:
        raise ValueError(f"num_parts must be a positive int, got {num_parts!r}")


@dataclasses.dataclass(frozen=True)
class PartitionerSpec:
    """A registered partitioner: callable + config schema + capabilities."""

    name: str
    fn: Callable
    config_cls: type
    deterministic: bool = True  # same inputs (incl. seed) -> same partition
    chunked: bool = False  # processes edges in blocks
    benchmark_default: bool = True  # included in the paper benchmark suite
    scorer: Optional[str] = None  # streaming EdgeScorer name, if on that core
    description: str = ""

    @property
    def accepted_kwargs(self) -> frozenset:
        """Keyword parameters of `fn` beyond (graph, num_parts, device)."""
        sig = inspect.signature(self.fn)
        return frozenset(
            n
            for n, p in sig.parameters.items()
            if p.kind in (p.KEYWORD_ONLY, p.POSITIONAL_OR_KEYWORD)
            and n not in ("graph", "num_parts", "device")
        )

    def make_config(self, config: Optional[PartitionerConfig] = None, **overrides) -> PartitionerConfig:
        """Build (or update) this spec's config; raises on bad values."""
        if config is not None:
            if not isinstance(config, self.config_cls):
                raise TypeError(
                    f"partitioner {self.name!r} expects {self.config_cls.__name__}, "
                    f"got {type(config).__name__}"
                )
            return config.replace(**overrides) if overrides else config
        return self.config_cls(**overrides)

    def check_overrides(self, overrides: dict) -> None:
        """A knob the caller names must reach the algorithm (e.g. `block` on
        the unblocked scan is an error, not a silent no-op)."""
        unused = set(overrides) - self.accepted_kwargs
        if unused:
            raise ValueError(
                f"partitioner {self.name!r} does not use {sorted(unused)}; "
                f"its knobs are {sorted(self.accepted_kwargs)}"
            )

    def partition(self, graph, num_parts: int, config: Optional[PartitionerConfig] = None,
                  *, device=None, **overrides):
        """Run the partitioner under a validated config on `device`."""
        check_num_parts(num_parts)
        cfg = self.make_config(config, **overrides)
        self.check_overrides(overrides)
        accepted = self.accepted_kwargs
        kwargs = {k: v for k, v in cfg.to_kwargs().items() if k in accepted}
        return self.fn(graph, num_parts, device=device, **kwargs)


_REGISTRY: dict[str, PartitionerSpec] = {}


def register_partitioner(
    name: str,
    *,
    config: type = PartitionerConfig,
    deterministic: bool = True,
    chunked: bool = False,
    benchmark_default: bool = True,
    scorer: Optional[str] = None,
    description: str = "",
):
    """Decorator: register `fn` under `name`; returns `fn` unchanged."""

    def deco(fn: Callable) -> Callable:
        if name in _REGISTRY:
            raise ValueError(f"partitioner {name!r} already registered ({_REGISTRY[name].fn})")
        desc = description
        if not desc and fn.__doc__:
            desc = fn.__doc__.strip().splitlines()[0]
        _REGISTRY[name] = PartitionerSpec(
            name=name, fn=fn, config_cls=config, deterministic=deterministic, chunked=chunked,
            benchmark_default=benchmark_default, scorer=scorer, description=desc,
        )
        return fn

    return deco


def _ensure_builtins() -> None:
    """Importing repro_torch.core registers the built-in partitioners."""
    import repro_torch.core  # noqa: F401


def get_partitioner(name: str) -> PartitionerSpec:
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown partitioner {name!r}; registered: {sorted(_REGISTRY)}") from None


def list_partitioners() -> tuple[PartitionerSpec, ...]:
    """All registered specs in registration order."""
    _ensure_builtins()
    return tuple(_REGISTRY.values())


def partitioner_names() -> tuple[str, ...]:
    return tuple(s.name for s in list_partitioners())


def benchmark_partitioners() -> tuple[str, ...]:
    """Names the paper benchmark suite enumerates (derived, not hand-kept)."""
    return tuple(s.name for s in list_partitioners() if s.benchmark_default)


class RegistryFunctionView(Mapping):
    """A live `{name: fn}` view of the registry (`repro_torch.core.PARTITIONERS`):
    partitioners registered after import stay visible through it."""

    def __getitem__(self, name: str) -> Callable:
        return get_partitioner(name).fn

    def __iter__(self):
        _ensure_builtins()
        return iter(list(_REGISTRY))

    def __len__(self) -> int:
        _ensure_builtins()
        return len(_REGISTRY)

    def __repr__(self) -> str:
        return f"RegistryFunctionView({list(self)})"
