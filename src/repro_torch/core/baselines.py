"""Hash-family baseline partitioners from the paper: random hash, DBH, CVC
(port of `repro.core.baselines`).

All three are one pass of integer arithmetic over the edges with no
sequential state. They run on the pipeline's device as PyTorch integer
ops: the edge arrays are uploaded once and `part` stays on the device.

The reference hashes in numpy uint64 (splitmix64). PyTorch has no logical
right shift on uint64 on every backend, so the hash runs in int64 with the
same bits: multiplies and adds wrap modulo 2^64 as unsigned ones do, a
logical shift is an arithmetic one with the sign-extended bits masked off,
and `% p` is taken of the unsigned value. Half of all hashes have the top
bit set, so a signed remainder would move half the edges at any p that is
not a power of two.
"""
from __future__ import annotations

import math

import torch

from repro_torch.api.config import HashConfig
from repro_torch.api.registry import register_partitioner
from repro_torch.core.types import Graph, PartitionResult
from repro_torch.kernels.dispatch import resolve_device

_U64 = 1 << 64


def _i64(x: int) -> int:
    """The int64 whose bits are the uint64 `x` mod 2^64."""
    x %= _U64
    return x - _U64 if x >= 1 << 63 else x


_MIX = 0x9E3779B97F4A7C15
_M1 = _i64(0xBF58476D1CE4E5B9)
_M2 = _i64(0x94D049BB133111EB)


def _shr(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits by 0 < k < 64."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def _hash_u64(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """splitmix64-style hash of int64 `x` (non-negative), as int64 bits:
    the reference's `_hash_u64` bit for bit."""
    z = x + _i64(seed * _MIX + _MIX)
    z = (z ^ _shr(z, 30)) * _M1
    z = (z ^ _shr(z, 27)) * _M2
    return z ^ _shr(z, 31)


def _mod_u64(h: torch.Tensor, m: int) -> torch.Tensor:
    """The unsigned value of int64 bits `h`, modulo m (1 <= m < 2^62)."""
    wrap = _U64 % m  # what the unsigned value adds where the sign bit is set
    return (torch.remainder(h, m) + torch.where(h < 0, wrap, 0)) % m


def _edges(graph: Graph, device):
    """The edge arrays on the device as int64 (one upload of the int32 ids)."""
    dev = resolve_device(device)
    return graph.src.to(dev).long(), graph.dst.to(dev).long()


@register_partitioner(
    "hash",
    config=HashConfig,
    deterministic=True,
    benchmark_default=False,
    description="Random edge hashing (Giraph/PowerGraph default)",
)
def random_hash_partition(graph: Graph, num_parts: int, *, seed: int = 0,
                          device=None) -> PartitionResult:
    """Random edge hashing (Giraph/PowerGraph default)."""
    src, dst = _edges(graph, device)
    h = _hash_u64(src * 2654435761 + dst, seed)
    return PartitionResult(part=_mod_u64(h, num_parts).to(torch.int32), num_parts=num_parts)


@register_partitioner(
    "dbh",
    config=HashConfig,
    deterministic=True,
    description="Degree-Based Hashing [Xie et al., NeurIPS'14]",
)
def dbh_partition(graph: Graph, num_parts: int, *, seed: int = 0,
                  device=None) -> PartitionResult:
    """Degree-Based Hashing [Xie et al., NeurIPS'14].

    Hash the endpoint with the LOWER degree (ties: the source) — hub
    (high-degree) vertices get cut, low-degree vertices stay whole.
    """
    src, dst = _edges(graph, device)
    V = graph.num_vertices
    deg = torch.bincount(src, minlength=V) + torch.bincount(dst, minlength=V)
    lower = torch.where(deg[src] <= deg[dst], src, dst)
    h = _hash_u64(lower, seed)
    return PartitionResult(part=_mod_u64(h, num_parts).to(torch.int32), num_parts=num_parts)


def _grid_shape(p: int) -> tuple[int, int]:
    """Closest-to-square factorization pr*pc = p."""
    pr = math.isqrt(p)
    while p % pr:
        pr -= 1
    return pr, p // pr


@register_partitioner(
    "cvc",
    config=HashConfig,
    deterministic=True,
    description="Cartesian Vertex-Cut 2D grid hashing [Boman et al., SC'13]",
)
def cvc_partition(graph: Graph, num_parts: int, *, seed: int = 0,
                  device=None) -> PartitionResult:
    """Cartesian Vertex-Cut [Boman et al., SC'13] — 2D block partition of the
    adjacency matrix: edge (u,v) -> block (h(u) mod pr, h(v) mod pc)."""
    pr, pc = _grid_shape(num_parts)
    src, dst = _edges(graph, device)
    r = _mod_u64(_hash_u64(src, seed), pr)
    c = _mod_u64(_hash_u64(dst, seed + 1), pc)
    return PartitionResult(part=(r * pc + c).to(torch.int32), num_parts=num_parts)
