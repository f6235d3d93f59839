"""EBG — Efficient and Balanced Greedy edge partitioner (paper Algorithm 1).

Port of `repro.core.ebg`. Both EBG entry points live on the generic
streaming core in `repro_torch.core.streaming`: `ebg` is the faithful
edge-by-edge stream and `ebg_chunked` the blocked throughput variant, each
a stock instance of the `"ebv"` scorer (unit membership term + static
p/|E|, p/|V| balance normalizers — the paper's evaluation function

    Score_(u,v)(i) = 1[u∉keep[i]] + 1[v∉keep[i]]
                   + alpha * e_count[i]/(|E|/p) + beta * v_count[i]/(|V|/p)

minimized with ties toward the lowest subgraph index). This module remains
as the legacy import path.
"""
from __future__ import annotations

from repro_torch.core.streaming import ebg_partition, ebg_partition_chunked

__all__ = ["ebg_partition", "ebg_partition_chunked"]
