"""repro_torch.core — the paper's partitioners and metrics (port of `repro.core`).

Importing this package registers the streaming partitioners (`ebg`,
`ebg_chunked`, `hdrf`, `greedy`) with `repro_torch.api.registry`.
"""
from repro_torch.core.metrics import (
    PartitionMetrics,
    max_mean_ratio,
    partition_metrics,
    theorem1_edge_bound,
    theorem2_vertex_bound,
)
from repro_torch.core.order import degree_sum_order
from repro_torch.core.streaming import (
    EBV,
    GREEDY,
    HDRF,
    EdgeScorer,
    ebg_partition,
    ebg_partition_chunked,
    get_scorer,
    greedy_partition,
    hdrf_partition,
    register_scorer,
    scorer_names,
    streaming_chunked_partition,
    streaming_scan_partition,
)
from repro_torch.core.types import Graph, PartitionResult
