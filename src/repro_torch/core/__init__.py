"""repro_torch.core — the paper's partitioners and metrics (port of `repro.core`).

Importing this package registers the partitioners with
`repro_torch.api.registry`, in the reference's order: the streaming family
(`ebg`, `ebg_chunked`, `hdrf`, `greedy`), then the baselines (`hash`,
`dbh`, `cvc`, `ne`, `metis`). `PARTITIONERS` is a live view of that
registry; new code uses `repro_torch.api.get_partitioner` or
`GraphPipeline`.
"""
from repro_torch.api.registry import RegistryFunctionView
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
    list_scorers,
    register_scorer,
    scorer_names,
    streaming_chunked_partition,
    streaming_scan_partition,
)
from repro_torch.core.baselines import cvc_partition, dbh_partition, random_hash_partition
from repro_torch.core.ne import ne_partition
from repro_torch.core.metis_like import metis_like_partition
from repro_torch.core.metrics import (
    PartitionMetrics,
    max_mean_ratio,
    partition_metrics,
    theorem1_edge_bound,
    theorem2_vertex_bound,
)
from repro_torch.core.order import degree_sum_order
from repro_torch.core.types import Graph, PartitionResult

PARTITIONERS = RegistryFunctionView()
