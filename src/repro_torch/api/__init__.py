"""repro_torch.api — partitioner registry, configs, and the `GraphPipeline`
facade (imported lazily: core modules import the registry to register)."""
from repro_torch.api.config import (
    COMMIT_MODES,
    EBGConfig,
    EBVConfig,
    GreedyConfig,
    HashConfig,
    HDRFConfig,
    MetisLikeConfig,
    NEConfig,
    PartitionerConfig,
)
from repro_torch.api.registry import (
    Partitioner,
    PartitionerSpec,
    RegistryFunctionView,
    benchmark_partitioners,
    check_num_parts,
    get_partitioner,
    list_partitioners,
    partitioner_names,
    register_partitioner,
)

_LAZY = ("BatchRun", "GraphPipeline", "LoweredBSP", "PipelineRun", "SubgraphSpec")


def __getattr__(name):
    if name in _LAZY:
        from repro_torch.api import pipeline as _pipeline

        return getattr(_pipeline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
