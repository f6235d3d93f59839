"""repro_torch — the PyTorch/CUDA port of `repro` (see README.md).

Module paths mirror `repro`: `core/` (partitioners, metrics), `graph/`
(generators, subgraph build, BSP engine), `api/` (configs, registry,
`GraphPipeline`), `kernels/` (CUDA kernels and their plain versions),
and `interop` (carrying the reference's numpy data across).
"""
