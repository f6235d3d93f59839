"""repro_torch — the PyTorch/CUDA port of `repro` (see README.md).

Module paths mirror `repro`: `core/` (partitioners, metrics), `graph/`
(generators, subgraph build, BSP engine), `api/` (configs, registry,
`GraphPipeline`), `kernels/` (CUDA kernels and their plain versions),
`models/` and `configs/` (the LM stack's dense decoders), `launch/`
(command-line drivers) and `interop` (carrying the reference's numpy data
across).
"""
