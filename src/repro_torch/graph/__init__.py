"""repro_torch.graph — subgraph-centric BSP substrate."""
from repro_torch.graph.build import SubgraphSet, build_subgraphs
from repro_torch.graph.engine import (
    BFS,
    CC,
    PR,
    REACH,
    SSSP,
    BSPStats,
    VertexProgram,
    get_program,
    program_names,
    register_program,
    run_bsp,
)
