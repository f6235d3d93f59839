"""Quickstart for the `repro_torch.api` facade (the PyTorch/CUDA port of
`examples/quickstart.py`).

One `GraphPipeline` session owns the whole subgraph-centric lifecycle:

    pipeline = GraphPipeline(graph)                # bind a graph (on the card)
    view = pipeline.partition("ebg", parts=8)      # pick a registered partitioner
    run = view.run("cc")                           # build + BSP engine + stats

Stages are lazy and cached per partition view — `view.metrics`,
`view.result`, and repeated `run` calls never recompute a stage. The
partitioner names ("ebg", "dbh", ...) come from the `repro_torch.api`
registry; per-algorithm knobs are frozen config dataclasses
(`EBGConfig(alpha, beta, ...)`, `HashConfig(seed)`, ...), passed either
as `config=` or as keyword overrides:

    pipeline.partition("ebg", parts=8, alpha=2.0).run("sssp")

Here we EBG-partition a power-law graph, run subgraph-centric connected
components, and compare the communication profile against DBH, as in
paper §V. It runs on the CUDA card (EBG's commit kernel, DBH's hashes and
CC's superstep kernel); `--device cpu` runs the kernels' plain versions:

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

from repro_torch.api import GraphPipeline, list_partitioners
from repro_torch.graph.generate import make_graph
from repro_torch.kernels.dispatch import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = make_graph("tiny_powerlaw")
    print(f"graph: |V|={g.num_vertices} |E|={g.num_edges}")
    print("registered partitioners:", ", ".join(s.name for s in list_partitioners()))

    pipeline = GraphPipeline(g, device=dev)
    for name in ("ebg", "dbh"):
        run = pipeline.partition(name, parts=8).run("cc")
        m = run.metrics
        print(
            f"{name.upper()}: replication={m.replication_factor:.2f} "
            f"edge_imb={m.edge_imbalance:.2f} vertex_imb={m.vertex_imbalance:.2f} | "
            f"CC components={run.num_components()} supersteps={run.stats.supersteps} "
            f"messages={run.stats.total_messages} max/mean={run.stats.max_mean:.3f}"
        )
    print("EBG cuts fewer vertices -> fewer messages, same balance. (paper §V)")


if __name__ == "__main__":
    main()
