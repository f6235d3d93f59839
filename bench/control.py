"""The control of a cell's comparison: the reference put in the program's
place, computed in the precision below the configuration's (bfloat16 for
its float32 SSSP distances and PageRank ranks), judged by the same
comparison against the float32 reference. Its readings set the upper end
of each float limit; it must come out not correct.

    python3 bench/control.py --workload g500-22.ebv32.queries --seeds 11,12,13

It checks the answers a run of the cell checks (its traffic module's
`checked_pairs`): the same programs and sources at the cell's size. The integer
answers (CC labels, hop counts) have no lower precision and are computed
as the reference computes them. Prints one JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def sample(workload: dict, keys, seed: int, seconds: float) -> list:
    """The (program, source) pairs a run of the cell compares, as its
    traffic module chooses them."""
    from bench import harness

    return harness.traffic_module(workload["kind"]).checked_pairs(workload, keys, seed, seconds)


def control_answers(g, pairs: list, workload: dict, dtype) -> list:
    """The reference's answers in `dtype`, as the program reports them."""
    import torch

    from bench import reference
    from bench.harness import Answer

    out = []
    for program, source in pairs:
        if program == "sssp":
            d = reference.sssp(g, source, dtype=dtype).float()
            v = torch.where(torch.isinf(d), 3.0e38, d)
        elif program == "pr":
            pr = workload["pr"]
            v = reference.pagerank(g, pr["num_iters"], pr["damping"], g.num_vertices,
                                   dtype=dtype).float()
        elif program == "bfs":
            v = reference.bfs(g, source)
        else:
            v = reference.wcc(g)
        out.append(Answer(program, source, v.double().cpu().numpy()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="11,12,13")
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench import compare, gen, harness, reference

    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 3
    bench, _, cfg, wl = harness.cell_files(ROOT, args.workload)
    seconds = args.seconds or bench["run_seconds"]
    gcfg = cfg["graph"]
    for seed in [int(s) for s in args.seeds.split(",")]:
        el = gen.kronecker(gcfg["scale"], gcfg["edge_factor"], gcfg["a"], gcfg["b"], gcfg["c"],
                           seed=seed, device="cuda")
        keys = gen.search_keys(el.num_vertices, wl["search_keys"], seed=seed,
                               device="cuda").cpu().numpy()
        g = reference.SymGraph.from_edges(el.src, el.dst, el.weight, el.num_vertices, "cuda")
        del el
        pairs = sample(wl, keys, seed, seconds)
        cell = harness.Cell(args.workload, cfg, wl, seed, "cuda")
        checks = compare.Checks(wl["limits"])
        harness.check_answers(cell, control_answers(g, pairs, wl, torch.bfloat16), g, checks)
        print(json.dumps({"seed": seed, "correct": checks.correct, "checks": checks.table(),
                          "answers": len(pairs), "device": torch.cuda.get_device_name(0)}),
              flush=True)
        del g
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
