"""Beyond-paper example: EBG as a MoE expert-placement algorithm (the
PyTorch/CUDA port of `examples/expert_placement.py`).

The token→expert routing graph of a trained MoE is power-law (hot experts).
Placing experts on EP devices is exactly the paper's problem: minimize
cross-device traffic (replication ≙ re-dispatched tokens) while balancing
per-device load (edge/vertex balance ≙ expert FLOPs balance). We build the
expert co-activation graph from routing statistics, partition it with EBG
vs random hash, and compare the predicted all-to-all imbalance.

The placement is a greedy loop on the host in numpy, in the port as in the
reference (`repro_torch.core.placement`), so this example takes no
`--device` and launches no kernel:

  PYTHONPATH=src python examples/expert_placement_torch.py
"""
import numpy as np

from repro_torch.core.placement import ebg_expert_placement, placement_report


def main():
    rng = np.random.default_rng(0)
    E, devices, T = 64, 8, 200_000
    # zipf-ish routing: a few hot experts (as observed in real MoEs)
    popularity = 1.0 / (1 + np.arange(E)) ** 0.9
    popularity /= popularity.sum()
    pairs = rng.choice(E, size=(T, 2), p=popularity)  # top-2 co-activations

    perm_ebg = ebg_expert_placement(pairs, E, devices)
    perm_rand = np.argsort(rng.random(E))

    for name, perm in [("EBG placement", perm_ebg), ("random placement", perm_rand)]:
        rep = placement_report(pairs, perm, E, devices)
        print(f"{name}: load max/mean={rep['load_max_mean']:.3f} "
              f"cross-device pair traffic={rep['cross_frac']:.1%}")
    print("EBG placement balances hot experts AND co-locates co-activated pairs.")


if __name__ == "__main__":
    main()
