"""EBG applied to MoE expert→device placement (port of `repro.core.placement`).

The token→expert routing multigraph of a trained MoE is power-law (a few
hot experts dominate). Assigning experts to EP devices is the paper's
problem in miniature: a greedy assignment driven by an evaluation function
that jointly scores *communication* (co-activation affinity, the analogue
of the membership/replication term) and *balance* (routed-token load and
slot count, the analogues of e_count/v_count):

    Score_e(d) = gamma·(1 − affinity(e,d)/w_e)           # "miss" term
               + alpha·load[d]/(T/D)                     # load balance
               + beta·slots[d]/(E/D)                     # slot balance

Experts are processed in **descending popularity**, the mirror image of
the paper's ascending degree-sum edge order: an expert is atomic (it
cannot be cut like an edge), so hub experts are placed first.

Host numpy, as in the reference: a greedy loop over E ≤ 384 experts,
nothing in it belongs on the card. The popularity order is numpy's
`argsort(-pop)` (an unstable quicksort past 16 elements); integer
popularities tie often, and the port keeps numpy's call so that ties
resolve as the reference's do. `routing_pairs` turns the router's [T, k]
expert ids (a tensor on any device) into the [T, 2] pairs taken here.
`moe_ffn(expert_perm=...)` consumes the permutation.
"""
from __future__ import annotations

import numpy as np
import torch


def routing_pairs(expert_idx) -> np.ndarray:
    """[T, k] expert ids (k >= 2, the router's top-k in descending logit
    order; a tensor on any device or an array) → the [T, 2] int64 pairs of
    each token's top-2 experts, on the host."""
    if isinstance(expert_idx, torch.Tensor):
        expert_idx = expert_idx.detach().cpu().numpy()
    idx = np.asarray(expert_idx)
    if idx.ndim != 2 or idx.shape[1] < 2:
        raise ValueError(f"routing_pairs takes [T, k] expert ids with k >= 2, got {idx.shape}")
    return np.ascontiguousarray(idx[:, :2], dtype=np.int64)


def ebg_expert_placement(
    pairs: np.ndarray,  # [T, 2] co-activated expert ids (top-2 routing stats)
    num_experts: int,
    num_devices: int,
    *,
    alpha: float = 1.0,
    beta: float = 1.0,
    gamma: float = 0.5,
) -> np.ndarray:
    """Returns perm[e] = new slot of expert e (device = slot // per_dev)."""
    if num_experts % num_devices:
        raise ValueError(f"{num_experts} experts do not divide over {num_devices} devices")
    per_dev = num_experts // num_devices
    pairs = np.asarray(pairs, dtype=np.int64)
    E, D = num_experts, num_devices

    # routing stats: expert popularity + co-activation weights
    pop = np.bincount(pairs.reshape(-1), minlength=E).astype(np.float64)
    W = np.zeros((E, E), np.float64)
    np.add.at(W, (pairs[:, 0], pairs[:, 1]), 1.0)
    np.add.at(W, (pairs[:, 1], pairs[:, 0]), 1.0)

    dev_of = np.full(E, -1, np.int64)
    load = np.zeros(D, np.float64)
    slots = np.zeros(D, np.int64)
    affinity = np.zeros((E, D), np.float64)  # co-activation weight to device
    mean_load = pop.sum() / D

    for e in np.argsort(-pop):  # hot experts first (numpy's sort: see the docstring)
        w_e = max(W[e].sum(), 1e-9)
        score = (
            gamma * (1.0 - affinity[e] / w_e)
            + alpha * load / mean_load
            + beta * slots / per_dev
        )
        score[slots >= per_dev] = np.inf  # device full
        d = int(np.argmin(score))
        dev_of[e] = d
        load[d] += pop[e]
        slots[d] += 1
        affinity[:, d] += W[:, e]

    perm = np.empty(E, np.int64)
    next_slot = np.zeros(D, np.int64)
    for e in range(E):
        d = dev_of[e]
        perm[e] = d * per_dev + next_slot[d]
        next_slot[d] += 1
    return perm


def placement_report(pairs: np.ndarray, perm: np.ndarray, num_experts: int,
                     num_devices: int) -> dict:
    """Predicted EP traffic profile under a placement permutation."""
    per_dev = num_experts // num_devices
    dev = np.asarray(perm)[np.asarray(pairs, np.int64)] // per_dev  # [T, 2]
    load = np.bincount(dev.reshape(-1), minlength=num_devices).astype(np.float64)
    cross = (dev[:, 0] != dev[:, 1]).mean()
    return dict(
        load_max_mean=float(load.max() / load.mean()),
        cross_frac=float(cross),
        per_device_load=load.tolist(),
    )
