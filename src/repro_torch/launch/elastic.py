"""Elastic scaling: reshard a checkpoint across a different device count
(port of `repro.launch.elastic`).

A checkpoint stores device-agnostic host arrays; resharding = restoring
and laying each leaf out by the shardings of the NEW mesh (DTensor
placements from `launch.sharding`). `reshard` is the library entry; the
CLI names the step a checkpoint directory would be resharded from (e.g.
after losing a pod, restart on 256 chips from a 512-chip checkpoint —
ZeRO/FSDP states follow the parameter specs so nothing else changes).
"""
from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt as CKPT
from repro_torch.launch.mesh import BACKENDS, make_host_mesh
from repro_torch.launch.sharding import param_shardings


def reshard(tree: dict, shardings: dict) -> dict:
    """Lay every leaf of `tree` ({name: tensor}; a DTensor is gathered from
    its own mesh first) out by its new sharding ({name: NamedSharding}):
    {name: DTensor}. Called on every rank of the new mesh."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    out = {}
    for name, leaf in tree.items():
        ns = shardings[name]
        full = leaf.full_tensor() if isinstance(leaf, DTensor) else torch.as_tensor(leaf)
        out[name] = distribute_tensor(full.to(ns.mesh.device_type), ns.mesh, ns.placements)
    return out


def reshard_checkpoint(cfg, ckpt_dir: str, step: int, new_mesh) -> dict:
    """Restore a params checkpoint onto `new_mesh`'s shardings: {name:
    DTensor}, in the dtypes it was saved in. The checkpoint holds the
    parameters by name at its top level, or under "params" (the train
    launcher's state, whose optimizer leaves are not read)."""
    from repro_torch.models.transformer import empty_params

    names = [n for n, _ in empty_params(cfg, device="meta").named_parameters()]
    manifest = json.loads((Path(ckpt_dir) / f"step_{step:08d}" / "manifest.json").read_text())
    nested = any(m["path"].startswith("params" + CKPT._KEY_SEP) for m in manifest["leaves"])
    like = {n: 0 for n in names}  # non-tensor leaves: the arrays come back as stored
    got = CKPT.restore(ckpt_dir, step, {"params": like} if nested else like)
    got = got["params"] if nested else got
    params = empty_params(cfg, device="meta", dtype=torch.bfloat16)
    shardings = param_shardings(cfg, params, new_mesh)
    return reshard({n: torch.from_numpy(got[n]) for n in names}, shardings)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="the mesh's device type (default: the card)")
    args = ap.parse_args(argv)
    device = args.device or "cuda"
    started = not dist.is_initialized()
    with tempfile.TemporaryDirectory(prefix="elastic_") as tmp:
        if started:  # a world of this process alone
            dist.init_process_group(BACKENDS[device], init_method=f"file://{tmp}/rendezvous",
                                    rank=0, world_size=1)
        try:
            mesh = make_host_mesh(args.devices, device_type=device)
            step = CKPT.latest_step(args.ckpt_dir)
            print(f"resharding step {step} onto {mesh}")
        finally:
            if started:
                dist.destroy_process_group()


if __name__ == "__main__":
    main()
