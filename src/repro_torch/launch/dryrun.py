"""Multi-pod dry-run of the LM cells: lay every (arch × shape × mesh) cell
out at production scale and cost one step on one device (port of
`repro.launch.dryrun`).

The reference lowers and compiles each step for 256 or 512 placeholder
devices and reads XLA's memory and cost analyses. PyTorch compiles nothing
ahead of time, and one card cannot hold a 512-rank mesh. So the port runs
rank 0 of the production world on fake tensors: inside a fake world
(`launch.mesh.fake_world`) it lays the production mesh out, places the
parameters (`empty_params(device="meta")` in bf16), the optimizer state,
the batch and the caches on it as DTensors by `launch.sharding`'s rules,
each rank's shard a `FakeTensor` of its local shape, and runs the step
(`make_train_step` with remat; `make_prefill_step`; `make_serve_step`)
once under `FakeTensorMode` and `pspec.activation_axes`. No memory is
touched and no collective moves data.

A dispatch mode below DTensor (`LocalCost`) sees the local ops and costs
them per device: FLOPs by PyTorch's flop formulas (`torch.utils.
flop_counter`: matrix products, attention, `decode_attention`'s own; an
elementwise op counts none), bytes accessed as every local op's inputs
plus its outputs (views and collectives aside: unfused, so more than
XLA's fused figure), the collectives by `launch.roofline`'s recorder under
the reference's kind names and ring factors, and the peak of live local
storages the step allocates (`temp_bytes`, above the arguments).
DTensor's sharding propagation runs each op once more at the global shape
to learn its output's shape; those calls are not the device's work and
are left out. The constants every rank builds alike inside the model
(positions, masks, the RoPE table) are plain tensors, replicated by
`implicit_replication`. An op DTensor has no sharding rule for fails the
cell with its name; nothing is replicated in its place.

The port loops over its layers (no scan), so every layer is counted and
there is no twin lowering to correct by: `scan_corrected` is False and
`raw_flops_uncorrected == flops_per_device`.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3_2_3b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun
  (on the card by default; --device cpu lays the mesh out over CPU tensors)
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import threading
import time
import traceback
import weakref
from pathlib import Path
from typing import Optional

import torch
from torch import nn

from repro_torch import configs
from repro_torch.launch.mesh import PRODUCTION_MESHES, dp_axes, fake_world, make_production_mesh
from repro_torch.launch.roofline import (
    COLLECTIVE_NAMESPACES,
    _Recorder,
    model_flops,
    roofline_terms,
    summarize_collectives,
)
from repro_torch.launch.shapes import input_specs
from repro_torch.launch.sharding import (
    NamedSharding,
    batch_shardings,
    cache_specs,
    lay_out_caches,
    local_shape,
    opt_state_shardings,
    param_shardings,
)
from repro_torch.models import pspec
from repro_torch.models.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.models.transformer import empty_params
from repro_torch.optim.adam import AdamWConfig, init_opt_state

BF16_STATES_ABOVE = 1e11  # parameters: bf16 AdamW states above this count
_PROPAGATING = threading.local()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, nn.Module):
        for _, p in tree.named_parameters():
            yield p
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "__dataclass_fields__"):
        for f in tree.__dataclass_fields__:
            yield from _tensors(getattr(tree, f))


def local_bytes(tree) -> int:
    """The bytes of this rank's shards of every tensor in `tree` (params,
    dicts, lists, caches)."""
    from torch.distributed.tensor import DTensor

    return sum((t.to_local() if isinstance(t, DTensor) else t).numel() * t.element_size()
               for t in _tensors(tree))


@contextlib.contextmanager
def _marking_propagation():
    """While entered, DTensor's sharding propagation (the op run once at the
    global shape on fake tensors to learn its output) is marked, so that
    `LocalCost` leaves it out."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = "_propagate_tensor_meta_non_cached"
    if not hasattr(ShardingPropagator, name):
        name = "_propagate_tensor_meta"
    real = getattr(ShardingPropagator, name)

    def marked(self, *a, **k):
        _PROPAGATING.depth = getattr(_PROPAGATING, "depth", 0) + 1
        try:
            return real(self, *a, **k)
        finally:
            _PROPAGATING.depth -= 1

    setattr(ShardingPropagator, name, marked)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, real)


class LocalCost(_Recorder):
    """A dispatch mode under DTensor: per device, the FLOPs and bytes of the
    local ops, their collectives (`.records`), and the peak bytes of the
    storages they allocate that are alive at once (`.peak`). Arguments'
    storages (`hold`) are not counted."""

    def __init__(self):
        super().__init__(events=False)
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._held: dict = {}
        self._args: set = set()

    def hold(self, tree) -> None:
        from torch.distributed.tensor import DTensor

        for t in _tensors(tree):
            t = t.to_local() if isinstance(t, DTensor) else t
            self._args.add(t.untyped_storage()._cdata)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if getattr(_PROPAGATING, "depth", 0):
            return out
        if func.namespace in COLLECTIVE_NAMESPACES:
            self._record(func, args, kwargs, out)
        else:
            packet = func._overloadpacket
            if packet in self.registry:
                self.flops += self.registry[packet](*args, **kwargs, out_val=out)
            if not func.is_view:
                self.bytes += sum(t.numel() * t.element_size()
                                  for t in _tensors((args, kwargs, out)))
        for t in _tensors(out):
            self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        key = t.untyped_storage()._cdata
        if key in self._args:
            return
        if key not in self._held:
            nbytes = t.untyped_storage().nbytes()
            self._held[key] = [nbytes, 0]
            self.live += nbytes
            self.peak = max(self.peak, self.live)
        self._held[key][1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        held = self._held[key]
        held[1] -= 1
        if not held[1]:
            self.live -= held[0]
            del self._held[key]


def _contiguous_stride(shape) -> tuple:
    out, acc = [], 1
    for s in reversed(tuple(shape)):
        out.append(acc)
        acc *= s
    return tuple(reversed(out))


def place(like: torch.Tensor, ns: NamedSharding, device, fill=None):
    """A DTensor of like's global shape and dtype laid out by `ns`, this
    rank's shard made on `device` (a fake tensor under `FakeTensorMode`);
    `fill(shape, dtype, device)` makes the shard (default: empty)."""
    from torch.distributed.tensor import DTensor

    shape = local_shape(tuple(like.shape), ns.spec, ns.mesh)
    local = (torch.empty(shape, dtype=like.dtype, device=device) if fill is None
             else fill(shape, like.dtype, device))
    return DTensor.from_local(local, ns.mesh, ns.placements, run_check=False,
                              shape=like.shape, stride=_contiguous_stride(like.shape))


def place_params(params, shardings: dict, device, fill=None):
    """Replace every parameter of `params` by its DTensor (in place)."""
    for name, p in list(params.named_parameters()):
        owner, leaf = name.rpartition(".")[::2]
        mod = params.get_submodule(owner) if owner else params
        setattr(mod, leaf, nn.Parameter(place(p, shardings[name], device, fill),
                                        requires_grad=False))
    return params


def place_caches(caches: list, shardings: list, device, fill=None) -> list:
    for c, sh in zip(caches, shardings):
        for field, ns in sh.items():
            setattr(c, field, place(getattr(c, field), ns, device, fill))
    return caches


def place_batch(batch: dict, shardings: dict, device, fill=None) -> dict:
    return {k: place(v, shardings[k], device, fill) if isinstance(v, torch.Tensor) else v
            for k, v in batch.items()}


def layout_cell(cfg, kind: str, specs: dict, mesh, overrides: dict, device, fill=None):
    """The step of a cell and its arguments laid out on `mesh`: (step, args)."""
    fsdp = () if overrides.get("serve_repl") else None
    params = empty_params(cfg, device="meta", dtype=torch.bfloat16)
    p_shard = param_shardings(cfg, params, mesh, fsdp=fsdp)
    params = place_params(params, p_shard, device, fill)
    batch = place_batch(specs["batch"], batch_shardings(specs["batch"], mesh), device, fill)
    if kind == "train":
        state_dtype = torch.bfloat16 if cfg.num_params() > BF16_STATES_ABOVE else torch.float32
        opt = AdamWConfig(state_dtype=state_dtype, compress_grads=overrides.get("compress_grads"))
        state = init_opt_state(params, opt)
        want = opt_state_shardings(p_shard, mesh)
        for n, t in state["mu"].items():
            if tuple(t.placements) != want["mu"][n].placements:
                raise AssertionError(f"mu[{n}] is laid out {t.placements}")
        step = make_train_step(cfg, opt, remat=True,
                               vocab_parallel=overrides.get("vocab_parallel", False))
        return step, (params, state, batch)
    if kind == "prefill":
        layout = functools.partial(lay_out_caches, mesh=mesh)
        return make_prefill_step(cfg, specs["max_seq"], cache_layout=layout), (params, batch)
    caches = place_caches(specs["caches"], cache_specs(cfg, specs["caches"], mesh), device, fill)
    return make_serve_step(cfg), (params, caches, batch)


def sharded_context(mesh, overrides: dict):
    """`activation_axes` of a plan's overrides, with the model's plain
    constants replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    stack = contextlib.ExitStack()
    stack.enter_context(pspec.activation_axes(
        mesh, dp=dp_axes(mesh), tp="model", sp=overrides.get("sp"),
        ep_shard_map=overrides.get("ep_shard_map", False)))
    stack.enter_context(implicit_replication())
    return stack


def _lower_one(cfg, kind: str, specs: dict, mesh, overrides: dict, device) -> dict:
    """Run one step of a cell on fake tensors laid out on `mesh`; its costs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.perf_counter()
    with FakeTensorMode(), _marking_propagation():
        step, args = layout_cell(cfg, kind, specs, mesh, overrides, device)
        cost = LocalCost()
        cost.hold(args)
        arg_bytes = local_bytes(args)
        with sharded_context(mesh, overrides), cost:
            out = step(*args)
        out_bytes = local_bytes(out)
    return dict(run_s=time.perf_counter() - t0, flops=float(cost.flops),
                bytes=float(cost.bytes), records=cost.records, arg_bytes=arg_bytes,
                temp_bytes=cost.peak, output_bytes=out_bytes)


def lower_cell(arch: str, shape: str, *, multi_pod: bool, plan: str = "baseline",
               device_type: Optional[str] = None, cfg=None):
    """One (arch × shape) cell on the production mesh, rank 0 of a fake world
    of 256 (16 × 16) or 512 (2 × 16 × 16): returns (record, memory, cost,
    None) as the reference does; the record has its keys. `cfg` replaces
    the arch's config (a reduced one, say). On the card by default;
    `device_type="cpu"` lays the mesh out over CPU tensors."""
    from repro_torch.api.pipeline import PlanMemory

    cfg = configs.get_config(arch) if cfg is None else cfg
    overrides: dict = {}
    if plan != "baseline":
        from repro_torch.launch import plans

        cfg, overrides = plans.apply_plan(cfg, arch, shape, plan)
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device_type='cpu' to lay the production "
                               "mesh out over CPU tensors")
        device_type = "cuda"
    seq, gb, kind = configs.SHAPES[shape]
    chips = math.prod(PRODUCTION_MESHES[bool(multi_pod)][0])
    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device_type)
        dev = torch.device(device_type, torch.cuda.current_device()) if device_type == "cuda" \
            else torch.device("cpu")
        run = _lower_one(cfg, kind, input_specs(cfg, shape), mesh, overrides, dev)
    coll = summarize_collectives(run["records"])
    flops, hbm, link = run["flops"], run["bytes"], coll.total_link_bytes
    terms = roofline_terms(flops, hbm, link)
    mflops = model_flops(cfg, kind, seq, gb, chips=chips)
    rec = dict(
        arch=arch,
        shape=shape,
        mesh="2x16x16" if multi_pod else "16x16",
        plan=plan,
        chips=chips,
        kind=kind,
        compile_s=round(run["run_s"], 2),
        flops_per_device=flops,
        hbm_bytes_per_device=hbm,
        link_bytes_per_device=link,
        raw_flops_uncorrected=flops,
        scan_corrected=False,
        collectives={k: v for k, v in coll.per_op.items()},
        model_flops_per_device=mflops,
        useful_flops_frac=(mflops / flops) if flops else None,
        arg_bytes=run["arg_bytes"],
        temp_bytes=run["temp_bytes"],
        output_bytes=run["output_bytes"],
        per_device_hbm_total=run["arg_bytes"] + run["temp_bytes"] + run["output_bytes"],
        **terms,
    )
    mem = PlanMemory(run["arg_bytes"], run["arg_bytes"], run["temp_bytes"])
    return rec, mem, {"flops": flops, "bytes accessed": hbm}, None


def run_rank0(arch: str, shape: str, *, multi_pod: bool = False, steps: int = 8,
              device=None, seed: int = 0, cfg=None) -> dict:
    """Rank 0 of a decode cell for real: inside a fake world of the
    production mesh's size, this rank's shards of the parameters (bf16),
    the caches and the tokens, drawn from `seed` on `device` (the card by
    default), take `steps` decode steps from cache position seq - steps
    (the fake world's collectives move no data: each hands this rank its
    own pieces back). Returns the rank's argument bytes on the device, the
    allocator's peak, the wall a step and the last logits' local shape and
    finiteness."""
    from repro_torch.kernels import dispatch

    cfg = configs.get_config(arch) if cfg is None else cfg
    seq, gb, kind = configs.SHAPES[shape]
    if kind != "decode":
        raise ValueError(f"run_rank0 runs decode cells; {shape} is a {kind} cell")
    dev = dispatch.resolve_device(device)
    chips = math.prod(PRODUCTION_MESHES[bool(multi_pod)][0])
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    def fill(shape_, dtype, device_):
        if dtype.is_floating_point:
            return (torch.randn(shape_, generator=gen, device=device_) * 0.02).to(dtype)
        return torch.randint(0, cfg.vocab, shape_, generator=gen, device=device_, dtype=dtype)

    specs = input_specs(cfg, shape)
    start = seq - steps
    for c in specs["caches"]:
        if hasattr(c, "pos"):
            c.pos = start
    cuda = dev.type == "cuda"
    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=dev.type)
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        step, (params, caches, batch) = layout_cell(cfg, kind, specs, mesh, {}, dev, fill)
        arg_bytes = local_bytes((params, caches, batch))
        b_shard = batch_shardings(specs["batch"], mesh)
        walls = []
        with sharded_context(mesh, {}):
            for i in range(steps):
                if i:  # the next tokens
                    batch = place_batch(specs["batch"], b_shard, dev, fill)
                batch["pos"] = start + i
                t0 = time.perf_counter()
                logits, caches = step(params, caches, batch)
                if cuda:
                    torch.cuda.synchronize(dev)
                walls.append(time.perf_counter() - t0)
        local = logits.to_local()
    return dict(arch=arch, shape=shape, chips=chips, steps=steps, start_pos=start,
                arg_bytes=arg_bytes, step_s=walls, logits_local_shape=tuple(local.shape),
                logits_finite=bool(torch.isfinite(local.float()).all()),
                max_memory_allocated=torch.cuda.max_memory_allocated(dev) if cuda else None)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"], default="pod")
    ap.add_argument("--plan", default="baseline")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="the mesh's device type (default: the card)")
    ap.add_argument("--graph-engine", action="store_true",
                    help="also dry-run the subgraph-centric BSP engine (paper core)")
    args = ap.parse_args(argv)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    archs = configs.ARCHS if (args.all or args.arch is None) else [args.arch]
    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]

    for arch in archs:
        shapes = configs.runnable_shapes(arch)
        if args.shape:
            if args.shape not in shapes:
                print(f"[skip] {arch} × {args.shape}: not runnable")
                continue
            shapes = [args.shape]
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}__{args.plan}"
                try:
                    rec, _, _, _ = lower_cell(arch, shape, multi_pod=mp, plan=args.plan,
                                              device_type=args.device)
                    print(f"[ok] {tag}: run={rec['compile_s']}s "
                          f"bottleneck={rec['bottleneck']} bound={rec['bound_s']:.4f}s "
                          f"hbm/dev={rec['per_device_hbm_total']/2**30:.2f}GiB "
                          f"useful={rec['useful_flops_frac']:.3f}")
                    (outdir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
                except Exception as e:
                    print(f"[FAIL] {tag}: {e}")
                    traceback.print_exc()
                    (outdir / f"{tag}.FAIL").write_text(str(e))

    if args.graph_engine:
        from repro_torch.launch.graph_dryrun import run_graph_dryrun

        for mp in meshes:
            rec = run_graph_dryrun(multi_pod=mp, device=args.device)
            tag = f"graph_bsp__cc__{'mp' if mp else 'sp'}"
            (outdir / f"{tag}.json").write_text(json.dumps(rec, indent=1, default=str))
            print(f"[ok] {tag}: {rec['bottleneck']} bound={rec['bound_s']:.6f}s")


if __name__ == "__main__":
    main()
