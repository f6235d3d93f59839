"""Port parity, the LM half of the AOT module's layout: `launch.shapes`,
`launch.sharding`, `models.pspec`, `launch.plans` and `launch.elastic`,
against the reference's `repro.launch` / `repro.models.pspec`.

Exact: every parameter's, optimizer state's, cache's and batch leaf's spec
for every arch at full width on both production meshes (16 x 16 over
("data", "model") and 2 x 16 x 16 over ("pod", "data", "model")), the
reference's on a `jax.sharding.AbstractMesh` of the same shape (its stacked
leaves' leading group dim dropped); `input_specs` shapes and dtypes for
every runnable (arch, shape); `apply_plan` component by component.

Sharded numerics: a spawned gloo world of 4 CPU ranks, mesh (2, 2) over
("data", "model"), runs reduced llama3_2_3b, reduced phi3_5_moe (baseline
and plan ep) and reduced mamba2_780m with DTensor parameters and batches: the train
step's loss, grad norm and updated parameters, and a prefill plus 4 decode
steps' logits, against the same steps unsharded in the same process, to
f32 limits (sums taken in another order across the shards: RTOL / ATOL
below; AdamW's eps is 1e-3 there, so that its first update is smooth in
the gradient). The ranks also save a checkpoint laid out on mesh (4, 1) and
restore it onto (2, 2) (`reshard_checkpoint`): each rank's shard equals the
saved tensor's slice, exactly. The ranks start when the module starts
(`python -c CHILD`, RANK / WORLD_SIZE, a `file://` rendezvous, 60 s
collective and 240 s process timeouts) and run beside the in-process tests.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as ref_configs
from repro.launch import plans as ref_plans
from repro.launch import shapes as ref_shapes
from repro.launch import sharding as ref_sharding
from repro.models.transformer import init_params as ref_init_params
from repro_torch import configs
from repro_torch.launch import mesh as pt_mesh
from repro_torch.launch import plans, shapes, sharding
from repro_torch.models import pspec
from repro_torch.models.transformer import empty_params

SRC = str(Path(__file__).resolve().parents[1] / "src")
MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}
RTOL, ATOL = 2e-5, 2e-6  # f32: the sharded sums run in another order
WORLD = 4


def _norm(spec) -> tuple:
    """A spec's entries as None or a tuple of axis names (JAX writes a
    one-name tuple as the name)."""
    return tuple(None if e is None else ((e,) if isinstance(e, str) else tuple(e)) for e in spec)


def _ref_path(name: str, cfg) -> tuple[str, bool]:
    """A port parameter name → (the reference leaf's '/' path, stacked)."""
    parts = name.split(".")
    if parts[0] == "layers":
        return "/".join(["groups", f"layer_{int(parts[1]) % len(cfg.group)}"] + parts[2:]), True
    if parts[0] == "enc_layers":
        return "/".join(["enc_groups", "layer_0"] + parts[2:]), True
    return name, False


def _ref_specs(tree, mesh, fsdp) -> dict:
    specs = ref_sharding._tree_specs(tree, mesh, fsdp)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(k.key) for k in path): s for path, s in flat}


@pytest.fixture(scope="module")
def production_meshes():
    """{multi_pod: the port's production mesh}, each laid out in a fake
    world of its size that is destroyed before the next is made; the
    rules read only the mesh's names and sizes, which outlive the world."""
    out = {}
    for mp in (False, True):
        with pt_mesh.fake_world(256 * (2 if mp else 1)):
            out[mp] = pt_mesh.make_production_mesh(multi_pod=mp, device_type="cpu")
    return out


def _meshes(production_meshes, mp):
    return production_meshes[mp], AbstractMesh(*MESHES[mp])


@pytest.mark.parametrize("mp", (False, True), ids=("pod", "multipod"))
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_and_opt_state_specs_match_reference(production_meshes, arch, mp):
    mesh, ref_mesh = _meshes(production_meshes, mp)
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    ref_tree = jax.eval_shape(lambda: ref_init_params(ref_cfg, jax.random.PRNGKey(0),
                                                      jnp.bfloat16))
    params = empty_params(cfg, device="meta", dtype=torch.bfloat16)
    dp = tuple(a for a in MESHES[mp][1] if a != "model")
    for fsdp, ref_fsdp in ((None, dp), ((), None)):  # FSDP, and the serving layout
        want = _ref_specs(ref_tree, ref_mesh, ref_fsdp)
        got = sharding.param_shardings(cfg, params, mesh, fsdp=fsdp)
        assert set(got) == {n for n, _ in params.named_parameters()}
        for name, ns in got.items():
            path, stacked = _ref_path(name, cfg)
            ref = _norm(want[path])
            assert _norm(ns.spec) == (ref[1:] if stacked else ref), name
        opt = sharding.opt_state_shardings(got, mesh)
        assert opt["mu"] is got and opt["nu"] is got and opt["step"].spec == sharding.P()
    ref_opt = ref_sharding.opt_state_shardings({}, ref_mesh)
    assert tuple(ref_opt["step"].spec) == tuple(opt["step"].spec)


@pytest.mark.parametrize("mp", (False, True), ids=("pod", "multipod"))
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_cache_and_batch_specs_match_reference(production_meshes, arch, mp):
    mesh, ref_mesh = _meshes(production_meshes, mp)
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    n = len(cfg.group)
    for shape in configs.runnable_shapes(arch):
        spec, ref = shapes.input_specs(cfg, shape), ref_shapes.input_specs(ref_cfg, shape)
        got = sharding.batch_shardings(spec["batch"], mesh)
        want = ref_sharding.batch_shardings(ref["batch"], ref_mesh)
        assert set(got) == set(want)
        for k in got:
            assert _norm(got[k].spec) == _norm(want[k].spec), (shape, k)
        if spec["kind"] != "decode":
            continue
        got = sharding.cache_specs(cfg, spec["caches"], mesh)
        want = ref_sharding.cache_specs(ref_cfg, ref["caches"], ref_mesh)
        for layer, fields in enumerate(got):
            slot = want[f"layer_{layer % n}"]
            for field, ns in fields.items():
                leaf = slot["kv" if field in ("k", "v") else "ssm"][field]
                assert _norm(ns.spec) == _norm(leaf.spec)[1:], (shape, layer, field)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_input_specs_match_reference(arch):
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    n = len(cfg.group)
    for shape in configs.runnable_shapes(arch):
        got, want = shapes.input_specs(cfg, shape), ref_shapes.input_specs(ref_cfg, shape)
        assert got["kind"] == want["kind"] and got.get("max_seq") == want.get("max_seq")
        assert set(got["batch"]) == set(want["batch"])
        for k, t in got["batch"].items():
            w = want["batch"][k]
            if k == "pos":  # a Python int: the host reads it (the cache holds seq - 1 keys)
                assert w.shape == () and t == configs.SHAPES[shape][0] - 1
                continue
            assert t.device.type == "meta" and tuple(t.shape) == w.shape, (shape, k)
            assert str(t.dtype).split(".")[-1] == str(w.dtype), (shape, k)
        if got["kind"] != "decode":
            continue
        assert len(got["caches"]) == cfg.n_layers
        for layer, c in enumerate(got["caches"]):
            slot = want["caches"][f"layer_{layer % n}"]
            ref = slot["kv"] if "kv" in slot else slot["ssm"]
            for field in ("k", "v") if "kv" in slot else ("state", "conv"):
                t, w = getattr(c, field), ref[field]
                assert w.shape == (cfg.n_groups,) + tuple(t.shape), (layer, field)
                assert str(t.dtype).split(".")[-1] == str(w.dtype), (layer, field)
            if "kv" in slot:
                assert c.pos == configs.SHAPES[shape][0] - 1


def test_placements_rules(production_meshes):
    from torch.distributed.tensor import Replicate, Shard

    mesh = production_meshes[True]
    P = sharding.P
    assert sharding.placements(P(("pod", "data"), "model"), mesh) == (Shard(0), Shard(0), Shard(1))
    assert sharding.placements(P(None, ("data",)), mesh) == (Replicate(), Shard(1), Replicate())
    assert sharding.placements(P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        sharding.placements(P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="mesh order"):
        sharding.placements(P("data", "data"), mesh)
    with pytest.raises(ValueError, match="does not have"):
        sharding.placements(P("seq"), mesh)
    assert sharding.local_shape((64, 48, 5), P(("pod", "data"), "model", None), mesh) == \
        (2, 3, 5)


PLANS = ("baseline", "vp", "sp", "bf16g", "cap1", "repl", "don", "ep", "vp+sp+bf16g",
         "repl+don", "cap1+ep")


@pytest.mark.parametrize("plan", PLANS)
def test_apply_plan_matches_reference(plan):
    cfg, ref_cfg = configs.get_config("phi3_5_moe"), ref_configs.get_config("phi3_5_moe")
    got_cfg, got = plans.apply_plan(cfg, "phi3_5_moe", "train_4k", plan)
    want_cfg, want = ref_plans.apply_plan(ref_cfg, "phi3_5_moe", "train_4k", plan)
    assert got == want
    assert got_cfg.moe.capacity_factor == want_cfg.moe.capacity_factor
    assert (got_cfg is cfg) == (want_cfg is ref_cfg)


@pytest.mark.parametrize("plan", ("bogus", "vp+nope", "cap1@dense"))
def test_apply_plan_errors(plan):
    if plan == "cap1@dense":  # cap1 on a config with no MoE: the reference asserts
        with pytest.raises(AssertionError):
            ref_plans.apply_plan(ref_configs.get_config("llama3_2_3b"), "x", "train_4k", "cap1")
        with pytest.raises(ValueError, match="MoE"):
            plans.apply_plan(configs.get_config("llama3_2_3b"), "x", "train_4k", "cap1")
        return
    for mod, cfg in ((plans, configs.get_config("llama3_2_3b")),
                     (ref_plans, ref_configs.get_config("llama3_2_3b"))):
        with pytest.raises(ValueError, match="unknown plan component"):
            mod.apply_plan(cfg, "llama3_2_3b", "train_4k", plan)


def test_pspec_context(production_meshes):
    """Outside `activation_axes`, or on a plain tensor, constrain and layout
    return their input; the context is thread-local and nests."""
    x = torch.ones(4, 4)
    assert pspec.constrain(x, "dp", None) is x and pspec.layout(x, None, "tp") is x
    assert pspec.axes() is None and pspec.ep_shard_map() is None and pspec.fits(3)
    mesh = production_meshes[False]
    with pspec.activation_axes(mesh, dp=("data",), ep_shard_map=True):
        assert pspec.constrain(x, "dp", None) is x
        assert pspec.ep_shard_map() == (mesh, ("data",), "model")
        assert pspec.fits(32) and not pspec.fits(24)
        with pspec.activation_axes(mesh, sp="model"):
            assert pspec.axes()["sp"] == "model" and pspec.ep_shard_map() is None
        assert pspec.ep_shard_map() is not None
    assert pspec.axes() is None


# ----------------------------------------- spawned gloo world of 4 ranks

CHILD = r"""
import dataclasses, datetime, functools, json, os, sys
from pathlib import Path
import numpy as np, torch, torch.distributed as dist

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
work = Path(os.environ["LM_WORK"])
dist.init_process_group("gloo", init_method=f"file://{work}/rendezvous", rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=60))
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, distribute_tensor
from repro_torch import configs
from repro_torch.checkpoint import ckpt
from repro_torch.launch import dryrun, elastic, plans, shapes, sharding
from repro_torch.models import steps, transformer
from repro_torch.optim.adam import AdamWConfig, init_opt_state

torch.manual_seed(0)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
out = {}
B, S, NEW = 4, 16, 4


def full(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().numpy()


def params_of(cfg):
    p = transformer.init_params(cfg, torch.Generator().manual_seed(1), torch.float32)
    for layer in p.modules():  # norms and biases away from zero
        for name, q in layer.named_parameters(recurse=False):
            if not q.any():
                q.data = torch.randn(q.shape, generator=torch.Generator().manual_seed(2)) * 0.1
    return p


def sharded(cfg, p):
    sh = sharding.param_shardings(cfg, p, mesh)
    for name, q in list(p.named_parameters()):
        owner, leaf = name.rpartition(".")[::2]
        mod = p.get_submodule(owner) if owner else p
        setattr(mod, leaf, torch.nn.Parameter(
            distribute_tensor(q.detach(), mesh, sh[name].placements), requires_grad=False))
    return p


def batch_of(b, cfg):
    return {k: distribute_tensor(v, mesh, ns.placements)
            for (k, v), ns in zip(b.items(), sharding.batch_shardings(b, mesh).values())}


gen = torch.Generator().manual_seed(3)
for case, arch, plan in (("llama", "llama3_2_3b", "baseline"), ("phi3", "phi3_5_moe", "baseline"),
                         ("phi3_ep", "phi3_5_moe", "ep"), ("mamba", "mamba2_780m", "baseline")):
    cfg = configs.reduced_config(arch)
    ov = {"ep_shard_map": True} if plan == "ep" else {}
    toks = torch.randint(0, cfg.vocab, (B, S + 1 + NEW), generator=gen, dtype=torch.int32)
    train = {"tokens": toks[:, :S], "targets": toks[:, 1:S + 1]}
    # eps 1e-3: AdamW's first update g / (|g| + eps) is then smooth in g, so
    # a gradient element near 0 that the shards sum in another order moves
    # its parameter by a rounding, not by up to 2 lr.
    opt = AdamWConfig(warmup_steps=1, eps=1e-3)
    for mode in ("plain", "sharded"):
        p = params_of(cfg)
        b = dict(train)
        ctx = None
        if mode == "sharded":
            p, b = sharded(cfg, p), batch_of(b, cfg)
            ctx = dryrun.sharded_context(mesh, ov)
            ctx.__enter__()
        st = init_opt_state(p, opt)
        p, st, m = steps.make_train_step(cfg, opt, remat=True)(p, st, b)
        out[f"{case}_{mode}_loss"] = full(m["loss"])
        out[f"{case}_{mode}_grad_norm"] = full(m["grad_norm"])
        for name, q in p.named_parameters():
            out[f"{case}_{mode}_param_{name}"] = full(q)
        p = params_of(cfg)
        if mode == "sharded":
            p = sharded(cfg, p)
        pre = {"tokens": toks[:, :S]}
        pre = batch_of(pre, cfg) if mode == "sharded" else pre
        layout = None if mode == "plain" else functools.partial(sharding.lay_out_caches, mesh=mesh)
        logits, caches = steps.make_prefill_step(cfg, S + NEW, cache_layout=layout)(p, pre)
        out[f"{case}_{mode}_prefill"] = full(logits)
        serve = steps.make_serve_step(cfg)
        for i in range(NEW):
            b = {"token": toks[:, S + i:S + i + 1]}
            b = batch_of(b, cfg) if mode == "sharded" else b
            logits, caches = serve(p, caches, dict(b, pos=S + i))
            out[f"{case}_{mode}_decode{i}"] = full(logits)
        if ctx is not None:
            ctx.__exit__(None, None, None)

# decode_attention on DTensors: kv heads split unevenly (6 over 4, and over
# 2 x 2) and evenly, each against the plain version on the whole tensors.
from torch.distributed.tensor import Shard
from repro_torch.kernels import decode_attn
for case, shape, names, hq, hkv, kv_pl in (
        ("heads1d", (4,), ("model",), 12, 6, (Shard(2),)),
        ("heads2d", (2, 2), ("data", "model"), 12, 6, (Shard(2), Shard(2))),
        ("even", (2, 2), ("data", "model"), 16, 4, (Shard(0), Shard(2)))):
    m = init_device_mesh("cpu", shape, mesh_dim_names=names)
    q = torch.randn(B, hq, 32, generator=gen)
    k, v = (torch.randn(B, 40, hkv, 32, generator=gen) for _ in range(2))
    q_pl = tuple(Shard(1) if p == Shard(2) else p for p in kv_pl)
    got = decode_attn.decode_attention(*(distribute_tensor(t, m, pl) for t, pl in
                                         ((q, q_pl), (k, kv_pl), (v, kv_pl))), start=3, end=37)
    out[f"attn_{case}_got"] = full(got)
    out[f"attn_{case}_want"] = decode_attn.decode_attention_plain(q, k[:, 3:37], v[:, 3:37]).numpy()

# Elastic: saved from mesh (4, 1), restored onto (2, 2).
cfg = configs.reduced_config("llama3_2_3b")
old = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
p = params_of(cfg)
sh = sharding.param_shardings(cfg, p, old)
laid = elastic.reshard(dict(p.named_parameters()), sh)
tree = {n: t.full_tensor() for n, t in laid.items()}
if rank == 0:
    ckpt.save(work / "ckpt", 5, {"params": tree})
dist.barrier()
back = elastic.reshard_checkpoint(cfg, str(work / "ckpt"), 5, mesh)
bad = []
for n, t in back.items():
    want = dict(p.named_parameters())[n].detach()
    ns = sharding.param_shardings(cfg, p, mesh)[n]
    local = t.to_local()
    sl = []
    for d, size in enumerate(local.shape):
        idx = 0
        for i, pl in enumerate(ns.placements):
            if getattr(pl, "dim", None) == d:
                idx = idx * mesh.size(i) + mesh.get_local_rank(i)
        sl.append(slice(idx * size, (idx + 1) * size))
    if tuple(t.placements) != ns.placements or not torch.equal(local, want[tuple(sl)]):
        bad.append(n)
out["elastic_bad"] = np.array(len(bad))
out["elastic_leaves"] = np.array(len(back))
errors = {"bad": bad, "imported": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))}
np.savez(work / f"rank{rank}.npz", **out)
(work / f"rank{rank}.json").write_text(json.dumps(errors))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module", autouse=True)
def spawning(tmp_path_factory):
    """Starts the world of 4 when the module starts; `spawned` waits."""
    work = tmp_path_factory.mktemp("lm_world4")
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(WORLD), LM_WORK=str(work),
                   PYTHONPATH=SRC, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-c", CHILD], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    yield work, procs
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def spawned(spawning):
    work, procs = spawning
    failed = []
    for r, proc in enumerate(procs):
        try:
            log, _ = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for other in procs:
                other.kill()
            log, _ = proc.communicate()
            failed.append(f"rank {r} timed out:\n{log[-6000:]}")
            continue
        if proc.returncode:
            failed.append(f"rank {r} exited {proc.returncode}:\n{log[-6000:]}")
    assert not failed, "\n".join(failed)
    return ([dict(np.load(work / f"rank{r}.npz")) for r in range(WORLD)],
            [json.loads((work / f"rank{r}.json").read_text()) for r in range(WORLD)])


@pytest.mark.parametrize("case", ("llama", "phi3", "phi3_ep", "mamba"))
def test_sharded_steps_match_unsharded(spawned, case):
    outs, _ = spawned
    for o in outs:  # every rank holds the whole of each result
        keys = [k for k in o if k.startswith(f"{case}_plain_")]
        assert len(keys) > 10
        for k in keys:
            got, want = o[k.replace("_plain_", "_sharded_")], o[k]
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=k)
        np.testing.assert_array_equal(o[f"{case}_plain_loss"], outs[0][f"{case}_plain_loss"])


@pytest.mark.parametrize("case", ("heads1d", "heads2d", "even"))
def test_decode_attention_on_dtensors_spawned(spawned, case):
    """The op's sharding rule keeps a rank's query heads with their kv
    heads: uneven head splits are gathered first, even ones run split."""
    outs, _ = spawned
    for o in outs:
        np.testing.assert_allclose(o[f"attn_{case}_got"], o[f"attn_{case}_want"],
                                   rtol=RTOL, atol=ATOL)


def test_elastic_reshard_spawned(spawned):
    outs, meta = spawned
    for o, m in zip(outs, meta):
        assert int(o["elastic_bad"]) == 0, m["bad"]
        assert int(o["elastic_leaves"]) == len(list(empty_params(
            configs.reduced_config("llama3_2_3b"), device="meta").parameters()))
        assert m["imported"] == []
