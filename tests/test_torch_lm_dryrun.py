"""Port parity, the LM dry-run on the CPU (`launch.dryrun`, the recorder's
functional collectives in `launch.roofline`, the custom op
`repro_torch::decode_attention`), against the reference's
`repro.launch.dryrun` / `repro.launch.roofline` and its XLA lowering.

Exact: a reduced cell's record keys and `model_flops` against the
reference's; the argument bytes of reduced phi3_5_moe's train step on an
8-device (4, 2) mesh against XLA's `memory_analysis().argument_size_in_
bytes` (a subprocess with 8 host devices); a sharded matmul's recorded
all-gather and per-device FLOPs against a hand reckoning from the local
shapes; the custom op's FLOP formula; the real rank-0 run's argument bytes
against the fake record's. Every fake world is started inside a test and
destroyed before it ends.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.configs import reduced_config as ref_reduced
from repro.launch import roofline as ref_roof
from repro_torch.configs import SHAPES, reduced_config
from repro_torch.kernels import decode_attn
from repro_torch.launch import dryrun, shapes
from repro_torch.launch import mesh as pt_mesh
from repro_torch.launch import roofline as roof

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")


def _reference_record_keys() -> set:
    """The keys of the reference dry-run's record (its `rec = dict(...)`,
    read from the source: importing it would set XLA_FLAGS in this
    process) and of its roofline terms."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    keys = None
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "rec"
                and getattr(getattr(node.value, "func", None), "id", "") == "dict"):
            keys = {k.arg for k in node.value.keywords if k.arg}
    return keys | set(ref_roof.roofline_terms(1.0, 1.0, 1.0))


def _fake_mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def test_recorder_sees_a_sharded_matmul():
    """x [M, K] laid out (Shard(0), Replicate()) @ w [K, N] laid out
    (Shard(0), Shard(1)) on a 16 x 16 fake world: DTensor all-gathers w's K
    over "data" (a functional all-gather the recorder keeps, bytes as
    reckoned), and the device's FLOPs are 2·M·K·N of the local shapes; the
    global-shape propagation is not counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    M, K, N = 1 << 20, 3072, 8192
    with pt_mesh.fake_world(256):
        mesh = pt_mesh.make_production_mesh(device_type="cpu")
        with FakeTensorMode(), dryrun._marking_propagation():
            x = DTensor.from_local(torch.empty(M // 16, K), mesh, (Shard(0), Replicate()),
                                   run_check=False, shape=(M, K), stride=(K, 1))
            w = DTensor.from_local(torch.empty(K // 16, N // 16), mesh, (Shard(0), Shard(1)),
                                   run_check=False, shape=(K, N), stride=(N, 1))
            cost = dryrun.LocalCost()
            with cost:
                y = x @ w
            assert tuple(y.placements) == (Shard(0), Shard(1))
            assert tuple(y.to_local().shape) == (M // 16, N // 16)
    gathers = [r for r in cost.records if r.kind == "all-gather"]
    assert [(r.out_bytes, r.group_size, r.op) for r in gathers] == \
        [(K * (N // 16) * 4, 16, "all_gather_into_tensor")]
    assert len(cost.records) == 1
    assert cost.flops == 2 * (M // 16) * K * (N // 16)
    link = roof.summarize_collectives(cost.records).total_link_bytes
    assert link == K * (N // 16) * 4 * 15 / 16
    with torch.utils.flop_counter.FlopCounterMode(display=False) as global_count:
        torch.empty(M // 16, K, device="meta") @ torch.empty(K, N // 16, device="meta")
    assert global_count.get_total_flops() == cost.flops


def test_decode_attention_custom_op():
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(3, 8, 32, generator=gen)
    k, v = (torch.randn(3, 40, 2, 32, generator=gen) for _ in range(2))
    torch.library.opcheck(torch.ops.repro_torch.decode_attention.default, (q, k, v, 0.0, 5, 33))
    torch.library.opcheck(torch.ops.repro_torch.decode_attention.default, (q, k, v, 30.0, 0, 40))
    got = decode_attn.decode_attention(q, k, v, start=5, end=33)
    assert torch.equal(got, decode_attn.decode_attention_plain(q, k[:, 5:33], v[:, 5:33]))
    with torch.utils.flop_counter.FlopCounterMode(display=False) as count:
        decode_attn.decode_attention(q, k, v, start=5, end=33)
    assert count.get_total_flops() == 4 * 3 * 8 * 28 * 32
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        out = torch.ops.repro_torch.decode_attention(torch.empty(2, 4, 16, dtype=torch.bfloat16),
                                                     torch.empty(2, 9, 2, 16, dtype=torch.bfloat16),
                                                     torch.empty(2, 9, 2, 16, dtype=torch.bfloat16),
                                                     0.0, 0, 9)
    assert out.shape == (2, 4, 16) and out.dtype == torch.bfloat16


@pytest.mark.parametrize("layout", ("batch", "heads", "sequence", "uneven_heads"))
def test_decode_attention_sharding_rule(layout):
    """On a 2 x 4 fake world: batch over "data" and kv heads over "model"
    run locally with no collective; a cache sharded on its sequence, with
    kv heads that do not divide "model" (llama3_2_3b's case), is gathered
    first (one all-gather each of k and v); kv heads split unevenly (6
    over 4) are gathered with their query heads (q, k and v), never run
    as uneven chunks (tests/test_torch_lm_sharding.py holds the values)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    B, S, D = 4, 64, 32
    Hq, Hkv = {"sequence": (12, 2), "uneven_heads": (12, 6)}.get(layout, (16, 4))
    kv_pl = {"batch": (Shard(0), Replicate()), "heads": (Shard(0), Shard(2)),
             "sequence": (Shard(0), Shard(1)), "uneven_heads": (Shard(0), Shard(2))}[layout]
    q_pl = (Shard(0), Shard(1) if layout in ("heads", "uneven_heads") else Replicate())
    with pt_mesh.fake_world(8):
        mesh = _fake_mesh((2, 4), ("data", "model"))
        with FakeTensorMode(), dryrun._marking_propagation():
            def place(shape, pl):
                local = list(shape)
                for i, p in enumerate(pl):
                    if isinstance(p, Shard):
                        local[p.dim] //= mesh.size(i)
                return DTensor.from_local(torch.empty(local), mesh, pl, run_check=False,
                                          shape=shape, stride=dryrun._contiguous_stride(shape))

            q = place((B, Hq, D), q_pl)
            k, v = place((B, S, Hkv, D), kv_pl), place((B, S, Hkv, D), kv_pl)
            cost = dryrun.LocalCost()
            with cost:
                out = decode_attn.decode_attention(q, k, v, start=3, end=60)
            local_b = B // 2
            local_h = Hq // 4 if layout == "heads" else Hq
            assert tuple(out.to_local().shape) == (local_b, local_h, D)
    gathers = [r for r in cost.records if r.kind == "all-gather"]
    assert len(gathers) == {"sequence": 2, "uneven_heads": 3}.get(layout, 0)
    assert len(cost.records) == len(gathers)
    assert cost.flops == 4 * local_b * local_h * 57 * D


CELLS = (("llama3_2_3b", "train_4k", "baseline"), ("llama3_2_3b", "decode_32k", "baseline"),
         ("llama3_2_3b", "prefill_32k", "baseline"), ("phi3_5_moe", "train_4k", "baseline"),
         ("mamba2_780m", "long_500k", "baseline"))


@pytest.mark.parametrize("arch,shape,plan", CELLS)
def test_reduced_cell_record(arch, shape, plan):
    """A reduced config's cell at the production shapes, rank 0 of a fake
    world of 256 on the CPU: the reference's record keys, its model_flops
    exactly, no scan correction, and figures that hold together."""
    rec, mem, cost, _ = dryrun.lower_cell(arch, shape, multi_pod=False, plan=plan,
                                          device_type="cpu", cfg=reduced_config(arch))
    assert set(rec) == _reference_record_keys()
    seq, gb, kind = SHAPES[shape]
    assert rec["model_flops_per_device"] == ref_roof.model_flops(ref_reduced(arch), kind, seq, gb,
                                                                 chips=256)
    assert rec["chips"] == 256 and rec["mesh"] == "16x16" and rec["kind"] == kind
    assert rec["scan_corrected"] is False
    assert rec["raw_flops_uncorrected"] == rec["flops_per_device"] == cost["flops"] > 0
    assert rec["hbm_bytes_per_device"] == cost["bytes accessed"] > 0
    assert mem.argument_size_in_bytes == rec["arg_bytes"] > 0 and rec["temp_bytes"] > 0
    assert rec["per_device_hbm_total"] == rec["arg_bytes"] + rec["temp_bytes"] + \
        rec["output_bytes"]
    assert rec["link_bytes_per_device"] > 0 and rec["collectives"]
    assert rec["bound_s"] == max(rec["compute_s"], rec["memory_s"], rec["collective_s"])


def test_main_writes_records_and_failures(tmp_path):
    dryrun.main(["--arch", "mamba2_780m", "--shape", "long_500k", "--device", "cpu",
                 "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "mamba2_780m__long_500k__sp__baseline.json").read_text())
    assert rec["arch"] == "mamba2_780m" and rec["kind"] == "decode"
    dryrun.main(["--arch", "mamba2_780m", "--shape", "long_500k", "--device", "cpu",
                 "--plan", "bogus", "--out", str(tmp_path)])
    fail = (tmp_path / "mamba2_780m__long_500k__sp__bogus.FAIL").read_text()
    assert "unknown plan component" in fail


def test_rank0_run_matches_the_fake_record():
    """The real run's shards of reduced llama3_2_3b x decode_32k on the CPU:
    their bytes equal the fake record's arg_bytes; the logits are finite
    and laid out over (data, model)."""
    cfg = reduced_config("llama3_2_3b")
    run = dryrun.run_rank0("llama3_2_3b", "decode_32k", steps=2, device="cpu", cfg=cfg)
    rec, *_ = dryrun.lower_cell("llama3_2_3b", "decode_32k", multi_pod=False, device_type="cpu",
                                cfg=cfg)
    assert run["arg_bytes"] == rec["arg_bytes"]
    assert run["logits_finite"] and run["logits_local_shape"] == (128 // 16, cfg.vocab // 16)
    assert run["start_pos"] == 32768 - 2 and len(run["step_s"]) == 2


def test_graph_stepper_takes_and_returns_its_rows():
    """The distributed runner holds only its rank's rows: the dry-run's
    rank of a fake world of 8 gets [1, ...] arrays in and [1, max_v + 1]
    values out, and the whole set's arrays are refused."""
    from repro_torch.api import GraphPipeline, SubgraphSpec
    from repro_torch.launch import graph_dryrun as gd

    spec = SubgraphSpec(8, 256, 512, 4)
    with pt_mesh.fake_world(8):
        mesh = _fake_mesh((8,), ("workers",))
        low = GraphPipeline.from_spec(spec).lower(mesh=mesh, program="cc", num_supersteps=2)
        arrays, init = gd.synthetic_shard(spec, "cc", device="cpu")
        run = gd.run_lowered(low, arrays, init)
        assert tuple(run.values.shape) == (1, 257) and run.iters.shape == (2, 1)
        with pytest.raises(ValueError, match="rows of the values"):
            low.stepper(arrays, init)
        with pytest.raises(ValueError, match="rows of each array"):
            low.stepper(arrays, init[:1])
    kinds = [r.kind for r in run.records]
    assert kinds[0] == kinds[-1] == "all-reduce" and "all-gather" not in kinds


XLA_CHILD = r"""
import json
import jax, jax.numpy as jnp
from repro.compat import make_mesh_compat
from repro.configs import reduced_config
from repro.launch.shapes import train_batch_specs
from repro.launch.sharding import batch_shardings, opt_state_shardings, param_shardings
from repro.models.pspec import activation_axes
from repro.models.steps import make_train_step
from repro.models.transformer import init_params
from repro.optim.adam import AdamWConfig, init_opt_state

cfg = reduced_config("phi3_5_moe")
mesh = make_mesh_compat((4, 2), ("data", "model"))
params = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16))
p_shard = param_shardings(cfg, params, mesh)
opt = AdamWConfig()
o_shape = jax.eval_shape(lambda: init_opt_state(params, opt))
o_shard = opt_state_shardings(p_shard, mesh)
batch = train_batch_specs(cfg, 32, 8)
with mesh, activation_axes(mesh, dp=("data",), tp="model"):
    step = make_train_step(cfg, opt, remat=True)
    compiled = jax.jit(step, in_shardings=(p_shard, o_shard, batch_shardings(batch, mesh)),
                       out_shardings=(p_shard, o_shard, None)).lower(params, o_shape,
                                                                     batch).compile()
print("RESULT", json.dumps(compiled.memory_analysis().argument_size_in_bytes))
"""


def test_arg_bytes_match_xla():
    """Reduced phi3_5_moe's train step on a (4, 2) mesh over ("data",
    "model"), run once on fake tensors in a fake world of 8: its per-device
    argument bytes (its shards of the bf16 parameters, the f32 AdamW
    states, the int32 step and the batch) equal XLA's argument size for
    the reference's step compiled over 8 host devices."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", XLA_CHILD], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    xla = json.loads(out.stdout.split("RESULT", 1)[1])
    cfg = reduced_config("phi3_5_moe")
    with pt_mesh.fake_world(8):
        mesh = _fake_mesh((4, 2), ("data", "model"))
        run = dryrun._lower_one(cfg, "train", dict(batch=shapes.train_batch_specs(cfg, 32, 8)),
                                mesh, {}, torch.device("cpu"))
    assert run["arg_bytes"] == xla
    assert run["flops"] > 0 and run["records"]
