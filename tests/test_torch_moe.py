"""Port parity, the MoE layer and expert placement: `repro_torch.models.moe`
and `repro_torch.core.placement` against `repro.models.moe` and
`repro.core.placement`, on the CPU.

Inputs are seeded numpy arrays (weights from the reference's `init_moe`,
carried across), at the reduced configs of phi3_5_moe and kimi_k2 (4
experts, top-2, d_model 64, d_ff 64): with their capacity_factor = E
(nothing drops) and with the published 1.25 on tokens that share most of
their direction, so that the router sends most of them to the same two
experts and the test sees assignments dropped.

Tolerances (f32): `moe_ffn` against the reference and the expert-parallel
partials against `moe_ffn`, atol 1e-5 (layers; the grouped products and
the combine sum in another order); `moe_ffn_ep` over gloo (worlds 2 and
4, spawned ranks with a file rendezvous, a 60 s collective and a 120 s
process timeout), atol 1e-5 against the reference, every rank equal;
`expert_perm` with the weights permuted to match against the plain call,
`torch.equal` (each expert's buffer holds the same rows in the same order,
and a token's two contributions add in either order to one value);
`aux_load_balance_loss`, 1e-6. Placement is host numpy on both sides:
permutations and reports bit for bit, on `examples/expert_placement.py`'s
zipf draw (E 64, D 8), on a draw whose popularities all tie (numpy's
unstable argsort orders the ties; the port keeps its call), and at E 16,
D 4 (phi3_5_moe's experts over four devices).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core import placement as ref_pl
from repro.models import moe as ref_moe
from repro_torch import configs
from repro_torch.core import placement as pl
from repro_torch.models import moe

SRC = str(Path(__file__).resolve().parents[1] / "src")
ATOL = 1e-5
WORLDS = (2, 4)


def _cfgs(name, cf=None):
    ref_cfg, cfg = ref_configs.reduced_config(name), configs.reduced_config(name)
    if cf is not None:
        ref_cfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, capacity_factor=cf))
                        for c in (ref_cfg, cfg))
    return ref_cfg, cfg


def _weights(ref_cfg, cfg, seed):
    """(reference params (numpy), port MoE) from the reference's init."""
    rp = {k: np.asarray(v) for k, v in
          ref_moe.init_moe(ref_cfg, jax.random.PRNGKey(seed), jnp.float32).items()}
    p = moe.MoE(cfg)
    for name, a in rp.items():
        setattr(p, name, torch.nn.Parameter(torch.from_numpy(a.copy()), requires_grad=False))
    return rp, p


def _x(cfg, B, S, seed, skew):
    """[B, S, d] f32. `skew`: every token is one shared vector plus small
    noise, so the router ranks the experts alike for most tokens."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if skew:
        x = (3.0 * rng.standard_normal(cfg.d_model) + 0.3 * x).astype(np.float32)
    return x


def _dropped(cfg, rp, x):
    """Assignments the capacity drops, from the router's top-k (numpy)."""
    T = x.shape[0] * x.shape[1]
    logits = x.reshape(T, -1) @ rp["router"]
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :cfg.moe.top_k]
    load = np.bincount(top.reshape(-1), minlength=cfg.moe.num_experts)
    return int(np.maximum(load - moe.capacity(cfg, T), 0).sum())


# (name, capacity_factor (None: the reduced config's E), B, S, skewed input)
MOE_CASES = {
    "phi3_no_drop": ("phi3_5_moe", None, 2, 16, False),
    "kimi_no_drop": ("kimi_k2", None, 3, 8, False),
    "phi3_drop": ("phi3_5_moe", 1.25, 2, 32, True),
    "kimi_drop": ("kimi_k2", 1.25, 4, 16, True),
}


def _case(case, seed=0):
    name, cf, B, S, skew = MOE_CASES[case]
    ref_cfg, cfg = _cfgs(name, cf)
    rp, p = _weights(ref_cfg, cfg, seed)
    x = _x(cfg, B, S, seed + 1, skew)
    drops = _dropped(cfg, rp, x)
    assert (drops > 0) == (cf is not None), (case, drops)  # cf 1.25 cases must drop
    return ref_cfg, cfg, rp, p, x, drops


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_ffn_matches_reference(case):
    ref_cfg, cfg, rp, p, x, drops = _case(case)
    want = ref_moe.moe_ffn(ref_cfg, {k: jnp.asarray(v) for k, v in rp.items()}, jnp.asarray(x))
    got = moe.moe_ffn(cfg, p, torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert (drops > 0) == (MOE_CASES[case][1] is not None)  # the capacity bites at 1.25


def test_capacity_matches_reference_rule():
    for name in ("phi3_5_moe", "kimi_k2"):
        for cf in (1.0, 1.25, 4.0):
            _, cfg = _cfgs(name, cf)
            for T in (1, 8, 13, 64, 1000, 8192):
                cap = int(T * cfg.moe.top_k / cfg.moe.num_experts * cf)
                assert moe.capacity(cfg, T) == max(8, -(-cap // 8) * 8)


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("case", ["phi3_no_drop", "phi3_drop", "kimi_drop"])
def test_moe_body_partials_sum_to_moe_ffn(case, world):
    """Each expert-parallel rank's partial output over its E/w experts
    (every other rank's assignments in the dump bucket), summed over the
    ranks, is `moe_ffn`: the same capacity and the same kept assignments,
    drops included."""
    _, cfg, _, p, x, _ = _case(case)
    xt = torch.from_numpy(x)
    want = moe.moe_ffn(cfg, p, xt).reshape(-1, cfg.d_model)
    total = torch.zeros_like(want)
    for r in range(world):
        sh = moe.shard_experts(cfg, p, r, world)
        assert sh.w_gate.shape[0] == cfg.moe.num_experts // world
        total += moe._moe_body(cfg, xt.reshape(-1, cfg.d_model), sh.router, sh.w_gate,
                               sh.w_in, sh.w_out, rank=r)
    np.testing.assert_allclose(total.numpy(), want.numpy(), rtol=0, atol=ATOL)


def test_moe_ffn_ep_without_a_group_is_moe_ffn():
    _, cfg, _, p, x, _ = _case("phi3_drop")
    xt = torch.from_numpy(x)
    assert torch.equal(moe.moe_ffn_ep(cfg, p, xt), moe.moe_ffn(cfg, p, xt))
    with pytest.raises(ValueError, match="do not shard"):
        moe.shard_experts(cfg, p, 0, 3)


CHILD = r"""
import datetime, json, os, sys
from pathlib import Path
import numpy as np, torch, torch.distributed as dist

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
work = Path(os.environ["MOE_WORK"])
dist.init_process_group("gloo", init_method=f"file://{work}/rendezvous", rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=60))
import dataclasses
from repro_torch import configs
from repro_torch.models import moe

job = json.loads((work.parent / "job.json").read_text())
inputs = np.load(work.parent / "inputs.npz")
out = {}
for case, (name, cf) in job.items():
    cfg = configs.reduced_config(name)
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    p = moe.MoE(cfg)
    for k in ("router", "w_gate", "w_in", "w_out"):
        setattr(p, k, torch.nn.Parameter(torch.from_numpy(inputs[f"{case}_{k}"]),
                                         requires_grad=False))
    mine = moe.shard_experts(cfg, p, rank, world)
    y = moe.moe_ffn_ep(cfg, mine, torch.from_numpy(inputs[f"{case}_x"]), group=dist.group.WORLD)
    out[case] = y.numpy()
dist.destroy_process_group()
np.savez(work / f"rank{rank}.npz", **out)
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "repro"))
sys.exit(3 if bad else 0)
"""


@pytest.fixture(scope="module")
def ep_inputs(tmp_path_factory):
    """The spawned worlds' inputs: per case, the weights and x, and the
    reference's output."""
    import json

    base = tmp_path_factory.mktemp("moe_ep")
    job, arrays, want = {}, {}, {}
    for case in ("phi3_no_drop", "phi3_drop", "kimi_drop"):
        ref_cfg, _, rp, _, x, _ = _case(case)
        name, cf = MOE_CASES[case][:2]
        job[case] = (name, cf)
        arrays.update({f"{case}_{k}": v for k, v in rp.items()}, **{f"{case}_x": x})
        want[case] = np.asarray(ref_moe.moe_ffn(ref_cfg, {k: jnp.asarray(v)
                                                           for k, v in rp.items()},
                                                jnp.asarray(x)))
    np.savez(base / "inputs.npz", **arrays)
    (base / "job.json").write_text(json.dumps(job))
    return base, want


@pytest.mark.parametrize("world", WORLDS)
def test_moe_ffn_ep_over_gloo_matches_reference(ep_inputs, world):
    """`moe_ffn_ep` over a gloo world of `world` spawned ranks (each holds
    E/w experts, one all_reduce): every rank returns the reference's
    `moe_ffn`, drops included, and imports neither jax nor the reference."""
    base, want = ep_inputs
    work = base / f"w{world}"
    work.mkdir()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), MOE_WORK=str(work),
                   PYTHONPATH=SRC, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-c", CHILD], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    failed = []
    try:
        for r, proc in enumerate(procs):
            try:
                log, _ = proc.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                failed.append(f"rank {r} timed out")
                continue
            if proc.returncode:
                failed.append(f"rank {r} exited {proc.returncode}:\n{log}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert not failed, "\n".join(failed)
    outs = [dict(np.load(work / f"rank{r}.npz")) for r in range(world)]
    for case, w in want.items():
        for o in outs:
            np.testing.assert_allclose(o[case], w, rtol=0, atol=ATOL, err_msg=case)
            np.testing.assert_array_equal(o[case], outs[0][case], err_msg=case)


@pytest.mark.parametrize("case", ["phi3_no_drop", "phi3_drop", "kimi_no_drop", "kimi_drop"])
def test_expert_perm_with_permuted_weights_equals_plain_call(case):
    """`moe_ffn(expert_perm=perm)` over the weights moved to their slots
    computes what the unpermuted call does, exactly;
    and what the reference computes with the same permutation."""
    ref_cfg, cfg, rp, p, x, _ = _case(case)
    perm = np.random.default_rng(5).permutation(cfg.moe.num_experts).astype(np.int64)
    xt = torch.from_numpy(x)
    plain = moe.moe_ffn(cfg, p, xt)
    moved = moe.MoE(cfg)
    moved.router = p.router
    for name in ("w_gate", "w_in", "w_out"):  # expert e's weights at slot perm[e]
        getattr(moved, name).data[perm] = getattr(p, name).data
    got = moe.moe_ffn(cfg, moved, xt, expert_perm=torch.from_numpy(perm))
    assert torch.equal(got, plain)
    ref_moved = {k: jnp.asarray(v.numpy()) for k, v in
                 (("router", moved.router), ("w_gate", moved.w_gate), ("w_in", moved.w_in),
                  ("w_out", moved.w_out))}
    want = ref_moe.moe_ffn(ref_cfg, ref_moved, jnp.asarray(x), expert_perm=jnp.asarray(perm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_aux_load_balance_loss_matches_reference():
    _, cfg, rp, p, x, _ = _case("phi3_drop")
    xf = torch.from_numpy(x).reshape(-1, cfg.d_model)
    logits, _, idx = moe.route(cfg, p.router, xf)
    want = ref_moe.aux_load_balance_loss(jnp.asarray(logits.numpy()), jnp.asarray(idx.numpy()),
                                         cfg.moe.num_experts)
    got = moe.aux_load_balance_loss(logits, idx, cfg.moe.num_experts)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=1e-6)


def test_route_matches_reference_top_k():
    """The router: f32 logits from x's dtype, top-k in descending order,
    softmax gates."""
    ref_cfg, cfg, rp, p, x, _ = _case("kimi_no_drop")
    xf = x.reshape(-1, cfg.d_model)
    logits, gates, idx = moe.route(cfg, p.router, torch.from_numpy(xf))
    want_logits = np.asarray(jnp.einsum("td,de->te", jnp.asarray(xf), jnp.asarray(rp["router"])))
    gl, want_idx = jax.lax.top_k(jnp.asarray(want_logits), cfg.moe.top_k)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jax.nn.softmax(gl, axis=-1)), rtol=0,
                               atol=1e-6)


def test_init_moe_shapes_and_scales():
    _, cfg = _cfgs("phi3_5_moe")
    p = moe.init_moe(cfg, torch.Generator().manual_seed(0), torch.bfloat16)
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff
    assert p.router.shape == (d, E) and p.router.dtype == torch.float32
    assert p.w_gate.shape == p.w_in.shape == (E, d, f) and p.w_out.shape == (E, f, d)
    assert p.w_gate.dtype == torch.bfloat16
    assert abs(p.w_out.float().std().item() - f ** -0.5) < 0.2 * f ** -0.5


# ---------------------------------------------------------------- placement


def _zipf_pairs(E, T, seed=0):
    """`examples/expert_placement.py`'s draw: zipf-ish popularity, top-2
    pairs."""
    rng = np.random.default_rng(seed)
    popularity = 1.0 / (1 + np.arange(E)) ** 0.9
    popularity /= popularity.sum()
    return rng.choice(E, size=(T, 2), p=popularity), rng


def _tied_pairs(E, reps):
    """Every unordered pair of distinct experts `reps` times: every
    expert's popularity ties with every other's."""
    a, b = np.triu_indices(E, k=1)
    return np.tile(np.stack([a, b], axis=1), (reps, 1))


PLACEMENTS = {
    "zipf_E64_D8": lambda: (*_zipf_pairs(64, 200_000)[:1], 64, 8),
    "tied_E32_D4": lambda: (_tied_pairs(32, 3), 32, 4),
    "zipf_E16_D4": lambda: (*_zipf_pairs(16, 8192, seed=3)[:1], 16, 4),
}


@pytest.mark.parametrize("draw", list(PLACEMENTS))
def test_ebg_expert_placement_matches_reference_bit_for_bit(draw):
    pairs, E, D = PLACEMENTS[draw]()
    want = ref_pl.ebg_expert_placement(pairs, E, D)
    got = pl.ebg_expert_placement(pairs, E, D)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert sorted(got.tolist()) == list(range(E))  # a permutation
    rand = np.argsort(np.random.default_rng(1).random(E))
    for perm in (got, rand):
        assert pl.placement_report(pairs, perm, E, D) == ref_pl.placement_report(pairs, perm,
                                                                                 E, D)
    if draw.startswith("tied"):
        pop = np.bincount(pairs.reshape(-1), minlength=E)
        assert (pop == pop[0]).all()


def test_placement_options_match_reference():
    pairs, _ = _zipf_pairs(16, 4096, seed=4)
    for kw in (dict(alpha=0.0), dict(beta=0.0), dict(gamma=2.0), dict(alpha=3.0, gamma=0.0)):
        assert np.array_equal(pl.ebg_expert_placement(pairs, 16, 4, **kw),
                              ref_pl.ebg_expert_placement(pairs, 16, 4, **kw)), kw
    with pytest.raises(ValueError, match="do not divide"):
        pl.ebg_expert_placement(pairs, 16, 3)


def test_routing_pairs_from_the_router():
    """The router's [T, k] expert ids (a tensor) → the [T, 2] pairs of each
    token's top-2, which the placement takes."""
    _, cfg, _, p, x, _ = _case("phi3_drop")
    _, _, idx = moe.route(cfg, p.router, torch.from_numpy(x).reshape(-1, cfg.d_model))
    pairs = pl.routing_pairs(idx)
    assert pairs.shape == (idx.shape[0], 2) and pairs.dtype == np.int64
    assert np.array_equal(pairs, idx.numpy()[:, :2])
    assert np.array_equal(pl.routing_pairs(np.arange(12).reshape(4, 3)),
                          np.arange(12).reshape(4, 3)[:, :2])
    with pytest.raises(ValueError, match="k >= 2"):
        pl.routing_pairs(torch.zeros((4, 1), dtype=torch.int64))
    perm = pl.ebg_expert_placement(pairs, cfg.moe.num_experts, 2)
    assert np.array_equal(perm, ref_pl.ebg_expert_placement(pairs, cfg.moe.num_experts, 2))
