"""Port parity, the backward of the LM layers that training added: the SSD
(`models.ssm.ssd_chunked` and a whole `ssm_block`) against `jax.grad` of
`repro.models.ssm`, the expert-parallel MoE (`models.moe.moe_ffn_ep`) over
a spawned gloo world of 2 against the single-process `moe_ffn`, and the
serving path building no autograd graph. On the CPU.

Inputs are seeded numpy arrays (the SSD's as `tests/test_torch_ssm.py`
draws them; the mixer at mamba2_780m's and jamba_1_5_large's reduced
configs with the reference's init, its all-zero leaves replaced by seeded
noise), and a loss that weighs every output element by a seeded random
cotangent, so that each gradient is a vector-Jacobian product.

Tolerances (f32, sums in another order): every gradient within GRAD_RTOL
= 1e-4 of its largest |g| (the SSD) or EP_RTOL = 1e-5 of it (the MoE,
whose ranks add the same products in another grouping: the router's
gradient reaches ~300 on the skewed tokens, an f32 ulp of which is
3e-5); the world of 2 and the single process give the same loss to 1e-6.
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
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro_torch import configs
from repro_torch.launch import serve, train
from repro_torch.models import moe, ssm, steps
from repro_torch.models import transformer as T

SRC = str(Path(__file__).resolve().parents[1] / "src")
GRAD_RTOL = 1e-4
EP_RTOL = 1e-5


def _rel_close(got, want, rtol, what):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = float(np.abs(want).max())
    assert scale > 0, what
    assert float(np.abs(got - want).max()) <= rtol * scale, (what, float(np.abs(got - want).max()),
                                                             scale)


def _ssd_inputs(seed=0, b=2, s=64, h=3, p=4, n=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0)).astype(np.float32)
    A = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    Bm = rng.standard_normal((b, s, n)).astype(np.float32)
    Cm = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("chunk", [8, 64])
def test_ssd_chunked_grads_match_reference(chunk):
    """d/d(x, dt, A, B, C) of <y, gy> + <state, gs> against jax.grad."""
    args = _ssd_inputs(1)
    rng = np.random.default_rng(2)
    gy = rng.standard_normal(args[0].shape).astype(np.float32)
    gs = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)

    def ref_loss(*a):
        y, st = ref_ssm.ssd_chunked(*a, chunk)
        return jnp.sum(y * gy) + jnp.sum(st * gs)

    want = jax.jit(jax.grad(ref_loss, argnums=tuple(range(5))))(*(jnp.asarray(a) for a in args))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, st = ssm.ssd_chunked(*ts, chunk)
    loss = (y * torch.from_numpy(gy)).sum() + (st * torch.from_numpy(gs)).sum()
    got = torch.autograd.grad(loss, ts)
    for name, g, w in zip(("x", "dt", "A", "B", "C"), got, want):
        _rel_close(g.numpy(), w, GRAD_RTOL, name)


def test_ssd_chunked_without_grad_still_runs_in_place():
    """The serving path's in-place product and the training path's product
    give the same output, bit for bit."""
    args = [torch.from_numpy(a) for a in _ssd_inputs(3)]
    with torch.no_grad():
        y0, s0 = ssm.ssd_chunked(*args, 16)
    y1, s1 = ssm.ssd_chunked(args[0].clone().requires_grad_(True), *args[1:], 16)
    assert torch.equal(y0, y1.detach()) and torch.equal(s0, s1.detach())


@pytest.mark.parametrize("name", ["mamba2_780m", "jamba_1_5_large"])
def test_ssm_block_grads_match_reference(name):
    """The whole mixer: every parameter's and the input's gradient."""
    ref_cfg, cfg = ref_configs.reduced_config(name), configs.reduced_config(name)
    rng = np.random.default_rng(4)
    rp = {k: np.asarray(v) for k, v in
          ref_ssm.init_ssm(ref_cfg, jax.random.PRNGKey(4), jnp.float32).items()}
    rp = {k: v if v.any() else (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
          for k, v in rp.items()}
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    gy = rng.standard_normal(x.shape).astype(np.float32)

    def ref_loss(p, xx):
        return jnp.sum(ref_ssm.ssm_block(ref_cfg, p, xx)[0] * gy)

    want_p, want_x = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in rp.items()}, jnp.asarray(x))
    p = ssm.SSM(cfg)
    for k, v in rp.items():
        setattr(p, k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = (ssm.ssm_block(cfg, p, xt)[0] * torch.from_numpy(gy)).sum()
    names = list(rp)
    got = torch.autograd.grad(loss, [getattr(p, k) for k in names] + [xt])
    for k, g in zip(names, got):
        _rel_close(g.numpy(), want_p[k], GRAD_RTOL, k)
    _rel_close(got[-1].numpy(), want_x, GRAD_RTOL, "x")


# ------------------------------------------------------- the expert-parallel MoE

MOE_CHILD = r"""
import datetime, os, sys
from pathlib import Path
import numpy as np, torch, torch.distributed as dist

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
work = Path(os.environ["MOE_WORK"])
dist.init_process_group("gloo", init_method=f"file://{work}/rendezvous", rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=60))
import dataclasses
from repro_torch import configs
from repro_torch.models import moe

inputs = np.load(work / "inputs.npz")
cfg = configs.reduced_config(str(inputs["name"]))
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                        capacity_factor=float(inputs["cf"])))
p = moe.MoE(cfg)
for k in ("router", "w_gate", "w_in", "w_out"):
    setattr(p, k, torch.nn.Parameter(torch.from_numpy(inputs[k].copy())))
mine = moe.shard_experts(cfg, p, rank, world)
for k in ("router", "w_gate", "w_in", "w_out"):
    getattr(mine, k).requires_grad_(True)
x = torch.from_numpy(inputs["x"].copy()).requires_grad_(True)
y = moe.moe_ffn_ep(cfg, mine, x, group=dist.group.WORLD)
loss = (y * torch.from_numpy(inputs["gy"])).sum()
names = ("router", "w_gate", "w_in", "w_out")
grads = torch.autograd.grad(loss, [getattr(mine, k) for k in names] + [x])
out = {k: g.numpy() for k, g in zip(names, grads)}
out["x"] = grads[-1].numpy()
out["loss"] = loss.detach().numpy()
dist.destroy_process_group()
np.savez(work / f"rank{rank}.npz", **out)
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "repro"))
sys.exit(3 if bad else 0)
"""


@pytest.mark.parametrize("name,cf", [("phi3_5_moe", None), ("kimi_k2", 1.25)])
def test_moe_ffn_ep_grads_over_gloo_match_single_process(tmp_path, name, cf):
    """A spawned gloo world of 2, each rank with half the experts: the loss
    and every gradient (router, the rank's experts, the input) equal the
    single-process `moe_ffn`'s, drops included (capacity_factor 1.25 on
    tokens that share most of their direction)."""
    ref_cfg, cfg = ref_configs.reduced_config(name), configs.reduced_config(name)
    cf = cfg.moe.capacity_factor if cf is None else cf
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    rp = {k: np.asarray(v) for k, v in
          ref_moe.init_moe(ref_cfg, jax.random.PRNGKey(5), jnp.float32).items()}
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    if cf != cfg.moe.num_experts:
        x = (3.0 * rng.standard_normal(cfg.d_model) + 0.3 * x).astype(np.float32)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    T_ = x.shape[0] * x.shape[1]
    top = np.argsort(-(x.reshape(T_, -1) @ rp["router"]), axis=-1)[:, :cfg.moe.top_k]
    load = np.bincount(top.reshape(-1), minlength=cfg.moe.num_experts)
    drops = int(np.maximum(load - moe.capacity(cfg, T_), 0).sum())
    assert (drops > 0) == (cf != cfg.moe.num_experts), drops
    np.savez(tmp_path / "inputs.npz", name=name, cf=cf, x=x, gy=gy, **rp)
    p = moe.MoE(cfg)
    for k, v in rp.items():
        setattr(p, k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = (moe.moe_ffn(cfg, p, xt) * torch.from_numpy(gy)).sum()
    names = ("router", "w_gate", "w_in", "w_out")
    want = dict(zip(names + ("x",), (g.numpy() for g in torch.autograd.grad(
        loss, [getattr(p, k) for k in names] + [xt]))))
    world = 2
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), MOE_WORK=str(tmp_path),
                   PYTHONPATH=SRC, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-c", MOE_CHILD], env=env,
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
    E_loc = cfg.moe.num_experts // world
    for r in range(world):
        got = dict(np.load(tmp_path / f"rank{r}.npz"))
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-6)
        for k in ("router", "x"):
            _rel_close(got[k], want[k], EP_RTOL, k)
        for k in ("w_gate", "w_in", "w_out"):
            _rel_close(got[k], want[k][r * E_loc:(r + 1) * E_loc], EP_RTOL, k)


# ------------------------------------------------------------- serving stays

@pytest.mark.parametrize("name", ["llama3_2_3b", "mamba2_780m", "seamless_m4t_large_v2"])
def test_serving_builds_no_graph_on_trainable_params(name):
    """With every parameter requiring grad (as after training), generate's
    logits and tokens, the prefill and the serve step build no autograd
    graph; the caches hold no graph either."""
    cfg = configs.reduced_config(name)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    params.requires_grad_(True)
    prompt = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(1))
    seen = []
    toks = serve.generate(cfg, params, prompt, 3, 11, on_step=lambda t, lg: seen.append(lg))
    assert not toks.requires_grad and all(not lg.requires_grad for lg in seen)
    logits, caches = steps.make_prefill_step(cfg, 12)(params, dict(tokens=prompt))
    assert not logits.requires_grad
    lg, caches = steps.make_serve_step(cfg)(params, caches, dict(token=prompt[:, :1], pos=8))
    assert not lg.requires_grad
    for c in caches:
        for t in vars(c).values():
            assert not (isinstance(t, torch.Tensor) and t.requires_grad)


def test_train_step_runs_with_params_built_for_serving():
    """Parameters come without requires_grad (the serving default); the
    train step turns it on for the ones it trains and trains them."""
    from repro_torch.optim import adam

    cfg = train.preset_config("tiny")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    assert not any(p.requires_grad for p in params.parameters())
    before = params.embed.detach().clone()
    opt = adam.AdamWConfig(warmup_steps=1, total_steps=2)
    state = adam.init_opt_state(params, opt)
    toks = torch.randint(0, cfg.vocab, (2, 9), generator=torch.Generator().manual_seed(2))
    params, state, m = steps.make_train_step(cfg, opt)(params, state,
                                                       dict(tokens=toks[:, :-1],
                                                            targets=toks[:, 1:]))
    assert all(p.requires_grad for p in params.parameters())
    assert not torch.equal(params.embed, before) and not m["loss"].requires_grad
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
