"""Port parity, the LM training path: `repro_torch.models.steps.lm_loss` and
`make_train_step`, `repro_torch.optim.adam`, `interop.lm_params_to_numpy`
and `repro_torch.launch.train` against `repro.models.steps`,
`repro.optim.adam` and `repro.launch.train`, on the CPU, for each of the
ten configs of the registry at `reduced_config`.

The reference's parameters come from `jax.random.PRNGKey` inits in f32,
every all-zero leaf (norm scales, biases, the SSM's conv_b, dt_bias and
A_log) replaced by seeded numpy noise, carried across by
`interop.lm_params_from_numpy`. The batches are the reference pipeline's
(`repro.data.pipeline.batch_at_step`: tokens and targets, B 2, S 16); a
frontend config (qwen2_vl, seamless) takes seeded embeds in place of the
tokens, the encoder-decoder seeded encoder frames. One `jax.jit` a config
computes the loss, `jax.value_and_grad`'s gradients and two
`apply_updates`, which the 5-step trajectory calls again.

Tolerances (f32, sums in another order): the loss 1e-5; each gradient leaf
GRAD_RTOL = 1e-4 of the leaf's largest |g|; one `apply_updates` on the
reference's gradients (f32 states; bf16 states with bf16 gradient
compression) 1e-6 of the leaf's largest |p| (a bf16 state one bf16 step,
2^-8 of the largest |state|, as the f32 values it rounds may lie an f32
ulp apart at a bf16 rounding boundary); the 5-step loss trajectory 1e-3
and the parameters after it PARAM_RTOL = 1e-3 of the leaf's largest |p|:
a leaf whose gradient is only roundoff (qwen2's key bias, which the
softmax cannot see: it adds one constant to a query's scores) takes
Adam's normalized steps of about lr in a sign the roundoff picks (1.6e-4
of the largest |bk| after five steps at lr 1e-3). The MoE
configs (phi3_5_moe, kimi_k2, jamba_1_5_large) run on the first data seed
whose router top-k margins, every router call of the port's five steps,
exceed ROUTE_MARGIN: a near tie that the two frameworks' roundings decide
differently picks another expert, a jump the tolerances do not describe.
"""
import dataclasses
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data import pipeline as ref_pipeline
from repro.launch import train as ref_train
from repro.models import steps as ref_steps
from repro.models import transformer as ref_T
from repro.optim import adam as ref_adam
from repro_torch import configs, interop
from repro_torch.checkpoint import ckpt
from repro_torch.launch import train
from repro_torch.models import moe, steps
from repro_torch.models import transformer as T
from repro_torch.optim import adam

B, S, ENC_LEN, STEPS = 2, 16, 12, 5
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4
UPDATE_RTOL = 1e-6
TRAJ_ATOL = 1e-3
PARAM_RTOL = 1e-3
ROUTE_MARGIN = 1e-3
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
REF_OPT = ref_adam.AdamWConfig(**OPT)
REF_OPT16 = ref_adam.AdamWConfig(**OPT, state_dtype=jnp.bfloat16, compress_grads="bf16")
PT_OPT = adam.AdamWConfig(**OPT)
PT_OPT16 = adam.AdamWConfig(**OPT, state_dtype=torch.bfloat16, compress_grads="bf16")


def _noisy(tree, rng):
    return jax.tree.map(lambda a: np.asarray(a) if np.asarray(a).any() else
                        (0.1 * rng.standard_normal(np.shape(a))).astype(np.asarray(a).dtype),
                        tree)


def _ref_params(ref_cfg, seed=0):
    return _noisy(ref_T.init_params(ref_cfg, jax.random.PRNGKey(seed), jnp.float32),
                  np.random.default_rng(seed))


def _batches(cfg, data_seed):
    """STEPS numpy batches from the reference's pipeline (module docstring)."""
    data = ref_pipeline.DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=data_seed)
    rng = np.random.default_rng(data_seed + 100)
    out = []
    for step in range(STEPS):
        b = {k: np.asarray(v) for k, v in ref_pipeline.batch_at_step(data, step).items()}
        if cfg.frontend:
            b["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
            del b["tokens"]
        if cfg.is_encdec:
            b["enc_embeds"] = rng.standard_normal((B, ENC_LEN, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _pt(batch):
    return {k: torch.from_numpy(v).long() if k in ("tokens", "targets") else torch.from_numpy(v)
            for k, v in batch.items()}


def _tree(cfg, named):
    """{parameter name: tensor} → the reference's pytree of numpy arrays."""
    mod = T.empty_params(cfg, device="cpu")
    for name, p in mod.named_parameters():
        p.data = named[name].detach().to(p.dtype).clone()
    return interop.lm_params_to_numpy(cfg, mod)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _rel_close(got_tree, want_tree, rtol, what):
    """Every leaf within rtol of the leaf's largest |want|."""
    got = dict((jax.tree_util.keystr(k), np.asarray(v, np.float32)) for k, v in _leaves(got_tree))
    for key, want in _leaves(want_tree):
        name = jax.tree_util.keystr(key)
        want = np.asarray(want, np.float32)
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got[name] - want).max())
        assert err <= rtol * scale, (what, name, err, scale)


class RouteSpy:
    """Records every router call of `models.moe.route`: its least top-k
    margin and its expert ids."""

    def __init__(self):
        self.margins, self.experts = [], []

    def __enter__(self):
        self._route = moe.route

        def route(cfg, router, xf):
            logits, gates, idx = self._route(cfg, router, xf)
            top = torch.topk(logits.detach(), cfg.moe.top_k + 1, dim=-1).values
            self.margins.append(float((top[:, -2] - top[:, -1]).min()))
            self.experts.append(idx.clone())
            return logits, gates, idx

        moe.route = route
        return self

    def __exit__(self, *exc):
        moe.route = self._route


def _port_run(cfg, rp, batches, opt, *, remat):
    """The port's STEPS train steps from the reference's params: (losses,
    grad norms, the LM after them)."""
    params = interop.lm_params_from_numpy(cfg, rp, device="cpu")
    state = adam.init_opt_state(params, opt)
    step = steps.make_train_step(cfg, opt, remat=remat)
    losses, norms = [], []
    for b in batches:
        params, state, m = step(params, state, _pt(b))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, params


def _data_seed(cfg, rp):
    """The data seed the parity runs take: 0, or for a MoE config the first
    whose router margins exceed ROUTE_MARGIN over the port's five steps."""
    if cfg.moe is None:
        return 0
    for seed in range(16):
        with RouteSpy() as spy:
            _port_run(cfg, rp, _batches(cfg, seed), PT_OPT, remat=False)
        if min(spy.margins) > ROUTE_MARGIN:
            return seed
    raise AssertionError("no data seed with router margins above ROUTE_MARGIN")


def _ref_step_fn(ref_cfg):
    """One jit: loss, grads, and apply_updates with f32 and bf16 states."""

    def fn(params, opt32, opt16, batch):
        (loss, _), grads = jax.value_and_grad(
            lambda p: ref_steps.lm_loss(ref_cfg, p, batch, remat=False), has_aux=True)(params)
        p32, s32, m32 = ref_adam.apply_updates(params, grads, opt32, REF_OPT)
        p16, s16, _ = ref_adam.apply_updates(params, grads, opt16, REF_OPT16)
        return loss, grads, p32, s32, m32, p16, s16

    return jax.jit(fn)


def _opt_tree(cfg, state):
    return {k: _tree(cfg, state[k]) for k in ("mu", "nu")}


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_train_step_matches_reference(arch):
    """The loss, every gradient leaf, one apply_updates (f32 states; bf16
    states with compression) on the reference's gradients, and the 5-step
    trajectory of make_train_step with the parameters after it."""
    ref_cfg, cfg = ref_configs.reduced_config(arch), configs.reduced_config(arch)
    rp = _ref_params(ref_cfg)
    seed = _data_seed(cfg, rp)
    batches = _batches(cfg, seed)
    fn = _ref_step_fn(ref_cfg)
    jp = jax.tree.map(jnp.asarray, rp)
    o32, o16 = ref_adam.init_opt_state(jp, REF_OPT), ref_adam.init_opt_state(jp, REF_OPT16)
    loss, grads, p32, s32, m32, p16, s16 = fn(jp, o32, o16, jax.tree.map(jnp.asarray, batches[0]))

    # The loss and the gradients of the first batch.
    params = interop.lm_params_from_numpy(cfg, rp, device="cpu").requires_grad_(True)
    got, _ = steps.lm_loss(cfg, params, _pt(batches[0]), remat=False)
    assert abs(float(got) - float(loss)) <= LOSS_ATOL, (float(got), float(loss))
    named = list(params.named_parameters())
    pg = torch.autograd.grad(got, [p for _, p in named], allow_unused=True)
    pg = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(named, pg)}
    _rel_close(_tree(cfg, pg), grads, GRAD_RTOL, "grads")

    # One apply_updates on the reference's gradients.
    rg = interop.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, grads), device="cpu")
    rg = dict(rg.named_parameters())
    for opt, want_p, want_s in ((PT_OPT, p32, s32), (PT_OPT16, p16, s16)):
        pp = interop.lm_params_from_numpy(cfg, rp, device="cpu")
        state = adam.init_opt_state(pp, opt)
        pp, state, m = adam.apply_updates(pp, rg, state, opt)
        _rel_close(_tree(cfg, dict(pp.named_parameters())), want_p, UPDATE_RTOL, "params")
        srtol = UPDATE_RTOL if opt.state_dtype == torch.float32 else 2.0 ** -8
        _rel_close(_opt_tree(cfg, state), {k: want_s[k] for k in ("mu", "nu")}, srtol, "state")
        assert int(state["step"]) == int(want_s["step"]) == 1
        assert state["mu"]["embed"].dtype == opt.state_dtype
    np.testing.assert_allclose(float(m32["grad_norm"]),
                               float(adam._global_norm(rg.values())), rtol=1e-6)

    # The 5-step trajectory.
    want = []
    cur, st32 = jp, o32
    for b in batches:
        loss, _, cur, st32, m, _, _ = fn(cur, st32, o16, jax.tree.map(jnp.asarray, b))
        want.append(float(loss))
    losses, _, final = _port_run(cfg, rp, batches, PT_OPT, remat=True)
    np.testing.assert_allclose(losses, want, rtol=0, atol=TRAJ_ATOL)
    _rel_close(interop.lm_params_to_numpy(cfg, final), cur, PARAM_RTOL, "params after 5 steps")


def test_vocab_parallel_loss_matches_reference():
    """The one-hot branch of lm_loss against the reference's, and against
    the port's take_along_dim branch."""
    ref_cfg, cfg = ref_configs.reduced_config("llama3_2_3b"), configs.reduced_config("llama3_2_3b")
    rp = _ref_params(ref_cfg, seed=3)
    b = _batches(cfg, 0)[0]
    want, _ = jax.jit(lambda p, bb: ref_steps.lm_loss(ref_cfg, p, bb, remat=False,
                                                       vocab_parallel=True))(
        jax.tree.map(jnp.asarray, rp), jax.tree.map(jnp.asarray, b))
    params = interop.lm_params_from_numpy(cfg, rp, device="cpu")
    got, aux = steps.lm_loss(cfg, params, _pt(b), vocab_parallel=True)
    plain, _ = steps.lm_loss(cfg, params, _pt(b))
    assert abs(float(got) - float(want)) <= LOSS_ATOL
    assert float(aux["loss"]) == float(got) and abs(float(got) - float(plain)) <= LOSS_ATOL


@pytest.mark.parametrize("arch", ["llama3_2_3b", "jamba_1_5_large", "seamless_m4t_large_v2"])
def test_remat_gives_the_plain_gradients(arch):
    """remat (one checkpoint segment a group of layers) recomputes what the
    first pass computed: the gradients equal those without it, bit for bit,
    and every MoE router call of the recomputation picks the first pass's
    experts."""
    ref_cfg, cfg = ref_configs.reduced_config(arch), configs.reduced_config(arch)
    rp = _ref_params(ref_cfg, seed=1)
    b = _pt(_batches(cfg, 0)[0])
    out = {}
    for remat in (False, True):
        params = interop.lm_params_from_numpy(cfg, rp, device="cpu").requires_grad_(True)
        with RouteSpy() as spy:
            loss, _ = steps.lm_loss(cfg, params, b, remat=remat)
            grads = torch.autograd.grad(loss, list(params.parameters()), allow_unused=True)
        out[remat] = (loss, grads, spy.experts)
    assert torch.equal(out[False][0], out[True][0])
    for g0, g1 in zip(out[False][1], out[True][1]):
        assert (g0 is None and g1 is None) or torch.equal(g0, g1)
    plain, rematted = out[False][2], out[True][2]
    if cfg.moe is not None:
        n = len(plain)
        assert n > 0 and len(rematted) == 2 * n  # the first pass, then the recomputation
        for first, again in zip(rematted[:n], rematted[n:]):
            assert torch.equal(first, again)
        for a, b_ in zip(plain, rematted[:n]):
            assert torch.equal(a, b_)


def test_adamw_schedule_and_norm_match_reference():
    """The schedule at every step of warmup and decay, and the global norm,
    in f32 as the reference's (its step an int32 array)."""
    for step in range(0, 14):
        got = adam._schedule(PT_OPT, torch.tensor(step, dtype=torch.int32))
        want = ref_adam._schedule(REF_OPT, jnp.int32(step))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-7, atol=0)
    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 2))]
    np.testing.assert_allclose(float(adam._global_norm([torch.from_numpy(a) for a in leaves])),
                               float(ref_adam._global_norm([jnp.asarray(a) for a in leaves])),
                               rtol=1e-7)


def test_apply_updates_leaves_unused_grads_as_zeros():
    """A parameter the loss does not reach (grad None) updates as with a
    zero gradient: its states decay and weight decay still applies."""
    cfg = train.preset_config("tiny")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    zeros = {n: torch.zeros_like(p) for n, p in params.named_parameters()}
    a = T.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    sa = adam.init_opt_state(a, PT_OPT)
    adam.apply_updates(a, {}, sa, PT_OPT)
    sb = adam.init_opt_state(params, PT_OPT)
    adam.apply_updates(params, zeros, sb, PT_OPT)
    for (_, x), (_, y) in zip(a.named_parameters(), params.named_parameters()):
        assert torch.equal(x, y)
    assert int(sa["step"]) == 1 and sa["step"].dtype == torch.int32


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_lm_params_to_numpy_round_trip(arch):
    """lm_params_to_numpy is the inverse of lm_params_from_numpy, exactly,
    for the reference's pytree (f32) and the port's bf16 parameters."""
    ref_cfg, cfg = ref_configs.reduced_config(arch), configs.reduced_config(arch)
    rp = _ref_params(ref_cfg)
    back = interop.lm_params_to_numpy(cfg, interop.lm_params_from_numpy(cfg, rp, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(rp)
    for (k, got), (_, want) in zip(_leaves(back), _leaves(rp)):
        assert got.dtype == want.dtype and np.array_equal(got, want), k
    pb = T.init_params(cfg, torch.Generator().manual_seed(0), torch.bfloat16)
    qb = interop.lm_params_from_numpy(cfg, interop.lm_params_to_numpy(cfg, pb), device="cpu")
    for (n, x), (_, y) in zip(pb.named_parameters(), qb.named_parameters()):
        assert x.dtype == y.dtype and torch.equal(x, y), n


# ----------------------------------------------------------------- launcher


def test_launcher_loss_drops():
    """The reference's end-to-end criterion: the mean of the last 5 of 40
    steps of the tiny preset below the first less 0.5."""
    losses = train.main(["--device", "cpu", "--preset", "tiny", "--steps", "40",
                         "--log-every", "100"])
    assert len(losses) == 40 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < losses[0] - 0.5


def test_launcher_resume_is_bit_for_bit(tmp_path):
    """A run checkpointed every 3 steps, and a run resumed from its step-3
    checkpoint alone, end equal bit for bit: parameters, both states and
    the step, and the losses of steps 3-5; every parameter of the resumed
    model requires grad."""
    common = ["--device", "cpu", "--preset", "tiny", "--steps", "6", "--batch", "4",
              "--seq", "32", "--ckpt-every", "3", "--log-every", "100"]
    full = train.main(common + ["--ckpt-dir", str(tmp_path / "a")])
    assert ckpt.latest_step(tmp_path / "a") == 6
    (tmp_path / "b").mkdir()
    shutil.copytree(tmp_path / "a" / "step_00000003", tmp_path / "b" / "step_00000003")
    resumed = train.main(common + ["--ckpt-dir", str(tmp_path / "b"), "--resume"])
    assert resumed == full[3:]
    cfg = train.preset_config("tiny")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    like = train.train_state(params, adam.init_opt_state(params, PT_OPT))
    a = ckpt.restore(tmp_path / "a", 6, like)
    b = ckpt.restore(tmp_path / "b", 6, like)
    for (ka, x), (kb, y) in zip(ckpt._flatten_with_paths(a), ckpt._flatten_with_paths(b)):
        assert ka == kb and torch.equal(x, y), ka
    assert int(a["opt"]["step"]) == 6
    params.requires_grad_(True)
    before = [id(p) for p in params.parameters()]
    params, _ = train.restore_train_state(tmp_path / "b", 6, params,
                                          adam.init_opt_state(params, PT_OPT))
    assert [id(p) for p in params.parameters()] == before
    assert all(p.requires_grad for p in params.parameters())
    for name, p in params.named_parameters():
        assert torch.equal(p, a["params"][name]), name


def test_launcher_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--preset", "tiny", "--steps", "1"])


def test_launcher_arch_and_compression_run():
    """--arch takes a reduced config of the registry; --compress-grads
    trains with bf16 gradients: finite losses."""
    losses = train.main(["--device", "cpu", "--arch", "jamba_1_5_large", "--steps", "3",
                         "--batch", "2", "--seq", "16", "--compress-grads", "--log-every", "100"])
    assert len(losses) == 3 and np.isfinite(losses).all()


def test_presets_match_reference():
    assert train.PRESETS == ref_train.PRESETS
    for name in train.PRESETS:
        assert dataclasses.asdict(train.preset_config(name)) == \
            dataclasses.asdict(ref_train.preset_config(name))
    assert "jax" not in sys.modules["repro_torch.launch.train"].__dict__


def test_training_modules_import_neither_jax_nor_the_reference():
    import os
    import subprocess
    from pathlib import Path

    code = ("import sys, repro_torch.launch.train, repro_torch.optim, repro_torch.data.pipeline\n"
            "import repro_torch.models.steps\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'repro'))\n"
            "sys.exit(1 if bad else 0)\n")
    src = str(Path(__file__).resolve().parents[1] / "src")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": src}, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
