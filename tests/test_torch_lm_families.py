"""Port parity, the LM serving path of the MoE, SSM, hybrid and
encoder-decoder families: `repro_torch.models.transformer` (forward, the
encoder, caches), `models.steps`, `launch.serve.generate` and
`interop.lm_params_from_numpy` against `repro.models` and
`repro.launch.serve`, on the CPU, at the reduced configs of `phi3_5_moe`,
`kimi_k2`, `mamba2_780m`, `jamba_1_5_large` (attention, SSM and MoE in one
period-8 stack) and `seamless_m4t_large_v2` (1 encoder and 1 decoder
layer), seamless both with encoder frames (`enc_embeds`) and without any
encoder input, as `generate` runs it.

The reference's parameters come from `jax.random.PRNGKey` inits in f32,
every all-zero leaf (norm scales, biases, the SSM's conv_b, dt_bias and
A_log) replaced by seeded numpy noise, carried across by
`lm_params_from_numpy`; the inputs are seeded numpy arrays fed to both.
The reduced MoE configs set capacity_factor = E, so nothing drops and a
decode step computes what the full forward does
(`tests/test_torch_moe.py` holds the dropping case against the reference).

Tolerances, as `tests/test_torch_lm.py` states them (f32, sums in another
order): forward logits atol 1e-4; the serve steps and `generate` over
bf16 caches 1e-3 (an f32 K or V computed an ulp apart can round to the
neighbouring bf16 value), tokens equal wherever the reference's top-2
margin exceeds it; decode against the full forward in the port alone
2e-3. Seamless without an encoder input is not held against its full
forward: its cross layers attend over the call's own tokens (all of them
in a full forward, the one token in a decode step), which the reference
computes so too; `generate` holds it against the reference instead.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch import serve as ref_serve
from repro.models import steps as ref_steps
from repro.models import transformer as ref_T
from repro_torch import configs, interop
from repro_torch.kernels.dispatch import LAUNCHES
from repro_torch.launch import serve
from repro_torch.models import steps
from repro_torch.models import transformer as T
from repro_torch.models.ssm import SSMCache
from repro_torch.serve.padding import bucket_size, pad_batch_rows

FAMILIES = ["phi3_5_moe", "kimi_k2", "mamba2_780m", "jamba_1_5_large", "seamless_m4t_large_v2"]
CASES = FAMILIES + ["seamless_enc"]  # seamless with encoder frames
LOGITS_ATOL = 1e-4
SERVE_ATOL = 1e-3
DECODE_ATOL = 2e-3
ENC_LEN = 12  # encoder frames


def _name(case):
    return "seamless_m4t_large_v2" if case == "seamless_enc" else case


def _noisy(tree, rng):
    """The reference's params with every all-zero leaf replaced by small
    seeded noise."""
    return jax.tree.map(lambda a: np.asarray(a) if np.asarray(a).any() else
                        (0.1 * rng.standard_normal(np.shape(a))).astype(np.asarray(a).dtype),
                        tree)


def _params(case, seed=0):
    """(ref config, port config, reference params (numpy), port params)."""
    name = _name(case)
    ref_cfg, cfg = ref_configs.reduced_config(name), configs.reduced_config(name)
    rp = _noisy(ref_T.init_params(ref_cfg, jax.random.PRNGKey(seed), jnp.float32),
                np.random.default_rng(seed))
    return ref_cfg, cfg, rp, interop.lm_params_from_numpy(cfg, rp, device="cpu")


def _inputs(case, cfg, B, S, seed=0):
    """Seeded decoder inputs (tokens [B, S], or embeds for a frontend
    config) and, for seamless_enc, encoder frames [B, ENC_LEN, d]."""
    rng = np.random.default_rng(seed)
    if cfg.frontend:
        kw = {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)}
    else:
        kw = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if case == "seamless_enc":
        kw["enc_embeds"] = rng.standard_normal((B, ENC_LEN, cfg.d_model)).astype(np.float32)
    return kw


def _jx(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def _pt(kw):
    return {k: torch.from_numpy(v).long() if k in ("tokens", "token") else torch.from_numpy(v)
            for k, v in kw.items()}


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


# ----------------------------------------------------------------- forward


@pytest.mark.parametrize("case", CASES)
def test_family_forward_matches_reference(case):
    ref_cfg, cfg, rp, pp = _params(case)
    kw = _inputs(case, cfg, 2, 16)
    want, _ = ref_T.forward(ref_cfg, rp, **_jx(kw), remat=False)
    got, caches = T.forward(cfg, pp, **_pt(kw))
    assert caches is None and got.shape == (2, 16, cfg.vocab) and got.dtype == torch.float32
    _close(got, want, LOGITS_ATOL)


def test_encode_is_forwards_encoder():
    """`encode` is the encoder block `forward` runs: forward with enc_out
    from it equals forward with the frames (the same function, factored)."""
    _, cfg, _, pp = _params("seamless_enc")
    kw = _pt(_inputs("seamless_enc", cfg, 2, 8))
    enc = T.encode(cfg, pp, enc_embeds=kw["enc_embeds"])
    assert enc.shape == (2, ENC_LEN, cfg.d_model)
    a, _ = T.forward(cfg, pp, embeds=kw["embeds"], enc_embeds=kw["enc_embeds"])
    b, _ = T.forward(cfg, pp, embeds=kw["embeds"], enc_out=enc)
    assert torch.equal(a, b)
    assert T.encode(cfg, pp) is None


@pytest.mark.parametrize("case", [c for c in CASES if c != "seamless_m4t_large_v2"])
def test_family_decode_matches_full_forward(case):
    """The port alone: a prefill of 16 and 16 one-token steps over f32
    caches (seamless: the encoder's output computed once and passed to
    every step) against one full forward of the 32 tokens."""
    _, cfg, _, pp = _params(case, seed=1)
    B, S = 2, 32
    kw = _pt(_inputs(case, cfg, B, S))
    enc = {}
    if case == "seamless_enc":
        enc = {"enc_out": T.encode(cfg, pp, enc_embeds=kw.pop("enc_embeds"))}
    full, _ = T.forward(cfg, pp, **kw, **enc)
    key = "tokens" if "tokens" in kw else "embeds"
    caches = T.init_caches(cfg, B, S, torch.float32)
    LAUNCHES.clear()
    logits, caches = T.forward(cfg, pp, **{key: kw[key][:, :16]}, caches=caches, cache_pos=0,
                               **enc)
    outs = [logits]
    for t in range(16, S):
        lg, caches = T.forward(cfg, pp, **{key: kw[key][:, t:t + 1]}, caches=caches,
                               cache_pos=t, **enc)
        outs.append(lg)
    assert all(c.pos == S for c in caches if not isinstance(c, SSMCache))
    assert not LAUNCHES  # the CPU runs the plain version: no kernel launch
    _close(torch.cat(outs, dim=1), full, DECODE_ATOL)


# ------------------------------------------------------------------- serve


def _ref_loop(ref_cfg, rp, prompt, max_new, max_seq):
    """The reference's `generate` loop, keeping each step's logits."""
    prefill = jax.jit(ref_steps.make_prefill_step(ref_cfg, max_seq))
    step = jax.jit(ref_steps.make_serve_step(ref_cfg))
    logits, caches = prefill(rp, dict(tokens=jnp.asarray(prompt, jnp.int32)))
    S0, out = prompt.shape[1], [np.asarray(logits)]
    tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    for t in range(max_new):
        logits, caches = step(rp, caches, dict(token=tok, pos=jnp.int32(S0 + t)))
        out.append(np.asarray(logits))
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    return np.stack(out, axis=1)  # [B, max_new + 1, vocab]


def _check_tokens(got_tokens, got_logits, want_tokens, want_logits, tol):
    """Row by row, step by step: logits within tol and tokens equal until a
    step whose reference top-2 margin is within tol, where a row may take
    the other token (and its continuation is no longer comparable)."""
    top = np.sort(want_logits, axis=-1)[..., -2:]
    margin = top[..., 1] - top[..., 0]
    for b in range(want_tokens.shape[0]):
        for t in range(want_tokens.shape[1]):
            _close(got_logits[b, t], want_logits[b, t], tol)
            if got_tokens[b, t] != want_tokens[b, t]:
                assert margin[b, t] <= tol, (b, t, margin[b, t])
                break
            if margin[b, t] <= tol:
                break


@pytest.mark.parametrize("batch", [4, 3])
@pytest.mark.parametrize("name", FAMILIES)
def test_family_generate_matches_reference(name, batch):
    """`generate` with f32 params over bf16 caches, as both serving drivers
    run it (no encoder input: seamless's cross layers attend over the
    decoder's own tokens in both), the batch padded to its bucket."""
    ref_cfg, cfg, rp, pp = _params(name, seed=2)
    bucket = bucket_size(batch)
    rng = np.random.default_rng(batch)
    prompt = pad_batch_rows(rng.integers(0, cfg.vocab, (batch, 8)).astype(np.int32), bucket)
    max_new, max_seq = 6, 14
    want_tokens = np.asarray(ref_serve.generate(ref_cfg, rp, jnp.asarray(prompt), max_new,
                                                max_seq))
    want_logits = _ref_loop(ref_cfg, rp, prompt, max_new, max_seq)
    seen = {}
    got = serve.generate(cfg, pp, prompt, max_new, max_seq,
                         on_step=lambda t, lg: seen.__setitem__(t, lg.clone()))
    assert got.shape == (bucket, max_new) and got.dtype == torch.int32
    got_logits = torch.stack([seen[t] for t in range(max_new + 1)], dim=1).numpy()
    _check_tokens(got.numpy(), got_logits[:, :max_new], want_tokens, want_logits[:, :max_new],
                  SERVE_ATOL)
    if np.array_equal(got.numpy(), want_tokens):  # the last step's logits, same prefixes
        _close(got_logits[:, max_new], want_logits[:, max_new], SERVE_ATOL)


@pytest.mark.parametrize("enc_arg", ["enc_out", "enc_embeds"])
def test_serve_steps_with_encoder_match_reference(enc_arg):
    """Seamless's prefill with encoder frames, then decode steps over bf16
    caches given the encoder's output (computed once) or the frames
    (recomputed every step), fed the same tokens: every step's logits and
    the caches against the reference's."""
    ref_cfg, cfg, rp, pp = _params("seamless_enc", seed=3)
    B, S0, N = 2, 6, 5
    kw = _inputs("seamless_enc", cfg, B, S0 + N, seed=4)
    emb, frames = kw["embeds"], kw["enc_embeds"]
    r_logits, r_caches = ref_steps.make_prefill_step(ref_cfg, S0 + N)(
        rp, dict(embeds=jnp.asarray(emb[:, :S0]), enc_embeds=jnp.asarray(frames)))
    p_logits, p_caches = steps.make_prefill_step(cfg, S0 + N)(
        pp, dict(embeds=torch.from_numpy(emb[:, :S0]), enc_embeds=torch.from_numpy(frames)))
    _close(p_logits, r_logits, SERVE_ATOL)
    if enc_arg == "enc_out":  # the reference's own encoder output, carried across
        r_enc = {"enc_out": _ref_encode(ref_cfg, rp, frames)}
        p_enc = {"enc_out": torch.from_numpy(np.array(r_enc["enc_out"]))}
    else:
        r_enc = {"enc_embeds": jnp.asarray(frames)}
        p_enc = {"enc_embeds": torch.from_numpy(frames)}
    r_step, p_step = jax.jit(ref_steps.make_serve_step(ref_cfg)), steps.make_serve_step(cfg)
    for t in range(S0, S0 + N):
        r_logits, r_caches = r_step(rp, r_caches, dict(embed=jnp.asarray(emb[:, t:t + 1]),
                                                       pos=jnp.int32(t), **r_enc))
        p_logits, p_caches = p_step(pp, p_caches, dict(embed=torch.from_numpy(emb[:, t:t + 1]),
                                                       pos=t, **p_enc))
        _close(p_logits, r_logits, SERVE_ATOL)
    slot = r_caches["layer_0"]["kv"]
    _close(p_caches[0].k.float(), np.asarray(slot["k"][0].astype(jnp.float32)), SERVE_ATOL)
    _close(p_caches[0].v.float(), np.asarray(slot["v"][0].astype(jnp.float32)), SERVE_ATOL)


def _ref_encode(ref_cfg, rp, frames):
    """The reference's encoder output (the block inside its forward)."""
    from repro.models import layers as ref_L
    from repro.models.config import LayerSpec

    B, Se = frames.shape[:2]
    pos = jnp.broadcast_to(jnp.arange(Se)[None, :], (B, Se))
    out, _ = ref_T._run_stack(ref_cfg, rp["enc_groups"], (LayerSpec(kind="attn", mlp="dense"),),
                              jnp.asarray(frames), pos, causal=False, remat=False)
    return np.asarray(ref_L.rms_norm(out, rp["enc_final_norm"], ref_cfg.norm_eps))


def test_ssm_caches_match_reference_after_serving():
    """jamba: an SSM layer's state and conv after a prefill and two decode
    steps over bf16 caches (the conv state promoted to f32, as the
    reference's concatenate promotes it), and an attention layer's K."""
    ref_cfg, cfg, rp, pp = _params("jamba_1_5_large", seed=5)
    prompt = np.random.default_rng(6).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    r_logits, rc = ref_steps.make_prefill_step(ref_cfg, 12)(rp, dict(tokens=prompt))
    p_logits, pc = steps.make_prefill_step(cfg, 12)(pp, _pt(dict(tokens=prompt)))
    for t, tok in ((8, [[3], [7]]), (9, [[11], [5]])):
        tok = np.array(tok, np.int32)
        r_logits, rc = ref_steps.make_serve_step(ref_cfg)(rp, rc, dict(token=jnp.asarray(tok),
                                                                       pos=jnp.int32(t)))
        p_logits, pc = steps.make_serve_step(cfg)(pp, pc, dict(token=torch.from_numpy(tok).long(),
                                                               pos=t))
        _close(p_logits, r_logits, SERVE_ATOL)
    for layer in (0, 1, 4):
        slot = rc[f"layer_{layer}"]
        if cfg.group[layer].kind == "ssm":
            assert isinstance(pc[layer], SSMCache)
            assert pc[layer].conv.dtype == torch.float32
            assert slot["ssm"]["conv"].dtype == jnp.float32
            assert pc[layer].state.dtype == torch.float32
            _close(pc[layer].state, np.asarray(slot["ssm"]["state"][0]), SERVE_ATOL)
            _close(pc[layer].conv, np.asarray(slot["ssm"]["conv"][0]), SERVE_ATOL)
        else:
            assert pc[layer].pos == 10
            _close(pc[layer].k.float(), np.asarray(slot["kv"]["k"][0].astype(jnp.float32)),
                   SERVE_ATOL)


# ------------------------------------------------------------- every config


@pytest.mark.parametrize("name", configs.ARCHS)
def test_every_config_serves_on_the_cpu(name):
    """Every config of the registry (reduced): init_params, init_caches,
    forward, the prefill and serve steps and generate run, and the logits
    are finite (none raises NotImplementedError)."""
    cfg = configs.reduced_config(name)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    caches = T.init_caches(cfg, 2, 12)
    assert len(caches) == cfg.n_layers
    x = torch.randint(0, cfg.vocab, (2, 6), generator=torch.Generator().manual_seed(1))
    logits, _ = T.forward(cfg, params, tokens=x)
    assert logits.shape == (2, 6, cfg.vocab) and torch.isfinite(logits).all()
    last, caches = steps.make_prefill_step(cfg, 12)(params, dict(tokens=x))
    nxt, caches = steps.make_serve_step(cfg)(params, caches, dict(token=x[:, :1], pos=6))
    assert nxt.shape == (2, cfg.vocab) and torch.isfinite(nxt).all()
    out = serve.generate(cfg, params, x, 3, 9)
    assert out.shape == (2, 3)


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_cli_every_family_on_the_cpu(name, capsys):
    out = serve.main(["--device", "cpu", "--arch", name, "--batch", "3", "--prompt-len", "8",
                      "--tokens", "4"])
    assert out.shape == (3, 4) and out.dtype == torch.int32
    assert "generated 12 tokens" in capsys.readouterr().out


# ------------------------------------------------------------------ interop


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["jamba_1_5_large", "seamless_m4t_large_v2", "mamba2_780m"])
def test_lm_params_from_numpy_new_leaves_bit_for_bit(name, dtype):
    """Every leaf of the reference's pytree (the MoE's router and experts,
    the eight SSM leaves, the cross-attention and its norm, the encoder's
    layers and final norm) lands in its port layer, bit for bit and in its
    own dtype (the router and the SSM's dt_bias, A_log, D stay f32)."""
    ref_cfg, cfg = ref_configs.reduced_config(name), configs.reduced_config(name)
    ref_cfg, cfg = (dataclasses.replace(c, n_layers=2 * len(c.group)) for c in (ref_cfg, cfg))
    if cfg.is_encdec:
        ref_cfg, cfg = (dataclasses.replace(c, n_enc_layers=3) for c in (ref_cfg, cfg))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    rp = jax.tree.map(np.asarray, ref_T.init_params(ref_cfg, jax.random.PRNGKey(7), jdt))
    rp = _noisy(rp, np.random.default_rng(7))
    pp = interop.lm_params_from_numpy(cfg, rp, device="cpu")
    n = len(cfg.group)

    def same(got, want):
        want = np.asarray(want)
        assert str(got.dtype).replace("torch.", "") == want.dtype.name
        bits = np.int16 if want.dtype.name == "bfloat16" else np.int32
        tbits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
        assert np.array_equal(got.view(tbits).numpy(), want.view(bits))

    checked = 0
    for stack, layers, groups in (("layers", pp.layers, rp["groups"]),
                                  ("enc_layers", getattr(pp, "enc_layers", []),
                                   rp.get("enc_groups", {}))):
        for layer, mod in enumerate(layers):
            slot = groups[f"layer_{layer % n}" if stack == "layers" else "layer_0"]
            g = layer // n if stack == "layers" else layer
            for pname, t in mod.named_parameters():
                leaf = slot
                for part in pname.split("."):
                    leaf = leaf[part]
                same(t, np.asarray(leaf)[g])
                checked += 1
    if cfg.is_encdec:
        same(pp.enc_final_norm, rp["enc_final_norm"])
    names = {p for lay in pp.layers for p, _ in lay.named_parameters()}
    if cfg.moe is not None:
        assert {"moe.router", "moe.w_gate", "moe.w_in", "moe.w_out"} <= names
        router = next(lay.moe.router for lay in pp.layers if hasattr(lay, "moe"))
        assert router.dtype == torch.float32
    if cfg.ssm is not None:
        ssm_leaves = {"ssm.in_proj", "ssm.conv_w", "ssm.conv_b", "ssm.dt_bias", "ssm.A_log",
                      "ssm.D", "ssm.out_norm", "ssm.out_proj"}
        assert ssm_leaves <= names
        lay = next(lay for lay in pp.layers if hasattr(lay, "ssm"))
        assert lay.ssm.A_log.dtype == torch.float32
    if cfg.is_encdec:
        assert {"cross_norm", "cross.wq"} <= names and len(pp.enc_layers) == 3
    assert checked == sum(1 for lay in pp.layers for _ in lay.parameters()) + sum(
        1 for lay in getattr(pp, "enc_layers", []) for _ in lay.parameters())
    assert not any(p.requires_grad for p in pp.parameters())


def test_lm_params_from_numpy_refuses_a_missing_leaf():
    ref_cfg, cfg = (configs_.reduced_config("phi3_5_moe") for configs_ in (ref_configs, configs))
    rp = jax.tree.map(np.asarray, ref_T.init_params(ref_cfg, jax.random.PRNGKey(0),
                                                    jnp.float32))
    del rp["groups"]["layer_0"]["moe"]["router"]
    with pytest.raises(ValueError, match="moe.router"):
        interop.lm_params_from_numpy(cfg, rp, device="cpu")
