"""Port parity, the LM serving path of the dense decoder family:
`repro_torch.configs`, `repro_torch.models` (config, layers, transformer,
steps), `repro_torch.launch.train`'s presets and `repro_torch.launch.serve`
against `repro.configs`, `repro.models` and `repro.launch`, on the CPU.

The reference's parameters come from `jax.random.PRNGKey` inits (in f32),
their zero norm scales and biases replaced by seeded numpy noise so that
QK-norm, QKV bias and every norm take part, and are carried across by
`interop.lm_params_from_numpy`; the inputs are seeded numpy arrays fed to
both. The configs are the reduced ones (`reduced_config`: d_model 64, 4
heads over 2 KV heads, head_dim 16), gemma2 also with its local window cut
to 4 so that it bites at S = 16, and the tiny preset.

Tolerances (f32 throughout, sums in another order): layers 1e-5; forward
logits atol 1e-4; the serve step and `generate` over bf16 caches, as the
reference's serving driver runs them, logits atol 1e-3, since an f32 K or
V that the two frameworks compute an ulp apart can round to neighbouring
bf16 values (2^-8 of the value); greedy tokens equal wherever the
reference's top-2 logit margin exceeds that tolerance. Decode against the
full forward in the port alone: 2e-3, as `tests/test_models.py` holds the
reference.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch import serve as ref_serve
from repro.launch import train as ref_train
from repro.models import layers as ref_L
from repro.models import steps as ref_steps
from repro.models import transformer as ref_T
from repro_torch import configs, interop
from repro_torch.kernels.dispatch import LAUNCHES
from repro_torch.launch import serve, train
from repro_torch.models import layers as L
from repro_torch.models import steps
from repro_torch.models import transformer as T
from repro_torch.serve.padding import bucket_size, pad_batch_rows

DENSE = ["llama3_2_3b", "qwen3_4b", "qwen2_72b", "gemma2_27b", "qwen2_vl_2b"]
CASES = DENSE + ["gemma2_window4", "preset_tiny"]
LAYER_TOL = 1e-5
LOGITS_ATOL = 1e-4
SERVE_ATOL = 1e-3
DECODE_ATOL = 2e-3


def _config(case):
    """(reference config, port config) of a test case: equal dataclasses
    of the two packages."""
    if case == "preset_tiny":
        return ref_train.preset_config("tiny"), train.preset_config("tiny")
    if case == "gemma2_window4":
        ref, port = _config("gemma2_27b")

        def cut(cfg):
            local, glob = cfg.group
            return dataclasses.replace(
                cfg, group=(dataclasses.replace(local, sliding_window=4), glob))

        return cut(ref), cut(port)
    return ref_configs.reduced_config(case), configs.reduced_config(case)


def _noisy(tree, rng):
    """The reference's params with every all-zero leaf (norm scales,
    biases) replaced by small seeded noise."""
    return jax.tree.map(lambda a: np.asarray(a) if np.asarray(a).any() else
                        (0.1 * rng.standard_normal(np.shape(a))).astype(np.asarray(a).dtype),
                        tree)


def _params(case, seed=0):
    """(ref config, port config, reference params (numpy), port params)."""
    ref_cfg, cfg = _config(case)
    rp = _noisy(ref_T.init_params(ref_cfg, jax.random.PRNGKey(seed), jnp.float32),
                np.random.default_rng(seed))
    return ref_cfg, cfg, rp, interop.lm_params_from_numpy(cfg, rp, device="cpu")


def _inputs(cfg, B, S, seed=0):
    """Seeded tokens [B, S], or embeds [B, S, d] for a frontend config:
    {name: numpy array}."""
    rng = np.random.default_rng(seed)
    if cfg.frontend:
        return {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}


def _jx(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def _pt(kw):
    return {k: torch.from_numpy(v).long() if k in ("tokens", "token") else torch.from_numpy(v)
            for k, v in kw.items()}


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


# ----------------------------------------------------------------- configs


def test_config_registry_matches_reference():
    assert configs.ARCHS == ref_configs.ARCHS
    assert configs.SHAPES == ref_configs.SHAPES
    assert train.PRESETS == ref_train.PRESETS
    for name in configs.ARCHS:
        for get in ("get_config", "reduced_config"):
            got, want = getattr(configs, get)(name), getattr(ref_configs, get)(name)
            assert type(got).__module__ == "repro_torch.models.config"
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (name, get)
            assert got.num_params() == want.num_params()
            assert got.num_active_params() == want.num_active_params()
            assert got.head_dim_ == want.head_dim_ and got.n_groups == want.n_groups
        assert configs.runnable_shapes(name) == ref_configs.runnable_shapes(name)
    for name in train.PRESETS:
        assert dataclasses.asdict(train.preset_config(name)) == \
            dataclasses.asdict(ref_train.preset_config(name))


def test_published_widths_of_the_chip_config():
    """llama3_2_3b at its published widths, as the card's serving phase
    runs it."""
    cfg = configs.get_config("llama3_2_3b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.d_ff,
            cfg.vocab, cfg.tie_embeddings, cfg.rope_theta) == \
        (28, 3072, 24, 8, 128, 8192, 128256, True, 5e5)
    assert 3.1e9 < cfg.num_params() < 3.3e9


# ------------------------------------------------------------------ layers


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    want = ref_L.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    got = L.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6)
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_apply_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 2000, (2, 6)).astype(np.int32)
    want = ref_L.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(got, want, LAYER_TOL)


def test_apply_mrope_matches_reference():
    """M-RoPE: three positional streams (t, h, w) over band sections."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 64, (3, 2, 6)).astype(np.int32)
    want = ref_L.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, (2, 3, 3))
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, (2, 3, 3))
    _close(got, want, LAYER_TOL)


ATTN_CASES = {  # name: (config case, layer slot, what bites)
    "llama": ("llama3_2_3b", 0),
    "qk_norm": ("qwen3_4b", 0),
    "qkv_bias": ("qwen2_72b", 0),
    "window4_softcap": ("gemma2_window4", 0),
    "global_softcap": ("gemma2_window4", 1),
    "mrope": ("qwen2_vl_2b", 0),
}


def _attn_pair(case, seed):
    ref_cfg, cfg = _config(ATTN_CASES[case][0])
    rng = np.random.default_rng(seed)
    rp = _noisy(ref_L.init_attention(ref_cfg, jax.random.PRNGKey(seed), jnp.float32), rng)
    pp = L.Attention(cfg)
    for name, _ in list(pp.named_parameters()):
        setattr(pp, name, torch.nn.Parameter(torch.from_numpy(np.array(rp[name])),
                                             requires_grad=False))
    window = cfg.group[ATTN_CASES[case][1]].sliding_window
    return ref_cfg, cfg, rp, pp, window


def _positions(cfg, B, S, offset=0):
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None] + offset, (B, S))
    if cfg.mrope_sections is not None:
        pos = np.broadcast_to(pos[None], (3, B, S))
    return np.ascontiguousarray(pos)


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_prefill_matches_reference(case):
    """No cache, S = 16: causal, with gemma2's window of 4 biting."""
    ref_cfg, cfg, rp, pp, window = _attn_pair(case, 3)
    B, S = 2, 16
    x = np.random.default_rng(4).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = _positions(cfg, B, S)
    want, _ = ref_L.attention(ref_cfg, rp, jnp.asarray(x), jnp.asarray(pos), window=window)
    got, _ = L.attention(cfg, pp, torch.from_numpy(x), torch.from_numpy(pos), window=window)
    _close(got, want, LAYER_TOL)


def test_attention_kv_x_matches_reference():
    """The kv_x branch: keys and values from another sequence, no RoPE,
    no causal mask."""
    ref_cfg, cfg, rp, pp, _ = _attn_pair("qkv_bias", 5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    pos = _positions(cfg, 2, 5)
    want, _ = ref_L.attention(ref_cfg, rp, jnp.asarray(x), jnp.asarray(pos), causal=False,
                              kv_x=jnp.asarray(src))
    got, _ = L.attention(cfg, pp, torch.from_numpy(x), torch.from_numpy(pos), causal=False,
                         kv_x=torch.from_numpy(src))
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_decode_matches_reference(case, cache_dtype):
    """With a cache of 24: a prefill of 12, then 12 one-token decode steps
    (the decode_attention path, its key range past the window of 4), each
    step's output and the written cache against the reference's."""
    ref_cfg, cfg, rp, pp, window = _attn_pair(case, 7)
    B, S0, Smax = 2, 12, 24
    jdt, tdt = (jnp.float32, torch.float32) if cache_dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    x = np.random.default_rng(8).standard_normal((B, Smax, cfg.d_model)).astype(np.float32)
    shape = (B, Smax, cfg.n_kv_heads, cfg.head_dim_)
    rc = dict(k=jnp.zeros(shape, jdt), v=jnp.zeros(shape, jdt), pos=jnp.int32(0))
    pc = L.KVCache(k=torch.zeros(shape, dtype=tdt), v=torch.zeros(shape, dtype=tdt))
    tol = LAYER_TOL if cache_dtype == "float32" else SERVE_ATOL
    for lo, hi in [(0, S0)] + [(t, t + 1) for t in range(S0, Smax)]:
        pos = _positions(cfg, B, hi - lo, lo)
        want, rc = ref_L.attention(ref_cfg, rp, jnp.asarray(x[:, lo:hi]), jnp.asarray(pos),
                                   window=window, cache=rc)
        got, pc = L.attention(cfg, pp, torch.from_numpy(x[:, lo:hi]), torch.from_numpy(pos),
                              window=window, cache=pc)
        _close(got, want, tol)
        assert pc.pos == int(rc["pos"]) == hi
    _close(pc.k.float(), np.asarray(rc["k"].astype(jnp.float32)), tol)
    _close(pc.v.float(), np.asarray(rc["v"].astype(jnp.float32)), tol)


def test_mlp_silu_and_gelu_match_reference():
    for case in ("llama3_2_3b", "gemma2_27b"):  # silu; gelu (tanh form)
        ref_cfg, cfg = _config(case)
        rp = ref_L.init_mlp(ref_cfg, jax.random.PRNGKey(9), jnp.float32)
        pp = L.MLP(cfg)
        for name in ("w_gate", "w_in", "w_out"):
            setattr(pp, name, torch.nn.Parameter(torch.from_numpy(np.array(rp[name])),
                                                 requires_grad=False))
        x = np.random.default_rng(10).standard_normal((2, 3, cfg.d_model)).astype(np.float32)
        _close(L.mlp(cfg, pp, torch.from_numpy(x)), ref_L.mlp(ref_cfg, rp, jnp.asarray(x)),
               LAYER_TOL)


# ----------------------------------------------------------------- forward


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_reference(case):
    ref_cfg, cfg, rp, pp = _params(case)
    kw = _inputs(cfg, 2, 16)
    want, _ = ref_T.forward(ref_cfg, rp, **_jx(kw), remat=False)
    got, caches = T.forward(cfg, pp, **_pt(kw))
    assert caches is None and got.shape == (2, 16, cfg.vocab) and got.dtype == torch.float32
    _close(got, want, LOGITS_ATOL)


def test_lm_params_from_numpy_carries_bf16_bit_for_bit():
    ref_cfg, cfg = (dataclasses.replace(c, n_layers=3) for c in _config("qwen2_72b"))
    rp = jax.tree.map(np.asarray, ref_T.init_params(ref_cfg, jax.random.PRNGKey(3),
                                                    jnp.bfloat16))
    pp = interop.lm_params_from_numpy(cfg, rp, device="cpu")
    assert pp.embed.dtype == torch.bfloat16 and len(pp.layers) == cfg.n_layers
    for got, want in ((pp.embed, rp["embed"]), (pp.unembed, rp["unembed"]),
                      (pp.layers[1].attn.wo, rp["groups"]["layer_0"]["attn"]["wo"][1]),
                      (pp.layers[0].mlp.w_out, rp["groups"]["layer_0"]["mlp"]["w_out"][0])):
        assert np.array_equal(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16))
    assert not any(p.requires_grad for p in pp.parameters())


@pytest.mark.parametrize("case", CASES)
def test_decode_matches_full_forward(case):
    """The port alone, as `tests/test_models.py` holds the reference: a
    prefill of 16 and 16 one-token steps over f32 caches against one full
    forward of the 32 tokens."""
    _, cfg, _, pp = _params(case, seed=1)
    B, S = 2, 32
    kw = _pt(_inputs(cfg, B, S))
    full, _ = T.forward(cfg, pp, **kw)
    caches = T.init_caches(cfg, B, S, torch.float32)
    key = "tokens" if "tokens" in kw else "embeds"
    LAUNCHES.clear()
    logits, caches = T.forward(cfg, pp, **{key: kw[key][:, :16]}, caches=caches, cache_pos=0)
    outs = [logits]
    for t in range(16, S):
        lg, caches = T.forward(cfg, pp, **{key: kw[key][:, t:t + 1]}, caches=caches,
                               cache_pos=t)
        outs.append(lg)
    assert all(c.pos == S for c in caches)
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


def _margin(logits):
    top = np.sort(logits, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


def _check_tokens(got_tokens, got_logits, want_tokens, want_logits, tol):
    """Row by row, step by step: logits within tol and tokens equal until a
    step whose reference top-2 margin is within tol, where a row may take
    the other token (and its continuation is no longer comparable)."""
    margin = _margin(want_logits)
    for b in range(want_tokens.shape[0]):
        for t in range(want_tokens.shape[1]):
            _close(got_logits[b, t], want_logits[b, t], tol)
            if got_tokens[b, t] != want_tokens[b, t]:
                assert margin[b, t] <= tol, (b, t, margin[b, t])
                break
            if margin[b, t] <= tol:
                break


@pytest.mark.parametrize("batch", [4, 3])
@pytest.mark.parametrize("case", CASES)
def test_generate_matches_reference(case, batch):
    """`generate` with f32 params over bf16 caches, as both serving drivers
    run it; the batch padded to its bucket (3 → 4) as their `main` does."""
    ref_cfg, cfg, rp, pp = _params(case, seed=2)
    bucket = bucket_size(batch)
    # Token prompts, qwen2_vl_2b's too: the drivers embed them (its M-RoPE
    # streams then coincide).
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
    # Token t comes from the logits of step t (the prefill's for t = 0).
    _check_tokens(got.numpy(), got_logits[:, :max_new], want_tokens, want_logits[:, :max_new],
                  SERVE_ATOL)
    if np.array_equal(got.numpy(), want_tokens):  # the last step's logits, same prefixes
        _close(got_logits[:, max_new], want_logits[:, max_new], SERVE_ATOL)


def test_serve_step_matches_reference():
    """One `make_serve_step` call on the caches a prefill left (bf16), and
    the cache it writes, against the reference's."""
    ref_cfg, cfg, rp, pp = _params("gemma2_window4", seed=4)
    prompt = _inputs(cfg, 2, 10, seed=5)["tokens"]
    tok = np.array([[3], [7]], np.int32)
    r_logits, r_caches = ref_steps.make_prefill_step(ref_cfg, 16)(rp, dict(tokens=prompt))
    r_logits, r_caches = ref_steps.make_serve_step(ref_cfg)(
        rp, r_caches, dict(token=jnp.asarray(tok), pos=jnp.int32(10)))
    p_logits, p_caches = steps.make_prefill_step(cfg, 16)(pp, _pt(dict(tokens=prompt)))
    p_logits, p_caches = steps.make_serve_step(cfg)(pp, p_caches,
                                                    dict(token=torch.from_numpy(tok).long(),
                                                         pos=10))
    assert p_logits.shape == (2, cfg.vocab)
    _close(p_logits, r_logits, SERVE_ATOL)
    assert p_caches[0].k.dtype == torch.bfloat16 and all(c.pos == 11 for c in p_caches)
    for layer, c in enumerate(p_caches):
        slot = r_caches[f"layer_{layer % 2}"]["kv"]
        _close(c.k.float(), np.asarray(slot["k"][layer // 2].astype(jnp.float32)), SERVE_ATOL)


def test_serve_cli_on_the_cpu(capsys):
    out = serve.main(["--device", "cpu", "--preset", "tiny", "--batch", "3", "--prompt-len",
                      "8", "--tokens", "5"])
    assert out.shape == (3, 5) and out.dtype == torch.int32
    text = capsys.readouterr().out
    assert "generated 15 tokens" in text and "padded to bucket 4" in text and "on cpu" in text
    out = serve.main(["--device", "cpu", "--arch", "gemma2_27b", "--batch", "2",
                      "--prompt-len", "4", "--tokens", "3"])
    assert out.shape == (2, 3)


def test_serve_cli_asks_for_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--preset", "tiny"])


# ------------------------------------------------------------------ imports


def test_lm_modules_import_neither_jax_nor_the_reference():
    import subprocess

    code = ("import sys, repro_torch.launch.serve, repro_torch.interop\n"
            "import repro_torch.models.moe, repro_torch.models.ssm, repro_torch.core.placement\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'repro'))\n"
            "sys.exit(1 if bad else 0)\n")
    src = str(__import__("pathlib").Path(__file__).resolve().parents[1] / "src")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**__import__("os").environ, "PYTHONPATH": src}, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
