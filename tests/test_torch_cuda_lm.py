"""The LM serving path on the card: `repro_torch.launch.serve.generate` and
the decode step's `decode_attention` kernel, against the same run on the
plain attention, against the CPU, and against the full forward (marked
`cuda`; they skip without a card). This file imports neither jax nor the
reference package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_lm.py

Tolerances. `generate` runs f32 parameters over bf16 caches, as the
serving driver does: the kernel's run and the plain attention's on the
card differ only in the order of the attention's f32 sums, but a K or V
value computed an f32 ulp apart can round to the neighbouring bf16 value
and the step's cache keeps it, so logits atol 2e-3 and tokens equal
wherever the plain run's top-2 margin exceeds it. Over f32 caches nothing
rounds to bf16: the card's decode steps against the CPU's, logits atol
1e-4 (as `tests/test_torch_lm.py` holds the port's forward against the
reference), and against the card's full forward 2e-3, as
`tests/test_models.py` holds the reference.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels.dispatch import LAUNCHES
from repro_torch.launch import serve, train
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

SERVE_ATOL = 2e-3
F32_ATOL = 1e-4
DECODE_ATOL = 2e-3
DENSE = ["llama3_2_3b", "qwen3_4b", "qwen2_72b", "gemma2_27b", "qwen2_vl_2b"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode kernel has no CPU build")
    return torch.device("cuda")


def _config(name):
    return train.preset_config("tiny") if name == "preset_tiny" else configs.reduced_config(name)


def _params(cfg, device):
    """f32 parameters drawn on the CPU (so both devices hold the same
    numbers), with nonzero norm scales and biases, moved to `device`."""
    p = T.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    gen = torch.Generator().manual_seed(1)
    for t in p.parameters():
        if not t.any():
            t.data = 0.1 * torch.randn(t.shape, generator=gen)
    return p.to(device)


def _run(cfg, params, prompt, max_new):
    seen = {}
    toks = serve.generate(cfg, params, prompt, max_new, prompt.shape[1] + max_new,
                          on_step=lambda t, lg: seen.__setitem__(t, lg.float().cpu()))
    return toks.cpu(), torch.stack([seen[t] for t in range(max_new + 1)], dim=1)


def _compare(got_toks, got, want_toks, want, tol):
    """Row by row, step by step: logits within tol and tokens equal, until
    a step whose top-2 margin in `want` is within tol, where the row may
    take the other token (its continuation is then not comparable)."""
    top = want.topk(2, dim=-1).values
    margin = top[..., 0] - top[..., 1]
    for b in range(want_toks.shape[0]):
        for t in range(want_toks.shape[1]):
            torch.testing.assert_close(got[b, t], want[b, t], rtol=0, atol=tol)
            if got_toks[b, t] != want_toks[b, t]:
                assert margin[b, t] <= tol, (b, t)
                break
            if margin[b, t] <= tol:
                break


@pytest.mark.cuda
@pytest.mark.parametrize("name", DENSE + ["preset_tiny"])
def test_cuda_generate_matches_plain_attention(cuda_device, name):
    """f32 parameters over bf16 caches, B = 4: the decode step launches the
    (f32 q, bf16 cache) kernel once a layer a token, and its logits and
    tokens follow the same call on the plain attention
    (`plain_decode_attention`), which launches nothing."""
    cfg = _config(name)
    params = _params(cfg, cuda_device)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (4, 12)))
    max_new = 8
    before = LAUNCHES["decode_attention"]
    toks, logits = _run(cfg, params, prompt, max_new)
    assert LAUNCHES["decode_attention"] - before == cfg.n_layers * max_new
    with L.plain_decode_attention():
        ptoks, plogits = _run(cfg, params, prompt, max_new)
    assert LAUNCHES["decode_attention"] - before == cfg.n_layers * max_new
    _compare(toks, logits, ptoks, plogits, SERVE_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", DENSE + ["preset_tiny"])
def test_cuda_decode_matches_cpu_and_full_forward(cuda_device, name):
    """A prefill of 16 and 16 one-token steps over f32 caches on the card:
    each step's logits against the same steps on the CPU, and against one
    full forward on the card."""
    cfg = _config(name)
    B, S = 2, 32
    rng = np.random.default_rng(1)
    if cfg.frontend:
        key, x = "embeds", torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))
                                            .astype(np.float32))
    else:
        key, x = "tokens", torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    runs = {}
    for dev in ("cpu", cuda_device):
        params, xd = _params(cfg, dev), x.to(dev)
        caches = T.init_caches(cfg, B, S, torch.float32, device=dev)
        logits, caches = T.forward(cfg, params, **{key: xd[:, :16]}, caches=caches,
                                   cache_pos=0)
        outs = [logits]
        before = LAUNCHES["decode_attention"]
        for t in range(16, S):
            lg, caches = T.forward(cfg, params, **{key: xd[:, t:t + 1]}, caches=caches,
                                   cache_pos=t)
            outs.append(lg)
        launched = LAUNCHES["decode_attention"] - before
        assert launched == (0 if dev == "cpu" else cfg.n_layers * (S - 16))
        runs[str(dev)] = torch.cat(outs, dim=1).cpu()
    full, _ = T.forward(cfg, params, **{key: xd})
    got = runs[str(cuda_device)]
    torch.testing.assert_close(got, runs["cpu"], rtol=0, atol=F32_ATOL)
    torch.testing.assert_close(got, full.cpu(), rtol=0, atol=DECODE_ATOL)


@pytest.mark.cuda
def test_cuda_generate_bf16_full_width_layer_shapes(cuda_device):
    """llama3_2_3b's attention and MLP widths (d 3072, 24 heads over 8,
    head_dim 128) in bf16, two layers and a cut vocabulary: the decode
    step's kernel (bf16 q, bf16 cache) against the plain version."""
    import dataclasses

    cfg = dataclasses.replace(configs.get_config("llama3_2_3b"), n_layers=2, vocab=4096)
    params = T.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                           torch.bfloat16)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (8, 64)))
    toks, logits = _run(cfg, params, prompt, 8)
    with L.plain_decode_attention():
        ptoks, plogits = _run(cfg, params, prompt, 8)
    assert torch.isfinite(logits).all()
    torch.testing.assert_close(logits[:, 0], plogits[:, 0], rtol=0, atol=0)  # the prefill
    # bf16 logits: four bf16 steps of a |logit| below 8 (2^-5 each).
    _compare(toks, logits, ptoks, plogits, 0.125)
