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


# ------------------------------------- the MoE, SSM, hybrid and enc-dec stacks

FAMILIES = ["phi3_5_moe", "kimi_k2", "mamba2_780m", "jamba_1_5_large", "seamless_m4t_large_v2"]
# decode_attention's limits (rtol, atol) and its x1.01 control, as chip_smoke.py's ATTN_TOL.
ATTN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2**-7, 1e-5)}


def _self_attn_layers(cfg):
    return sum(cfg.group[i % len(cfg.group)].kind == "attn" for i in range(cfg.n_layers))


@pytest.mark.cuda
@pytest.mark.parametrize("name", FAMILIES)
def test_cuda_family_generate_matches_plain_attention(cuda_device, name):
    """`generate` for the MoE, SSM, hybrid (jamba: kernel, SSM and MoE in
    one stack) and encoder-decoder configs (no encoder input, as the
    reference's generate runs it), f32 parameters over bf16 caches, B = 4:
    one kernel launch an attention mixer a token (none for mamba2, whose
    layers are all SSM), and the logits and tokens of the same call on the
    plain attention."""
    cfg = _config(name)
    params = _params(cfg, cuda_device)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (4, 12)))
    max_new = 8
    before = LAUNCHES["decode_attention"]
    toks, logits = _run(cfg, params, prompt, max_new)
    assert LAUNCHES["decode_attention"] - before == _self_attn_layers(cfg) * max_new
    with L.plain_decode_attention():
        ptoks, plogits = _run(cfg, params, prompt, max_new)
    assert LAUNCHES["decode_attention"] - before == _self_attn_layers(cfg) * max_new
    _compare(toks, logits, ptoks, plogits, SERVE_ATOL)


def _steps_run(cfg, params, x, key, enc, dev, plain=False):
    """A prefill of 16 and 16 one-token steps over f32 caches: (logits
    [B, 17, vocab] on the CPU, decode_attention launches)."""
    import contextlib

    B, S = x.shape[:2]
    caches = T.init_caches(cfg, B, S, torch.float32, device=dev)
    with L.plain_decode_attention() if plain else contextlib.nullcontext():
        logits, caches = T.forward(cfg, params, **{key: x[:, :16]}, caches=caches, cache_pos=0,
                                   **enc)
        outs = [logits[:, -1:]]
        before = LAUNCHES["decode_attention"]
        for t in range(16, S):
            lg, caches = T.forward(cfg, params, **{key: x[:, t:t + 1]}, caches=caches,
                                   cache_pos=t, **enc)
            outs.append(lg)
    return torch.cat(outs, dim=1).cpu(), LAUNCHES["decode_attention"] - before


@pytest.mark.cuda
@pytest.mark.parametrize("case", FAMILIES + ["seamless_enc"])
def test_cuda_family_decode_matches_cpu_plain_and_full_forward(cuda_device, case):
    """Over f32 caches on the card: each decode step's logits against the
    same steps on the CPU (1e-4), on the plain attention on the card
    (1e-4), and (but for seamless without an encoder input, whose cross
    layers see other tokens in a full forward) against one full forward on
    the card (2e-3). seamless_enc: 12 encoder frames, the encoder's output
    computed once and passed to every step; the cross-attention's
    one-token calls launch the kernel over the fresh K and V (G = 1)."""
    name = "seamless_m4t_large_v2" if case == "seamless_enc" else case
    cfg = _config(name)
    B, S = 2, 32
    rng = np.random.default_rng(1)
    if cfg.frontend:
        key, x = "embeds", torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))
                                            .astype(np.float32))
    else:
        key, x = "tokens", torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    frames = torch.from_numpy(rng.standard_normal((B, 12, cfg.d_model)).astype(np.float32))
    runs = {}
    for dev in ("cpu", cuda_device):
        params, xd = _params(cfg, dev), x.to(dev)
        enc = {}
        if case == "seamless_enc":
            enc = {"enc_out": T.encode(cfg, params, enc_embeds=frames.to(dev))}
        runs[str(dev)], launched = _steps_run(cfg, params, xd, key, enc, dev)
        per_step = _self_attn_layers(cfg) + (cfg.n_layers if enc else 0)
        assert launched == (0 if dev == "cpu" else per_step * (S - 16))
    got = runs[str(cuda_device)]
    torch.testing.assert_close(got, runs["cpu"], rtol=0, atol=F32_ATOL)
    plain, launched = _steps_run(cfg, params, xd, key, enc, cuda_device, plain=True)
    assert launched == 0
    torch.testing.assert_close(got, plain, rtol=0, atol=F32_ATOL)
    if case != "seamless_m4t_large_v2":
        full, _ = T.forward(cfg, params, **{key: xd}, **enc)
        torch.testing.assert_close(got, full[:, 15:].cpu(), rtol=0, atol=DECODE_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_decode_attention_g1_over_fresh_kv(cuda_device, dtype):
    """Seamless's cross-attention shape: 16 query heads over 16 KV heads
    (G = 1), head_dim 64, over a fresh contiguous [B, Se, 16, 64] K and V
    (the source's projection, not a cache), at Se of one key, a ragged
    tile and 1,024 frames; softcap 0 and 50; each beside its x1.01
    control. Then the layer's one-token kv_x call on the card against the
    CPU, one launch."""
    from repro_torch.kernels import decode_attn as pt_attn
    from repro_torch.kernels import ops as pt_ops

    tdt = getattr(torch, dtype)
    rtol, atol = ATTN_TOL[tdt]
    gen = torch.Generator().manual_seed(64)
    B, H, D, d = 3, 16, 64, 256
    for Se in (1, 37, 1024):
        src = torch.randn((B, Se, d), generator=gen)
        wk, wv = (torch.randn((d, H, D), generator=gen) * d ** -0.5 for _ in range(2))
        k = (src @ wk.reshape(d, -1)).reshape(B, Se, H, D).to(tdt)
        v = (src @ wv.reshape(d, -1)).reshape(B, Se, H, D).to(tdt)
        q = torch.randn((B, H, D), generator=gen).to(tdt)
        for softcap in (0.0, 50.0):
            want = pt_attn.decode_attention_plain(q, k, v, softcap=softcap).float()
            before = LAUNCHES["decode_attention"]
            got = pt_ops.decode_attention(q.to(cuda_device), k.to(cuda_device),
                                          v.to(cuda_device), softcap=softcap)
            torch.cuda.synchronize()
            assert LAUNCHES["decode_attention"] == before + 1
            got = got.cpu().float()
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
            assert not torch.allclose(got * 1.01, want, rtol=rtol, atol=atol)
    cfg = _config("seamless_m4t_large_v2")
    attn = _params(cfg, "cpu").layers[0].cross
    x = torch.randn((B, 1, cfg.d_model), generator=gen)
    src = torch.randn((B, 12, cfg.d_model), generator=gen)
    pos = torch.zeros((B, 1), dtype=torch.long)
    want, _ = L.attention(cfg, attn, x, pos, causal=False, kv_x=src)
    before = LAUNCHES["decode_attention"]
    got, _ = L.attention(cfg, attn.to(cuda_device), x.to(cuda_device), pos.to(cuda_device),
                         causal=False, kv_x=src.to(cuda_device))
    assert LAUNCHES["decode_attention"] == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=F32_ATOL)


WIDE = {"float32": (torch.float32, torch.float32), "bfloat16": (torch.bfloat16, torch.bfloat16),
        "float32/bfloat16": (torch.float32, torch.bfloat16)}


@pytest.mark.cuda
@pytest.mark.parametrize("D", [320, 384, 512])
@pytest.mark.parametrize("dtypes", list(WIDE))
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_cuda_decode_attention_head_dims_to_512(cuda_device, D, dtypes, softcap):
    """head_dim 257-512 runs on the DP = 512 build (32 keys a stage in
    bf16, 16 in f32, chosen from the card's shared memory), with 1, 4 and 8
    query rows a kv head: the whole cache, one key, and key ranges of a
    cache whose keys outside the range are NaN, one long enough to split;
    against the plain version with its x1.01 control. Past 512 the call
    runs on the wide source (`decode_attn_wide.cu`) and is not refused."""
    from repro_torch.kernels import decode_attn as pt_attn
    from repro_torch.kernels import ops as pt_ops

    qt, kt = WIDE[dtypes]
    rtol, atol = ATTN_TOL[qt]
    gen = torch.Generator().manual_seed(D)
    Hkv, S_max = 2, 3000
    for B, G in ((1, 1), (3, 4), (2, 8)):
        q = torch.randn((B, Hkv * G, D), generator=gen).to(qt)
        k, v = (torch.randn((B, S_max, Hkv, D), generator=gen).to(kt) for _ in range(2))
        for start, end in ((0, S_max), (0, 1), (5, 77), (100, S_max - 1)):
            kd, vd = k.clone(), v.clone()
            for t in (kd, vd):
                t[:, :start] = float("nan")
                t[:, end:] = float("nan")
            want = pt_attn.decode_attention_plain(q, k[:, start:end], v[:, start:end],
                                                  softcap=softcap).float()
            before = LAUNCHES["decode_attention"]
            got = pt_ops.decode_attention(q.to(cuda_device), kd.to(cuda_device),
                                          vd.to(cuda_device), softcap=softcap, start=start,
                                          end=end)
            torch.cuda.synchronize()
            assert LAUNCHES["decode_attention"] == before + 1
            assert got.dtype == qt and got.shape == q.shape
            got = got.cpu().float()
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
            assert not torch.allclose(got * 1.01, want, rtol=rtol, atol=atol)
    # Past 512 nothing is refused: the call runs on the wide source.
    q = torch.randn((1, 2, 513), generator=gen).to(qt)
    k = torch.randn((1, 4, 2, 513), generator=gen).to(kt)
    before = LAUNCHES["decode_attention"]
    got = pt_ops.decode_attention(q.to(cuda_device), k.to(cuda_device), k.to(cuda_device),
                                  softcap=softcap)
    torch.cuda.synchronize()
    assert LAUNCHES["decode_attention"] == before + 1
    torch.testing.assert_close(got.cpu().float(),
                               pt_attn.decode_attention_plain(q, k, k, softcap=softcap).float(),
                               rtol=rtol, atol=atol)


# The wide kernel's cases (B, G, S_max, key ranges): one key; 31, a ragged
# tile; 700 with 1, 4 and 8 query rows a kv head; 20,001 in 66 splits of 19
# tiles whose last is short (the split count divides no tile count).
WIDE_CASES = ((1, 1, 1, ((0, 1),)),
              (3, 4, 31, ((0, 31), (0, 1), (5, 29))),
              *((B, G, 700, ((0, 700), (0, 1), (5, 77), (100, 699)))
                for B, G in ((1, 1), (3, 4), (2, 8))),
              (1, 4, 20_001, ((0, 20_001), (37, 19_905))))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [513, 640, 1024, 1536, 4096])
@pytest.mark.parametrize("dtypes", list(WIDE))
@pytest.mark.parametrize("softcap", [0.0, 30.0, 50.0])
def test_cuda_decode_attention_wide_head_dims(cuda_device, D, dtypes, softcap):
    """head_dim above 512 on `decode_attn_wide.cu` (split-S over 2 KB slices
    of a row, a merge launch), with 1, 4 and 8 query rows a kv head: one
    key, a ragged tile, and 700 and 20,001 keys whose split count divides
    no tile count, at the whole cache and at key ranges of a cache whose
    keys outside the range are NaN; against the plain version (on the
    card: the inputs reach 1.3 GB) within the split-S builds' limits, with
    the x1.01 control; one launch counted a call."""
    from repro_torch.kernels import decode_attn as pt_attn
    from repro_torch.kernels import ops as pt_ops

    qt, kt = WIDE[dtypes]
    rtol, atol = ATTN_TOL[qt]
    gen = torch.Generator(device=cuda_device).manual_seed(D)
    Hkv = 2
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert pt_attn.kernel_source(D) == "decode_attn_wide"
    for B, G, S_max, ranges in WIDE_CASES:
        tiles = -(-S_max // pt_attn.WIDE_TILE_KEYS)
        nsplit = pt_attn.wide_split_count(B, S_max, Hkv, G, sms)
        if S_max == 20_001:
            assert nsplit > 1 and tiles % -(-tiles // nsplit)
        q = torch.randn((B, Hkv * G, D), generator=gen, device=cuda_device).to(qt)
        k, v = (torch.randn((B, S_max, Hkv, D), generator=gen, device=cuda_device).to(kt)
                for _ in range(2))
        for start, end in ranges:
            kd, vd = k.clone(), v.clone()
            for t in (kd, vd):
                t[:, :start] = float("nan")
                t[:, end:] = float("nan")
            want = pt_attn.decode_attention_plain(q, k[:, start:end], v[:, start:end],
                                                  softcap=softcap).float()
            before = LAUNCHES["decode_attention"]
            got = pt_ops.decode_attention(q, kd, vd, softcap=softcap, start=start, end=end)
            torch.cuda.synchronize()
            assert LAUNCHES["decode_attention"] == before + 1
            assert got.dtype == qt and got.shape == q.shape
            got = got.float()
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
            assert not torch.allclose(got * 1.01, want, rtol=rtol, atol=atol)
            del kd, vd
        del q, k, v
        torch.cuda.empty_cache()
