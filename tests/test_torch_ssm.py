"""Port parity, the mamba2 SSD mixer: `repro_torch.models.ssm` against
`repro.models.ssm`, on the CPU.

Inputs are seeded numpy arrays fed to both: x, positive step sizes dt
(a softplus), negative A, and B and C, at b 2, 64 steps, 3 heads of size
4, a state of 5; the mixer at mamba2_780m's and jamba_1_5_large's reduced
configs (d_state 16, head_dim 16, chunk 16) with the reference's init and
its all-zero leaves (conv_b, dt_bias, A_log, out_norm) replaced by seeded
noise.

Tolerances (f32, sums in another order: the reference contracts its
three- and four-operand einsums in XLA's order, the port pairwise):
`_segsum` and `pick_chunk` exact; `ssd_chunked` at chunks 8, 32 and 64
against the reference and against the sequential recurrence (one step at
a time, the decode branch's own arithmetic), atol 1e-5 plus rtol 1e-5 of
the value (the outputs reach ~10); `ssm_block` without a cache, and a
prefill into a fresh cache followed by one-token decode steps (f32 and
bf16 caches), output and cache against the reference's, atol 1e-5 (a bf16
cache: 1e-3 for the steps that read it, as `tests/test_torch_lm.py`
holds serving over bf16 caches).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import ssm as ref_ssm
from repro_torch import configs
from repro_torch.models import ssm

ATOL, RTOL = 1e-5, 1e-5
SERVE_ATOL = 1e-3


def _ssd_inputs(seed=0, b=2, s=64, h=3, p=4, n=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0)).astype(np.float32)
    A = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    Bm = rng.standard_normal((b, s, n)).astype(np.float32)
    Cm = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _sequential(x, dt, A, Bm, Cm):
    """The SSM as a recurrence over every step from a zero state."""
    b, s, h, p = x.shape
    state = torch.zeros((b, h, p, Bm.shape[-1]))
    return ssm._recurrence(state, *(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)))


def test_segsum_matches_reference():
    a = np.random.default_rng(1).standard_normal((2, 3, 9)).astype(np.float32)
    want = np.asarray(ref_ssm._segsum(jnp.asarray(a)))
    got = ssm._segsum(torch.from_numpy(a)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)], rtol=0,
                               atol=1e-6)


def test_pick_chunk_matches_reference():
    for S in list(range(1, 130)) + [1021, 1024, 1056, 4096]:
        for chunk in (1, 8, 16, 32, 64, 256):
            assert ssm.pick_chunk(S, chunk) == ref_ssm.pick_chunk(S, chunk), (S, chunk)
    assert ssm.pick_chunk(1021, 256) == 1  # a prime length: a loop of S steps


@pytest.mark.parametrize("chunk", [8, 32, 64])
def test_ssd_chunked_matches_reference_and_recurrence(chunk):
    args = _ssd_inputs()
    want_y, want_state = ref_ssm.ssd_chunked(*(jnp.asarray(a) for a in args), chunk)
    y, state = ssm.ssd_chunked(*(torch.from_numpy(a) for a in args), chunk)
    assert y.shape == args[0].shape and state.shape == (2, 3, 4, 5)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state), rtol=RTOL, atol=ATOL)
    seq_y, seq_state = _sequential(*args)
    np.testing.assert_allclose(y.numpy(), seq_y.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(state.numpy(), seq_state.numpy(), rtol=RTOL, atol=ATOL)


def test_ssd_chunked_refuses_a_chunk_that_does_not_divide():
    args = _ssd_inputs(s=12)
    with pytest.raises(ValueError, match="does not divide"):
        ssm.ssd_chunked(*(torch.from_numpy(a) for a in args), 8)


def _block(name, seed):
    """(ref config, port config, reference params (numpy), port SSM)."""
    ref_cfg, cfg = ref_configs.reduced_config(name), configs.reduced_config(name)
    rng = np.random.default_rng(seed)
    rp = {k: np.asarray(v) for k, v in
          ref_ssm.init_ssm(ref_cfg, jax.random.PRNGKey(seed), jnp.float32).items()}
    rp = {k: v if v.any() else (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
          for k, v in rp.items()}
    p = ssm.SSM(cfg)
    for k, v in rp.items():
        setattr(p, k, torch.nn.Parameter(torch.from_numpy(v.copy()), requires_grad=False))
    return ref_cfg, cfg, rp, p


@pytest.mark.parametrize("name", ["mamba2_780m", "jamba_1_5_large"])
def test_ssm_block_without_cache_matches_reference(name):
    ref_cfg, cfg, rp, p = _block(name, 2)
    x = np.random.default_rng(3).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    want, _ = ref_ssm.ssm_block(ref_cfg, rp, jnp.asarray(x))
    got, cache = ssm.ssm_block(cfg, p, torch.from_numpy(x))
    assert cache is None and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["mamba2_780m", "jamba_1_5_large"])
def test_ssm_block_prefill_and_decode_match_reference(name, cache_dtype):
    """A prefill of 16 into a fresh cache (the chunked SSD; the cache's
    state is not read), then 8 one-token steps (the recurrence): each call's
    output and the cache it leaves against the reference's. A bf16 conv
    state comes back f32, in both packages."""
    ref_cfg, cfg, rp, p = _block(name, 4)
    s = cfg.ssm
    B, d_in = 2, s.expand * cfg.d_model
    nh = d_in // s.head_dim
    jdt, tdt = (jnp.float32, torch.float32) if cache_dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    conv_shape = (B, s.d_conv - 1, d_in + 2 * s.d_state)
    rc = dict(state=jnp.zeros((B, nh, s.head_dim, s.d_state), jnp.float32),
              conv=jnp.zeros(conv_shape, jdt))
    pc = ssm.SSMCache(state=torch.zeros((B, nh, s.head_dim, s.d_state)),
                      conv=torch.zeros(conv_shape, dtype=tdt))
    x = np.random.default_rng(5).standard_normal((B, 24, cfg.d_model)).astype(np.float32)
    tol = ATOL if cache_dtype == "float32" else SERVE_ATOL
    for lo, hi in [(0, 16)] + [(t, t + 1) for t in range(16, 24)]:
        want, rc = ref_ssm.ssm_block(ref_cfg, rp, jnp.asarray(x[:, lo:hi]), cache=rc)
        got, out = ssm.ssm_block(cfg, p, torch.from_numpy(x[:, lo:hi]), cache=pc)
        assert out is pc
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)
        np.testing.assert_allclose(pc.state.numpy(), np.asarray(rc["state"]), rtol=0, atol=tol)
        assert str(pc.conv.dtype).replace("torch.", "") == rc["conv"].dtype.name == "float32"
        np.testing.assert_allclose(pc.conv.numpy(), np.asarray(rc["conv"]), rtol=0, atol=tol)


def test_ssm_prefill_ignores_the_cache_state():
    """As the reference: a call of S > 1 with a cache starts the SSD from a
    zero state, whatever the cache's state holds (the conv state is read)."""
    _, cfg, _, p = _block("mamba2_780m", 6)
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((1, 8, cfg.d_model))
                         .astype(np.float32))

    def run(state_fill):
        c = ssm.SSMCache(state=torch.full((1, nh, s.head_dim, s.d_state), state_fill),
                         conv=torch.zeros((1, s.d_conv - 1, d_in + 2 * s.d_state)))
        return ssm.ssm_block(cfg, p, x, cache=c)[0]

    assert torch.equal(run(0.0), run(5.0))


def test_init_ssm_matches_reference_layout():
    ref_cfg, cfg = ref_configs.reduced_config("mamba2_780m"), configs.reduced_config(
        "mamba2_780m")
    want = ref_ssm.init_ssm(ref_cfg, jax.random.PRNGKey(0), jnp.bfloat16)
    got = ssm.init_ssm(cfg, torch.Generator().manual_seed(0), torch.bfloat16)
    for k, v in want.items():
        t = getattr(got, k)
        assert tuple(t.shape) == v.shape and str(t.dtype).replace("torch.", "") == v.dtype.name, k
    for k in ("conv_b", "dt_bias", "A_log", "out_norm"):
        assert not getattr(got, k).any()
    assert bool((got.D == 1).all())
