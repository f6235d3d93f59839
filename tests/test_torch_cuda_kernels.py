"""The port's kernels on the card: `segment_reduce`, `ebg_membership` and
`decode_attention` against their plain PyTorch versions (marked `cuda`;
they skip without a card). This file imports neither jax nor the reference
package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Exact: segment min and max, membership. Tolerance: segment sums rtol 1e-5 /
atol 1e-6 (atomics add in another order); attention 2e-5 in f32 and, in
bf16, one rounding of the output (rtol 2^-7, atol 1e-5), which a 1 % error
fails.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attn as pt_attn
from repro_torch.kernels import ebg_score as pt_memb
from repro_torch.kernels import ops as pt_ops

SUM_RTOL, SUM_ATOL = 1e-5, 1e-6
ENTRIES = {"min": pt_ops.segment_min_plus, "max": pt_ops.segment_max,
           "sum": pt_ops.segment_sum_scaled}
# (rtol, atol). bf16: one bf16 rounding of the output (a one-ulp
# disagreement is at most 2^-7 of the value) plus an f32-level atol for
# values near zero; a 1 % error must fail it, and the test checks so.
DTYPES = {"float32": (torch.float32, (2e-5, 2e-5)), "bfloat16": (torch.bfloat16, (2**-7, 1e-5))}
# The parity tests' decode shapes (B, Hq, Hkv, D, S), and gemma2_27b's
# attention widths at a short cache with a ragged last chunk.
DECODE_SHAPES = [(2, 8, 4, 64, 512), (1, 4, 4, 32, 1024), (3, 12, 2, 64, 512),
                 (2, 32, 16, 128, 1000)]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ------------------------------------------------- on the card (skip here)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["min", "max", "sum"])
def test_cuda_segment_reduce_matches_plain(cuda_device, op):
    """Kernel against plain version on a hub-heavy stream whose two halves
    are each dst-sorted (as the engine's symmetric streams are)."""
    rng = np.random.default_rng(2)
    V, E = 5000, 1 << 20
    half = np.where(rng.random(E // 2) < 0.9, 11, rng.integers(0, V, E // 2))
    ldst = np.concatenate([np.sort(half), np.sort(rng.integers(0, V, E // 2))]).astype(np.int32)
    lsrc = rng.integers(0, V, E).astype(np.int32)
    w = (rng.random(E) if op != "max" else np.zeros(E)).astype(np.float32)
    w[-100:] = 0.0 if op == "sum" else np.float32(3.0e38)
    val = (rng.random(V + 1) * 10 - 5).astype(np.float32)
    port = ENTRIES[op]
    args = [_t(a) for a in (lsrc, ldst, w, val)]
    want = port(*args, num_out=V + 1)
    got = port(*(a.to(cuda_device) for a in args), num_out=V + 1)
    torch.cuda.synchronize()
    if op == "sum":
        torch.testing.assert_close(got.cpu(), want, rtol=SUM_RTOL, atol=SUM_ATOL)
    else:
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_ebg_membership_matches_plain(cuda_device):
    rng = np.random.default_rng(4)
    p, V = 32, 10_000
    for E in (4096, 4099):  # the 16-byte path and the scalar tail
        keep = torch.from_numpy(rng.random((p, V)) < 0.3)
        bits = pt_ops.pack_keep_bits(keep)
        u = _t(rng.integers(0, V, E).astype(np.int32))
        v = _t(rng.integers(0, V, E).astype(np.int32))
        want = pt_memb.ebg_membership_plain(bits, u, v)
        got = pt_ops.ebg_membership(bits.to(cuda_device), u.to(cuda_device), v.to(cuda_device))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_cuda_decode_attention_matches_plain(cuda_device, dtype, softcap):
    tdt, tol = DTYPES[dtype]
    gen = torch.Generator().manual_seed(0)
    for B, Hq, Hkv, D, S in DECODE_SHAPES:
        q, k, v = (torch.randn(s, generator=gen).to(tdt)
                   for s in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
        want = pt_attn.decode_attention_plain(q, k, v, softcap=softcap)
        got = pt_ops.decode_attention(q.to(cuda_device), k.to(cuda_device), v.to(cuda_device),
                                      softcap=softcap)
        torch.cuda.synchronize()
        got, want = got.cpu().float(), want.float()
        torch.testing.assert_close(got, want, rtol=tol[0], atol=tol[1])
        assert not torch.allclose(got * 1.01, want, rtol=tol[0], atol=tol[1])
