"""The port's kernels on the card: `bsp_superstep`'s sum, `segment_reduce`,
`ebg_membership`, `decode_attention`, `ebg_commit` and its two layout
transposes against their plain PyTorch versions, and `segment_reduce`'s id
guard (marked `cuda`; they skip without a card). This file imports neither
jax nor the reference package, so it runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Exact: segment min and max, membership, the commit and the transposes.
Tolerance: segment and superstep sums rtol 1e-5 / atol 1e-6 (both add in
f64, atomics in another order); attention 2e-5 in f32 and, in bf16, one
rounding of the output (rtol 2^-7, atol 1e-5), which a 1 % error fails.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import bsp_superstep as pt_bsp
from repro_torch.kernels import decode_attn as pt_attn
from repro_torch.kernels import ebg_commit as pt_ebg
from repro_torch.kernels import ebg_score as pt_memb
from repro_torch.kernels import ops as pt_ops
from repro_torch.kernels import segment_reduce as pt_seg

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
@pytest.mark.parametrize("E", [1 << 18, (1 << 18) + 3])
def test_cuda_bsp_superstep_sum_matches_plain(cuda_device, E):
    """The sum kernel on a hub stream (one destination owns 90 % of each
    worker's edges), values of both signs, a row length that is a multiple
    of 4 (16-byte loads) and one that is not (scalar loads), and one worker
    whose row is all pads."""
    rng = np.random.default_rng(5)
    p, n = 4, 6000
    dst = np.where(rng.random((p, E)) < 0.9, 23, rng.integers(0, n - 1, (p, E)))
    ldst = np.sort(dst, axis=1).astype(np.int32)
    lsrc = rng.integers(0, n, (p, E)).astype(np.int32)
    w = rng.random((p, E)).astype(np.float32)
    w[:, -7:], ldst[:, -7:] = 0.0, n - 1
    lsrc[2], ldst[2], w[2] = 0, n - 1, 0.0  # worker 2: all pads
    val = (rng.random((p, n)) * 10 - 5).astype(np.float32)
    deg = rng.integers(0, 4, (p, n)).astype(np.float32)
    args = [_t(a) for a in (lsrc, ldst, w, val)]
    kw = dict(num_out=n, combine="sum", out_degree=_t(deg))
    want, want_it = pt_bsp.bsp_superstep(*args, **kw)
    kw["out_degree"] = kw["out_degree"].to(cuda_device)
    got, got_it = pt_bsp.bsp_superstep(*(a.to(cuda_device) for a in args), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got_it.cpu(), want_it)
    assert (got[2] == 0).all()
    torch.testing.assert_close(got.cpu(), want, rtol=SUM_RTOL, atol=SUM_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["min", "sum"])
def test_cuda_segment_reduce_unaligned_stream(cuda_device, op):
    """Streams that start off a 16-byte boundary and end in a ragged group
    take the scalar loads."""
    rng = np.random.default_rng(6)
    V, E = 700, 50_001
    ldst = np.sort(rng.integers(0, V, E + 1)).astype(np.int32)
    lsrc = rng.integers(0, V, E + 1).astype(np.int32)
    w = rng.random(E + 1).astype(np.float32)
    val = (rng.random(V) * 10 - 5).astype(np.float32)
    args = [_t(a) for a in (lsrc, ldst, w)]
    want = ENTRIES[op](*(a[1:] for a in args), _t(val), num_out=V)
    got = ENTRIES[op](*(a.to(cuda_device)[1:] for a in args), _t(val).to(cuda_device),
                      num_out=V)
    torch.cuda.synchronize()
    if op == "sum":
        torch.testing.assert_close(got.cpu(), want, rtol=SUM_RTOL, atol=SUM_ATOL)
    else:
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["min", "sum"])
@pytest.mark.parametrize("name,bad", [("lsrc", 10), ("lsrc", -1), ("ldst", 8), ("ldst", -2)])
def test_cuda_segment_reduce_rejects_out_of_range_ids(cuda_device, monkeypatch, op, name, bad):
    """The kernel's guard refuses an id outside val (lsrc) or the output
    (ldst) with the CPU path's ValueError; the next good call succeeds, so
    the flag is reset, and it takes no aminmax."""
    rng = np.random.default_rng(8)
    V, n, E = 10, 8, 5000
    good = dict(lsrc=rng.integers(0, V, E), ldst=np.sort(rng.integers(0, n, E)))
    good = {k: _t(a.astype(np.int32)).to(cuda_device) for k, a in good.items()}
    w = _t(rng.random(E).astype(np.float32)).to(cuda_device)
    val = _t(rng.random(V).astype(np.float32)).to(cuda_device)
    bad_args = dict(good)
    bad_args[name] = good[name].clone()
    bad_args[name][E // 2] = bad
    with pytest.raises(ValueError, match=f"{name} has ids"):
        pt_seg.segment_reduce(bad_args["lsrc"], bad_args["ldst"], w, val, num_out=n, op=op)
    calls = []
    aminmax = torch.aminmax
    monkeypatch.setattr(torch, "aminmax", lambda *a, **k: calls.append(1) or aminmax(*a, **k))
    got = pt_seg.segment_reduce(good["lsrc"], good["ldst"], w, val, num_out=n, op=op)
    want = pt_seg.segment_reduce_plain(*(t.cpu() for t in (good["lsrc"], good["ldst"], w, val)),
                                       n, op=op)
    assert not calls
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


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_cuda_decode_attention_splits(cuda_device, D, dtype, softcap):
    """The split-S kernel over cache lengths of one key, a ragged tile, one
    whole tile and a length that the split count does not divide (whose
    last split is one key), at batch 1 and 3 and 1 to 8 query rows a kv
    head."""
    tdt, tol = DTYPES[dtype]
    gen = torch.Generator().manual_seed(D)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    Hkv = 2
    tile = pt_attn.tile_keys(D, tdt)
    for S in (1, 31, tile, 20_001):
        for B in (1, 3):
            for G in (1, 2, 4, 8):
                nsplit = pt_attn.split_count(B, S, Hkv, G, sms, tile)
                if S == 20_001:
                    assert nsplit > 1 and S % nsplit
                q, k, v = (torch.randn(s, generator=gen).to(tdt)
                           for s in ((B, Hkv * G, D), (B, S, Hkv, D), (B, S, Hkv, D)))
                want = pt_attn.decode_attention_plain(q, k, v, softcap=softcap).float()
                got = pt_ops.decode_attention(q.to(cuda_device), k.to(cuda_device),
                                              v.to(cuda_device), softcap=softcap)
                torch.cuda.synchronize()
                got = got.cpu().float()
                torch.testing.assert_close(got, want, rtol=tol[0], atol=tol[1])
                assert not torch.allclose(got * 1.01, want, rtol=tol[0], atol=tol[1])


def _commit_stream_inputs(seed, p, V, n, weighted, hub):
    """A bitset, counters and an n-edge stream over V vertices. `hub`: most
    edges share one of three endpoints, so consecutive blocks overlap."""
    rng = np.random.default_rng(seed)
    vw = (V + 31) // 32
    keep = rng.integers(-2**31, 2**31, (p, vw), dtype=np.int64)
    keep &= rng.integers(-2**31, 2**31, (p, vw), dtype=np.int64)  # sparser
    e = rng.integers(0, 40, p).astype(np.float32)
    v = rng.integers(0, 60, p).astype(np.float32)
    u = rng.integers(0, V, n)
    w = rng.integers(0, V, n)
    if hub:
        u = np.where(rng.random(n) < 0.8, rng.integers(0, 3, n), u)
        w = np.where(rng.random(n) < 0.5, rng.integers(0, 3, n), w)
    valid = rng.random(n) < 0.9
    wu = wv = None
    if weighted:
        wu = torch.from_numpy((rng.random(n) + 1.0).astype(np.float32))
        wv = torch.from_numpy((rng.random(n) + 1.0).astype(np.float32))
    coef = pt_ops.commit_coefficients(alpha=1.0, beta=0.7, inv_e=np.float32(p) / np.float32(5 * n),
                                      inv_v=np.float32(p) / np.float32(V), eps=1.0, device="cpu")
    state = [torch.from_numpy(keep.astype(np.int32)), torch.from_numpy(e), torch.from_numpy(v)]
    edges = [torch.from_numpy(u.astype(np.int32)), torch.from_numpy(w.astype(np.int32)),
             torch.from_numpy(valid)]
    return state, edges, coef, wu, wv


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 8, 31, 32, 33, 64])
@pytest.mark.parametrize("block", [1, 7, 64, 256])
@pytest.mark.parametrize("window", [False, True], ids=["frozen", "window"])
@pytest.mark.parametrize("balance", ["static", "range"])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_cuda_ebg_commit_matches_plain(cuda_device, p, block, window, balance, weighted):
    """Three blocks through `ebg_commit_stream` and one through
    `ebg_commit_block`, bitwise against the plain version, on a uniform
    stream and on a hub-heavy one (the patch across the block boundary),
    with V not a multiple of 32."""
    nblocks = 3
    for hub in (False, True):
        state, edges, coef, wu, wv = _commit_stream_inputs(p * block + hub, p, 1007,
                                                           nblocks * block, weighted, hub)
        kw = dict(balance=balance, window=window)
        dev = [t.to(cuda_device) for t in state]
        want_state = [t.clone() for t in state]
        want = pt_ebg.ebg_commit_stream(*want_state, *edges, coef, block=block, wu=wu, wv=wv,
                                        **kw)
        got = pt_ebg.ebg_commit_stream(*dev, *(t.to(cuda_device) for t in edges),
                                       coef.to(cuda_device), block=block,
                                       wu=None if wu is None else wu.to(cuda_device),
                                       wv=None if wv is None else wv.to(cuda_device), **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
        for g, w in zip(dev, want_state):
            assert torch.equal(g.cpu(), w)
        sl = slice(block, 2 * block)
        args = [*state, *(t[sl] for t in edges), coef]
        bkw = dict(kw, wu=None if wu is None else wu[sl], wv=None if wv is None else wv[sl])
        want = pt_ebg.ebg_commit_block_plain(*args, **bkw)
        got = pt_ebg.ebg_commit_block(*(t.to(cuda_device) for t in args),
                                      **{k: (x.to(cuda_device) if torch.is_tensor(x) else x)
                                         for k, x in bkw.items()})
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 31, 32, 33, 64])
@pytest.mark.parametrize("V", [1, 33, 1000, (1 << 20) + 5])
def test_cuda_memb_transposes_match_plain(cuda_device, p, V):
    rng = np.random.default_rng(p * 7 + V)
    keep = torch.from_numpy(
        rng.integers(-2**31, 2**31, (p, (V + 31) // 32), dtype=np.int64).astype(np.int32))
    memb = pt_ebg.keep_bits_to_memb(keep.to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(memb.cpu(), pt_ebg.keep_bits_to_memb_plain(keep))
    back = pt_ebg.memb_to_keep_bits(memb, p)
    torch.cuda.synchronize()
    assert torch.equal(back.cpu(), keep)
    memb_rand = torch.from_numpy(
        rng.integers(-2**31, 2**31, tuple(memb.shape), dtype=np.int64).astype(np.int32))
    assert torch.equal(pt_ebg.memb_to_keep_bits(memb_rand.to(cuda_device), p).cpu(),
                       pt_ebg.memb_to_keep_bits_plain(memb_rand, p))
