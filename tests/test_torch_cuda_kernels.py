"""The port's kernels on the card: `bsp_superstep`'s min and sum,
`segment_reduce`, `ebg_membership`, `decode_attention` (every head_dim to
256), `ebg_commit` (blocks of one tile and of several, 1 to 2,048 parts:
one chain warp, several, and the WIDE kernel past 1,024; window mode at any
block size) and its two layout transposes against their plain PyTorch versions,
the id guards of `segment_reduce`, `bsp_superstep` and `ebg_membership`, and
the hash-family partitioners on the card against their CPU path (marked
`cuda`; they skip without a card). This file imports neither
jax nor the reference package, so it runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Exact: segment and superstep min and max (values and iteration counts),
membership, the commit, the transposes and the hash family's parts.
Tolerance: segment and superstep sums rtol 1e-5 / atol 1e-6 (both add in
f64, atomics in another order); attention 2e-5 in an f32 output (q in f32,
over an f32 or a bf16 cache) and, in bf16, one rounding of the output
(rtol 2^-7, atol 1e-5), which a 1 % error fails.
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
@pytest.mark.parametrize("p", [1, 31, 32, 33, 64, 2048])
@pytest.mark.parametrize("E", [0, 1, 5, 4096, 4099])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
def test_cuda_ebg_membership_any_shape(cuda_device, p, E, offset):
    """The vertex-major kernel at any p (one memb word an endpoint per 32
    parts), the 16-byte path (E a multiple of 4, aligned), the scalar path
    (a ragged E, or u and v sliced at offset 1 off 16 bytes); bitwise."""
    rng = np.random.default_rng(p * 7 + E)
    V = 3000
    keep = torch.from_numpy(rng.random((p, V)) < 0.4)
    bits = pt_ops.pack_keep_bits(keep)
    ends = [_t(rng.integers(0, V, E + offset).astype(np.int32)) for _ in range(2)]
    u, v = (x.to(cuda_device)[offset:] for x in ends)
    got = pt_ops.ebg_membership(bits.to(cuda_device), u, v)
    torch.cuda.synchronize()
    want = pt_memb.ebg_membership_plain(bits, *(x[offset:] for x in ends))
    assert got.shape == (p, E) and torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("name,bad", [("u", -1), ("u", "32vw"), ("v", -1), ("v", "32vw")])
def test_cuda_ebg_membership_rejects_out_of_range_ids(cuda_device, monkeypatch, name, bad):
    """The kernel's id guard: an id outside [0, 32·vw) raises the
    ValueError of `check_ids`, and the flag is clear on the next call,
    which checks no ids on the host (no aminmax)."""
    rng = np.random.default_rng(9)
    p, vw, E = 33, 20, 4096
    bits = _t(rng.integers(-2**31, 2**31, (p, vw)).astype(np.int32)).to(cuda_device)
    ends = {n: _t(rng.integers(0, 32 * vw, E).astype(np.int32)).to(cuda_device)
            for n in ("u", "v")}
    args = {n: t.clone() for n, t in ends.items()}
    args[name][E // 2] = 32 * vw if bad == "32vw" else bad
    with pytest.raises(ValueError, match=f"{name} has ids"):
        pt_ops.ebg_membership(bits, args["u"], args["v"])
    calls = []
    aminmax = torch.aminmax
    monkeypatch.setattr(torch, "aminmax", lambda *a, **k: calls.append(1) or aminmax(*a, **k))
    got = pt_ops.ebg_membership(bits, ends["u"], ends["v"])
    want = pt_memb.ebg_membership_plain(bits.cpu(), ends["u"].cpu(), ends["v"].cpu())
    assert not calls
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [5, 32, 1000])
@pytest.mark.parametrize("name", ["hash", "dbh", "cvc"])
def test_cuda_hash_family_matches_cpu(cuda_device, name, p):
    """hash, DBH and CVC on the card: `part` on the card, bitwise the CPU
    path's (which the CPU tests hold to the reference), on a power-law
    graph and, for hash and CVC, on ids up to 2^31 - 1."""
    from repro_torch.core import PARTITIONERS
    from repro_torch.graph.generate import rmat
    from repro_torch.interop import graph_from_numpy

    graphs = [rmat(1 << 12, 1 << 15, seed=3)]
    if name != "dbh":  # DBH's degrees would take 2^31 counters
        top = 2**31 - 1
        ids = np.random.default_rng(1).integers(top - 5000, top + 1, 2000).astype(np.int32)
        graphs.append(graph_from_numpy(ids, ids[::-1].copy(), 2**31))
    for g in graphs:
        got = PARTITIONERS[name](g, p, device=cuda_device)
        want = PARTITIONERS[name](g, p, device="cpu")
        assert got.part.device.type == "cuda" and got.part.dtype == torch.int32
        assert torch.equal(got.part.cpu(), want.part)


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


# The decode step's calls: q in f32 over a bf16 cache (an f32 model's), and
# keys [start, end) of a preallocated cache read in place.
MIXED = {"float32": (torch.float32, torch.float32), "bfloat16": (torch.bfloat16, torch.bfloat16),
         "float32/bfloat16": (torch.float32, torch.bfloat16)}


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 128])
@pytest.mark.parametrize("dtypes", list(MIXED))
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_cuda_decode_attention_key_range(cuda_device, D, dtypes, softcap):
    """The kernel over keys [start, end) of a [B, S_max, Hkv, D] cache whose
    keys outside the range are NaN (a read outside it would show), against
    the plain version on the slice: one key, a ragged count, a range in the
    middle, the last key, the whole cache, and a range long enough to split."""
    from repro_torch.kernels.dispatch import LAUNCHES

    qt, kt = MIXED[dtypes]
    tol = DTYPES["float32" if qt == torch.float32 else "bfloat16"][1]
    gen = torch.Generator().manual_seed(D)
    for B, Hkv, G, S_max, ranges in ((3, 8, 3, 160, ((0, 1), (0, 37), (5, 64), (159, 160),
                                                     (0, 160))),
                                     (2, 2, 4, 20_001, ((1_000, 20_001), (0, 20_000)))):
        q = torch.randn((B, Hkv * G, D), generator=gen).to(qt)
        k, v = (torch.randn((B, S_max, Hkv, D), generator=gen).to(kt) for _ in range(2))
        for start, end in ranges:
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
            assert got.dtype == qt
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


# (p, V) of the transposes: every p at V of one word, a ragged word, and
# vertex words that no tile width (256, 128, 64 or 32) divides; the full
# width's 2^22 vertices and 5 more at up to two memb words; the sharded
# out-of-core path's keep [32, 16].
TRANSPOSE_SHAPES = ([(p, V) for p in (1, 31, 32, 33, 64, 1000, 1025, 2048)
                     for V in (1, 33, 1000, 100_005)]
                    + [(p, (1 << 22) + 5) for p in (1, 32, 33)] + [(32, 512)])


@pytest.mark.cuda
@pytest.mark.parametrize("p,V", TRANSPOSE_SHAPES)
def test_cuda_memb_transposes_match_plain(cuda_device, p, V):
    """Both transposes bitwise against their plain versions (run on the
    card: the bitsets reach 2^22 vertices), the round trip, and memb ->
    keep from random words (the bits of parts >= p dropped)."""
    rng = np.random.default_rng(p * 7 + V)
    keep = torch.from_numpy(
        rng.integers(-2**31, 2**31, (p, (V + 31) // 32), dtype=np.int64).astype(np.int32)
    ).to(cuda_device)
    memb = pt_ebg.keep_bits_to_memb(keep)
    torch.cuda.synchronize()
    assert torch.equal(memb, pt_ebg.keep_bits_to_memb_plain(keep))
    back = pt_ebg.memb_to_keep_bits(memb, p)
    torch.cuda.synchronize()
    assert torch.equal(back, keep)
    memb_rand = torch.from_numpy(
        rng.integers(-2**31, 2**31, tuple(memb.shape), dtype=np.int64).astype(np.int32)
    ).to(cuda_device)
    assert torch.equal(pt_ebg.memb_to_keep_bits(memb_rand, p),
                       pt_ebg.memb_to_keep_bits_plain(memb_rand, p))


def _min_stream(seed, p, n, E):
    """A [p, E] min-plus stream as the engine builds one: two dst-sorted
    halves (the second with a hub that takes 60 % of its edges), weights
    of 0 and small positive values with INF pads at each row's end, and
    values of both signs with -0, +0 and INF among them; worker 1 (when
    p > 1) is all pads."""
    rng = np.random.default_rng(seed)
    h = E // 2
    d1 = np.sort(rng.integers(0, n, (p, h)), axis=1)
    d2 = np.sort(np.where(rng.random((p, E - h)) < 0.6, 5 % n, rng.integers(0, n, (p, E - h))),
                 axis=1)
    ldst = np.concatenate([d1, d2], axis=1).astype(np.int32)
    lsrc = rng.integers(0, n, (p, E)).astype(np.int32)
    w = np.where(rng.random((p, E)) < 0.3, 0.0, rng.integers(1, 4, (p, E))).astype(np.float32)
    w[:, -min(9, E):] = np.float32(3.0e38)
    if p > 1:
        w[1] = np.float32(3.0e38)
    val = (rng.integers(-40, 60, (p, n)) * 0.5).astype(np.float32)
    pick = rng.random((p, n))
    val[pick < 0.05] = np.float32(-0.0)
    val[(pick >= 0.05) & (pick < 0.1)] = np.float32(3.0e38)
    return lsrc, ldst, w, val


def _unaligned(a, dev):
    """`a` on the card as a contiguous tensor 4 bytes off a 16-byte boundary."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
    flat[1:] = t.reshape(-1).to(dev)
    return flat[1:].view(t.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 3, 32])
@pytest.mark.parametrize("E", [(1 << 18), 50_001, "unaligned"])
@pytest.mark.parametrize("inner_cap", [1, 2, 10_000])
def test_cuda_bsp_superstep_min_matches_plain(cuda_device, p, E, inner_cap):
    """The min kernel against the plain version, bitwise in values and
    iteration counts, for min and for max (negation): 16-byte and scalar
    loads (a ragged row; a stream off a 16-byte boundary), lock-step passes
    of workers that converge at different passes, an all-pad worker."""
    n = 3000
    unaligned = E == "unaligned"
    rows = 40_000 if unaligned else E
    lsrc, ldst, w, val = _min_stream(p * 31 + rows, p, n, rows)
    for combine in ("min", "max"):
        args = [_t(a) for a in (lsrc, ldst, w, val)]
        kw = dict(num_out=n, combine=combine, inner_cap=inner_cap)
        want, want_it = pt_ops.bsp_superstep(*args, **kw)
        if unaligned:
            dev = [_unaligned(a, cuda_device) for a in (lsrc, ldst, w)] + [args[3].to(cuda_device)]
            assert dev[0].data_ptr() % 16
        else:
            dev = [a.to(cuda_device) for a in args]
        got, got_it = pt_ops.bsp_superstep(*dev, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got_it.cpu(), want_it)
        assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
        if p > 1:
            assert int(got_it[1]) == 0  # the all-pad worker changes nothing


@pytest.mark.cuda
def test_cuda_bsp_superstep_min_signed_zero_ties(cuda_device):
    """The seed keeps a tie: +0 offered to a -0 seed stays -0, -0 offered to
    a +0 seed stays +0; a lone -0 below the seed is taken as -0."""
    z = np.float32(-0.0)
    val = np.array([[z, 0.0, 0.0, 5.0, z]], np.float32)
    lsrc = np.array([[1, 4, 4]], np.int32)  # +0 -> v0 (-0); -0 + -0 -> v1 (+0), v3 (5)
    ldst = np.array([[0, 1, 3]], np.int32)
    w = np.array([[0.0, z, z]], np.float32)
    args = [_t(a) for a in (lsrc, ldst, w, val)]
    want, want_it = pt_bsp.bsp_superstep(*args, num_out=5, inner_cap=10)
    got, got_it = pt_bsp.bsp_superstep(*(a.to(cuda_device) for a in args), num_out=5, inner_cap=10)
    torch.cuda.synchronize()
    assert torch.equal(want.view(torch.int32)[0, :4],
                       torch.tensor([z, 0.0, 0.0, z]).view(torch.int32))
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert torch.equal(got_it.cpu(), want_it)


@pytest.mark.cuda
@pytest.mark.parametrize("halves", [False, True], ids=["one_run", "two_halves"])
def test_cuda_bsp_superstep_min_signed_zero_tie_below_seed(cuda_device, halves):
    """-0 and +0 candidates that tie below a positive seed, in both edge
    orders (in one dst-sorted run, or one in each direction half): the
    kernel keeps -0 in both, the plain version the first in edge order;
    the two agree as floats and in iteration counts (the documented
    exception to bitwise equality)."""
    z = np.float32(-0.0)
    val = np.array([[5.0, 0.0, z, 5.0]], np.float32)
    # v1 + 0 = +0 and v2 + -0 = -0, into v0 (+0 first) and v3 (-0 first).
    edges = [(1, 0, 0.0), (2, 0, z), (2, 3, z), (1, 3, 0.0)]
    if halves:  # the first edge of each pair in one half, the second in the other
        edges = edges[0::2] + edges[1::2]
    lsrc, ldst, w = (np.array([[e[i] for e in edges]], dt)
                     for i, dt in ((0, np.int32), (1, np.int32), (2, np.float32)))
    args = [_t(a) for a in (lsrc, ldst, w, val)]
    want, want_it = pt_bsp.bsp_superstep(*args, num_out=4, inner_cap=10)
    got, got_it = pt_bsp.bsp_superstep(*(a.to(cuda_device) for a in args), num_out=4, inner_cap=10)
    torch.cuda.synchronize()
    got = got.cpu()
    assert torch.equal(got_it.cpu(), want_it) and int(want_it[0]) == 1
    assert bool((got == want).all())
    assert torch.equal(got.view(torch.int32),
                       torch.tensor([[z, 0.0, z, z]]).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("combine", ["min", "max", "sum"])
@pytest.mark.parametrize("name,bad", [("lsrc", -1), ("lsrc", "n"), ("ldst", -1), ("ldst", "n")])
def test_cuda_bsp_superstep_rejects_out_of_range_ids(cuda_device, combine, name, bad):
    """Both kernels guard their ids: an id outside [0, num_out) raises the
    ValueError of check_ids (through the wrapper and through `ops`), and a
    good call right after gives the plain version's result."""
    lsrc, ldst, w, val = _min_stream(4, 4, 500, 4096)
    if combine == "sum":  # one dst-sorted run a destination, pads of weight 0
        w = (w < 3e38).astype(np.float32)
        ldst = np.sort(ldst, axis=1)
    deg = np.ones_like(val)
    good = [_t(a).to(cuda_device) for a in (lsrc, ldst, w, val)]
    kw = dict(num_out=500, combine=combine, inner_cap=10_000)
    if combine == "sum":
        kw["out_degree"] = _t(deg).to(cuda_device)
    for entry in (pt_ops.bsp_superstep, pt_bsp.bsp_superstep):
        if entry is pt_bsp.bsp_superstep and combine == "max":
            continue
        args = [a.clone() for a in good]
        args[0 if name == "lsrc" else 1][2, 1000] = 500 if bad == "n" else bad
        with pytest.raises(ValueError, match=f"{name} has ids"):
            entry(*args, **kw)
        got, got_it = entry(*good, **kw)
        want, want_it = entry(*(a.cpu() for a in good),
                              **{k: (x.cpu() if torch.is_tensor(x) else x) for k, x in kw.items()})
        torch.cuda.synchronize()
        assert torch.equal(got_it.cpu(), want_it)
        if combine == "sum":
            torch.testing.assert_close(got.cpu(), want, rtol=SUM_RTOL, atol=SUM_ATOL)
        else:
            assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("p,block", [(2048, 8192), (256, 4096), (33, 8192)])
@pytest.mark.parametrize("window", [False, True], ids=["frozen", "window"])
@pytest.mark.parametrize("balance", ["static", "range"])
def test_cuda_ebg_commit_large_shapes(cuda_device, p, block, window, balance):
    """Large shapes, bitwise against the plain version, one block through
    `ebg_commit_block` and two through `ebg_commit_stream`: (2,048, 8,192)
    runs the WIDE kernel (p > 1,024: its staging in the global workspace);
    (256, 4,096) and (33, 8,192) the tiled kernel on 8 and 2 chain warps:
    frozen blocks in deferred tiles of 1,024 edges, window tiles of 64."""
    state, edges, coef, _, _ = _commit_stream_inputs(p + block, p, 20_011, 2 * block, False,
                                                     hub=True)
    kw = dict(balance=balance, window=window)
    sl = slice(0, block)
    args = [*state, *(t[sl] for t in edges), coef]
    want = pt_ebg.ebg_commit_block_plain(*args, **kw)
    got = pt_ebg.ebg_commit_block(*(t.to(cuda_device) for t in args), **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    want_state = [t.clone() for t in state]
    want = pt_ebg.ebg_commit_stream(*want_state, *edges, coef, block=block, **kw)
    dev = [t.to(cuda_device) for t in state]
    got = pt_ebg.ebg_commit_stream(*dev, *(t.to(cuda_device) for t in edges),
                                   coef.to(cuda_device), block=block, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    for g, w in zip(dev, want_state):
        assert torch.equal(g.cpu(), w)


def _commit_card(cuda_device, state, edges, coef, wu, wv, block, **kw):
    """`ebg_commit_stream` on the card from copies of `state`: [parts,
    keep_bits, e_count, v_count] back on the CPU."""
    dev = [t.to(cuda_device) for t in state]
    got = pt_ebg.ebg_commit_stream(*dev, *(t.to(cuda_device) for t in edges),
                                   coef.to(cuda_device), block=block,
                                   wu=None if wu is None else wu.to(cuda_device),
                                   wv=None if wv is None else wv.to(cuda_device), **kw)
    torch.cuda.synchronize()
    return [got.cpu(), *(t.cpu() for t in dev)]


def _commit_plain(state, edges, coef, wu, wv, block, **kw):
    """The same through the plain version on the CPU."""
    want_state = [t.clone() for t in state]
    want = pt_ebg.ebg_commit_stream(*want_state, *edges, coef, block=block, wu=wu, wv=wv, **kw)
    return [want, *want_state]


def _assert_commit_equal(got, want, what):
    for name, g, w in zip(("parts", "keep_bits", "e_count", "v_count"), got, want):
        assert torch.equal(g, w), f"{name} differs: {what}"


@pytest.mark.cuda
@pytest.mark.parametrize("p", [32, 33, 64, 256, 1024])
@pytest.mark.parametrize("block", [2048, 2049, 4096])
@pytest.mark.parametrize("window", [False, True], ids=["frozen", "window"])
@pytest.mark.parametrize("balance", ["static", "range"])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_cuda_ebg_commit_tiled_blocks(cuda_device, p, block, window, balance, weighted):
    """Blocks longer than a patched tile (2,048 edges at p <= 32, fewer at
    more parts or with weights): frozen blocks walked in deferred tiles
    (the next block's first tile gathered after the block commits), window
    tiles that cut the blocks, and 33-1,024 parts on several chain warps
    (two parts a lane past 512). Two blocks through `ebg_commit_stream` on
    a uniform and a hub-heavy stream, bitwise against the plain version:
    parts, bitset and counters."""
    kw = dict(balance=balance, window=window)
    for hub in (False, True):
        state, edges, coef, wu, wv = _commit_stream_inputs(p + block + hub, p, 5003, 2 * block,
                                                           weighted, hub)
        _assert_commit_equal(_commit_card(cuda_device, state, edges, coef, wu, wv, block, **kw),
                             _commit_plain(state, edges, coef, wu, wv, block, **kw),
                             f"hub={hub}")


@pytest.mark.cuda
@pytest.mark.parametrize("p", [32, 256])
@pytest.mark.parametrize("balance,weighted", [("static", False), ("range", True)])
def test_cuda_ebg_commit_window_any_block(cuda_device, p, balance, weighted):
    """Window mode makes any block size the per-edge scan: one hub-heavy
    stream at window blocks 1, 32, 256 and 4,096 leaves the same parts,
    bitset and counters on the card (tiles of 1 and 32 edges; tiles of 64,
    the window tile, which cut the blocks of 256 and 4,096), and those of
    the plain version at block 4,096."""
    state, edges, coef, wu, wv = _commit_stream_inputs(p + 17, p, 3001, 8192, weighted, hub=True)
    kw = dict(balance=balance, window=True)
    want = _commit_plain(state, edges, coef, wu, wv, 4096, **kw)
    for block in (1, 32, 256, 4096):
        _assert_commit_equal(_commit_card(cuda_device, state, edges, coef, wu, wv, block, **kw),
                             want, f"window block {block}")


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 17, 48, 112])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_cuda_decode_attention_any_head_dim(cuda_device, D, dtype, softcap):
    """Head dims outside the built widths run zero-padded to the next one
    (D = 17 by element loads: its rows are not whole 16-byte chunks), over
    one key, a ragged tile and a length the splits do not divide, with 1
    to 8 query rows a kv head; each beside its x1.01 control."""
    tdt, tol = DTYPES[dtype]
    gen = torch.Generator().manual_seed(D)
    Hkv = 2
    for S in (1, 31, 20_001):
        for B, G in ((1, 1), (3, 4), (2, 8)):
            q, k, v = (torch.randn(s, generator=gen).to(tdt)
                       for s in ((B, Hkv * G, D), (B, S, Hkv, D), (B, S, Hkv, D)))
            want = pt_attn.decode_attention_plain(q, k, v, softcap=softcap).float()
            got = pt_ops.decode_attention(q.to(cuda_device), k.to(cuda_device),
                                          v.to(cuda_device), softcap=softcap)
            torch.cuda.synchronize()
            assert got.shape == q.shape and got.dtype == tdt
            got = got.cpu().float()
            torch.testing.assert_close(got, want, rtol=tol[0], atol=tol[1])
            assert not torch.allclose(got * 1.01, want, rtol=tol[0], atol=tol[1])
