"""Port parity, streaming partitioners: the `ebg_commit` kernel's plain
version against the reference oracle (`repro.kernels.ref` through
`ops.ebg_commit_block(impl="ref")`), and the partition assignments of
ebv/hdrf/greedy at blocks 1, 64 and 256 (frozen and window commit), at
blocks 2,049 and 4,096 with 32, 33 and 256 parts, and of the `ebg` scan
against the reference drivers and its numpy oracle.

All exact: the port repeats the reference's f32 arithmetic as XLA runs it
on the CPU — inv_e/inv_v computed in f32, and the score
`gain + ce·e·norm + cv·v·inv_v` as two fused multiply-adds,
fma(cv·v, inv_v, fma(ce·e, norm, gain)), which is how XLA's CPU backend
compiles the reference's expression. The reference's numpy oracle rounds
every operation on its own, so it leaves both on the rare near-tie.
"""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.streaming import (
    streaming_chunked_partition as ref_chunked,
    streaming_scan_partition as ref_scan,
)
from repro.core.streaming_np import streaming_partition_np
from repro.core.types import Graph as RefGraph
from repro.kernels import ops as ref_ops
from repro_torch import interop
from repro_torch.api.registry import get_partitioner
from repro_torch.core import streaming as pt_streaming
from repro_torch.kernels import ebg_commit as pt_ebg
from repro_torch.kernels import ops as pt_ops

BLOCKS = (1, 64, 256)
SCORERS = ("ebv", "hdrf", "greedy")


def _rand_graph(seed=0, V=120, E=900) -> RefGraph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, V, E).astype(np.int32)
    dst = rng.integers(0, V, E).astype(np.int32)
    m = src != dst
    return RefGraph(src=src[m], dst=dst[m], num_vertices=V)


def _port(g: RefGraph):
    return interop.graph_from_numpy(g.src, g.dst, g.num_vertices)


@pytest.fixture(scope="module")
def graphs(small_powerlaw):
    """(reference graph, port graph) pairs: a uniform random graph and the
    power-law fixture."""
    return [(g, _port(g)) for g in (_rand_graph(), small_powerlaw)]


# ------------------------------------------------------------ kernel level


def _commit_inputs(seed, p, V, B, weighted):
    rng = np.random.default_rng(seed)
    vw = (V + 31) // 32
    keep = rng.integers(0, 2**32, (p, vw), dtype=np.uint64).astype(np.uint32)
    keep &= rng.integers(0, 2**32, (p, vw), dtype=np.uint64).astype(np.uint32)  # sparser
    e = rng.integers(0, 40, p).astype(np.float32)
    v = rng.integers(0, 60, p).astype(np.float32)
    u = rng.integers(0, V, B).astype(np.int32)
    w = rng.integers(0, V, B).astype(np.int32)
    u[B // 3] = w[B // 3] ^ 1  # u and v in one word
    u[B // 2:B // 2 + 4] = u[0]  # endpoints shared along the block (window replay)
    valid = np.ones(B, bool)
    valid[-5:] = False
    valid[B // 4] = False
    wu = wv = None
    if weighted:
        wu = (rng.random(B) + 1.0).astype(np.float32)
        wv = (rng.random(B) + 1.0).astype(np.float32)
    coef = dict(alpha=np.float32(1.0), beta=np.float32(0.7),
                inv_e=np.float32(p) / np.float32(5 * B), inv_v=np.float32(p) / np.float32(V),
                eps=np.float32(1.0))
    return keep, e, v, u, w, valid, wu, wv, coef


@pytest.mark.parametrize("window", [False, True], ids=["frozen", "window"])
@pytest.mark.parametrize("balance,weighted", [("static", False), ("range", True), ("range", False)])
@pytest.mark.parametrize("p,V,B", [(4, 200, 64), (8, 70, 33), (3, 40, 1)])
def test_commit_block_matches_reference_oracle(window, balance, weighted, p, V, B):
    keep, e, v, u, w, valid, wu, wv, coef = _commit_inputs(p * B, p, V, B, weighted)
    j = jnp.asarray
    r_keep, r_e, r_v, r_parts = ref_ops.ebg_commit_block(
        j(keep), j(e), j(v), j(u), j(w), j(valid), balance=balance,
        wu=None if wu is None else j(wu), wv=None if wv is None else j(wv), window=window,
        impl="ref", **coef,
    )
    t = torch.from_numpy
    keep_t = t(keep.view(np.int32).copy())
    e_t, v_t = t(e.copy()), t(v.copy())
    p_keep, p_e, p_v, p_parts = pt_ops.ebg_commit_block(
        keep_t, e_t, v_t, t(u), t(w), t(valid), balance=balance,
        wu=None if wu is None else t(wu), wv=None if wv is None else t(wv),
        window=window, **coef,
    )
    np.testing.assert_array_equal(p_parts.numpy(), np.asarray(r_parts))
    np.testing.assert_array_equal(p_keep.numpy().view(np.uint32), np.asarray(r_keep))
    np.testing.assert_array_equal(p_e.numpy(), np.asarray(r_e))
    np.testing.assert_array_equal(p_v.numpy(), np.asarray(r_v))
    # The block entry is functional: its inputs are left as they were.
    np.testing.assert_array_equal(keep_t.numpy().view(np.uint32), keep)
    np.testing.assert_array_equal(e_t.numpy(), e)


@pytest.mark.parametrize("window", [False, True], ids=["frozen", "window"])
@pytest.mark.parametrize("balance,weighted", [("static", False), ("range", True)])
def test_commit_block_beyond_1024_parts_matches_reference_oracle(window, balance, weighted):
    """p = 1,100: more parts than a CTA has threads (the card's workspace
    path gives each thread several), against the reference's oracle."""
    test_commit_block_matches_reference_oracle(window, balance, weighted, 1100, 3000, 48)


def test_commit_stream_equals_blocks_in_order():
    p, V, B, n = 4, 150, 16, 5
    keep, e, v, _, _, _, _, _, coef = _commit_inputs(1, p, V, B, False)
    rng = np.random.default_rng(9)
    u = rng.integers(0, V, B * n).astype(np.int32)
    w = rng.integers(0, V, B * n).astype(np.int32)
    valid = rng.random(B * n) < 0.9
    t = torch.from_numpy
    cvec = pt_ops.commit_coefficients(**coef, device="cpu")
    state = [t(keep.view(np.int32).copy()), t(e.copy()), t(v.copy())]
    parts = pt_ebg.ebg_commit_stream(*state, t(u), t(w), t(valid), cvec, block=B, window=True)
    kb, ec, vc = t(keep.view(np.int32).copy()), t(e.copy()), t(v.copy())
    for b in range(n):
        sl = slice(b * B, (b + 1) * B)
        kb, ec, vc, pb = pt_ebg.ebg_commit_block(kb, ec, vc, t(u[sl]), t(w[sl]), t(valid[sl]),
                                                 cvec, window=True)
        np.testing.assert_array_equal(parts[sl].numpy(), pb.numpy())
    for a, b in zip(state, (kb, ec, vc)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="multiple of block"):
        pt_ebg.ebg_commit_stream(*state, t(u[:-1]), t(w[:-1]), t(valid[:-1]), cvec, block=B)


def test_commit_wrapper_rejects_bad_arguments():
    keep, e, v, u, w, valid, _, _, coef = _commit_inputs(2, 4, 64, 8, False)
    t = torch.from_numpy
    args = [t(keep.view(np.int32).copy()), t(e), t(v), t(u), t(w), t(valid)]
    with pytest.raises(ValueError, match="balance"):
        pt_ops.ebg_commit_block(*args, balance="dynamic", **coef)
    with pytest.raises(ValueError, match="together"):
        pt_ops.ebg_commit_block(*args, wu=t(e), **coef)
    bad = list(args)
    bad[3] = bad[3].long()
    with pytest.raises(TypeError, match="u must be torch.int32"):
        pt_ops.ebg_commit_block(*bad, **coef)
    bad = list(args)
    bad[1] = torch.zeros(5)
    with pytest.raises(ValueError, match="e_count must have shape"):
        pt_ops.ebg_commit_block(*bad, **coef)


# --------------------------------------------------------- partition level


@pytest.mark.parametrize("scorer", SCORERS)
def test_frozen_chunked_matches_reference(graphs, scorer):
    for ref_g, pt_g in graphs:
        for block in BLOCKS:
            ref = ref_chunked(ref_g, 8, scorer, block=block, compute_backend="xla")
            port = pt_streaming.streaming_chunked_partition(pt_g, 8, scorer, block=block,
                                                            device="cpu")
            np.testing.assert_array_equal(port.part.numpy(), np.asarray(ref.part),
                                          err_msg=f"{scorer}/block={block}")
            if ref.order is None:
                assert port.order is None
            else:
                np.testing.assert_array_equal(port.order.numpy(), np.asarray(ref.order))


@pytest.mark.parametrize("scorer", SCORERS)
def test_window_and_scan_match_reference_scan(graphs, scorer):
    for ref_g, pt_g in graphs:
        oracle = np.asarray(ref_scan(ref_g, 8, scorer).part)
        scan = pt_streaming.streaming_scan_partition(pt_g, 8, scorer, device="cpu")
        np.testing.assert_array_equal(scan.part.numpy(), oracle)
        for block in BLOCKS:
            win = pt_streaming.streaming_chunked_partition(pt_g, 8, scorer, block=block,
                                                           commit="window", device="cpu")
            np.testing.assert_array_equal(win.part.numpy(), oracle,
                                          err_msg=f"{scorer}/window/block={block}")


@pytest.fixture(scope="module")
def tile_graph():
    """(reference graph, port graph): an R-MAT graph of 4,243 edges, past
    one block of 4,096 and two of 2,049."""
    from repro.graph.generate import rmat as ref_rmat

    g = ref_rmat(1024, 4300, seed=5)
    return g, _port(g)


@pytest.mark.parametrize("commit", ["frozen", "window"])
@pytest.mark.parametrize("scorer", SCORERS)
@pytest.mark.parametrize("p", [32, 33, 256])
def test_tiled_blocks_match_reference(tile_graph, p, scorer, commit):
    """The shapes the card walks in tiles of its own (blocks of 2,049 and
    4,096 edges: deferred frozen tiles, window tiles that cut the blocks)
    and on several chain warps (33 and 256 parts): the port's plain path
    against the reference's blocked driver (frozen) and its scan
    (window: any block size is the scan)."""
    ref_g, pt_g = tile_graph
    want = None if commit == "frozen" else np.asarray(ref_scan(ref_g, p, scorer).part)
    for block in (2049, 4096):
        if commit == "frozen":
            want = np.asarray(ref_chunked(ref_g, p, scorer, block=block,
                                          compute_backend="xla").part)
        port = pt_streaming.streaming_chunked_partition(pt_g, p, scorer, block=block,
                                                        commit=commit, device="cpu")
        np.testing.assert_array_equal(port.part.numpy(), want,
                                      err_msg=f"{scorer}/{commit}/p={p}/block={block}")


def test_numpy_oracle_leaves_the_reference_on_a_near_tie(graphs):
    """On the uniform random graph HDRF meets a near-tie that the fused and
    the unfused arithmetic resolve differently: the reference's JAX scan
    (fused by XLA) and the port agree, its numpy oracle does not."""
    ref_g, pt_g = graphs[0]
    ref = np.asarray(ref_scan(ref_g, 8, "hdrf").part)
    unfused = streaming_partition_np(ref_g, 8, "hdrf").part
    assert (ref != unfused).any()
    port = pt_streaming.streaming_chunked_partition(pt_g, 8, "hdrf", block=1, device="cpu")
    np.testing.assert_array_equal(port.part.numpy(), ref)


def _fma_exact(a: float, b: float, c: float) -> np.float32:
    """a*b + c rounded once to f32 (round to nearest, ties to even)."""
    x = Fraction(a) * Fraction(b) + Fraction(c)
    f = np.float32(float(x))
    cands = (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda y: (abs(Fraction(float(y)) - x),
                                     int(np.array(y).view(np.int32)) & 1))


def test_fma_f32_rounds_once():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(400).astype(np.float32)
    b = rng.standard_normal(400).astype(np.float32)
    c = (rng.standard_normal(400) * 10.0 ** rng.integers(-12, 3, 400)).astype(np.float32)
    # Cases where rounding the product first, or rounding twice, goes wrong.
    one_ulp = np.float32(2.0 ** -23)
    a[:3] = [1 + one_ulp, 1 + 2 * one_ulp, 3.0]
    b[:3] = [1 - one_ulp, 1 + 2 * one_ulp, np.float32(1.0 / 3.0)]
    c[:3] = [-1.0, -1.0, -1.0]
    got = pt_ebg.fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    want = np.array([_fma_exact(float(x), float(y), float(z)) for x, y, z in zip(a, b, c)])
    np.testing.assert_array_equal(got, want)
    assert got[0] != np.float32(a[0] * b[0]) + c[0]  # fused differs from unfused here


def test_ebg_scan_matches_reference_scan(graphs):
    ref_g, pt_g = graphs[1]
    ref = ref_scan(ref_g, 4, "ebv", ce=0.5, cv=2.0)
    port = pt_streaming.streaming_scan_partition(pt_g, 4, "ebv", ce=0.5, cv=2.0, device="cpu")
    np.testing.assert_array_equal(port.part.numpy(), np.asarray(ref.part))
    np.testing.assert_array_equal(port.order.numpy(), np.asarray(ref.order))


def test_frozen_commit_differs_from_scan(graphs):
    """Discriminator: the window≡scan pins would be vacuous if frozen block
    commits already matched the scan on these graphs."""
    ref_g, pt_g = graphs[0]
    frozen = pt_streaming.streaming_chunked_partition(pt_g, 8, "ebv", block=256, device="cpu")
    assert (frozen.part.numpy() != np.asarray(ref_scan(ref_g, 8, "ebv").part)).any()


@pytest.mark.parametrize("name,kw", [
    ("ebg", dict(alpha=0.5, beta=2.0)),
    ("ebg_chunked", dict(block=64)),
    ("ebg_chunked", dict(block=32, commit="window")),
    ("hdrf", dict(lam=1.5, block=16)),
    ("greedy", dict(eps=2.0, block=128, sort_edges=True)),
])
def test_registered_partitioners_match_reference(small_powerlaw, name, kw):
    from repro.api.registry import get_partitioner as ref_get

    ref = ref_get(name).partition(small_powerlaw, 4, **kw)
    port = get_partitioner(name).partition(_port(small_powerlaw), 4, device="cpu", **kw)
    np.testing.assert_array_equal(port.part.numpy(), np.asarray(ref.part))
    np.testing.assert_array_equal(port.part_in_input_order(), ref.part_in_input_order())


def test_edge_weights_and_validation_match(small_powerlaw):
    from repro.core.streaming import HDRF, edge_weights_np as ref_w

    g = _port(small_powerlaw)
    src, dst = np.asarray(small_powerlaw.src), np.asarray(small_powerlaw.dst)
    for a, b in zip(pt_streaming.edge_weights_np(pt_streaming.HDRF, g, src, dst),
                    ref_w(HDRF, small_powerlaw, src, dst)):
        np.testing.assert_array_equal(a, b)
    assert pt_streaming.edge_weights_np(pt_streaming.EBV, g, src, dst) is None
    check = pt_streaming.validate_edge_stream
    with pytest.raises(ValueError, match=r"src\[1\] = 9 out of range"):
        check(np.array([0, 9]), np.array([1, 2]), num_vertices=5)
    with pytest.raises(ValueError, match="self-loop at edge row 1"):
        check(np.array([0, 2]), np.array([1, 2]), num_vertices=5)
    with pytest.raises(ValueError, match=r"weights\[0\]"):
        check(np.array([0]), np.array([1]), num_vertices=5, weights=np.array([-1.0]))
    with pytest.raises(ValueError, match="same shape"):
        check(np.array([0, 1]), np.array([1]), num_vertices=5)
    with pytest.raises(ValueError, match="commit"):
        pt_streaming.streaming_chunked_partition(g, 4, "ebv", commit="optimistic", device="cpu")
    with pytest.raises(KeyError, match="unknown scorer"):
        pt_streaming.get_scorer("fennel")
