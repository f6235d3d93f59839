"""Port parity, BSP engine: the `bsp_superstep` kernel's plain version
against the reference oracle, and whole runs of CC/SSSP/BFS/REACH/PR on a
`SubgraphSet` built by the reference and carried across (which isolates
engine parity from build parity), in both addressing modes.

Exact: CC/BFS/REACH labels, SSSP distances, min/max kernel values and
iteration counts, and every `BSPStats` field. Tolerance: PageRank values
and sum-kernel values, rtol=1e-5 / atol=1e-8, because f32 sums are taken
in another order (the reference's XLA segment sum against PyTorch's
scatter-add).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import algorithms as ref_alg
from repro.graph.build import build_subgraphs as ref_build
from repro.kernels import ops as ref_ops
from repro_torch import interop
from repro_torch.graph import algorithms as pt_alg
from repro_torch.graph import engine as eng
from repro_torch.kernels import bsp_superstep as pt_bsp
from repro_torch.kernels import ops as pt_ops

PROGRAMS = ("cc", "sssp", "bfs", "reach", "pr")
RTOL, ATOL = 1e-5, 1e-8


def assert_stats_equal(port, ref):
    assert port.supersteps == ref.supersteps
    for f in ("messages_per_worker", "messages_per_step", "messages_per_step_worker",
              "inner_iters_per_step", "comp_work_per_worker"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f), err_msg=f)
    assert port.total_messages == ref.total_messages
    assert port.max_mean == ref.max_mean


def assert_values(prog, port, ref):
    if prog in ("pr", "pagerank"):
        np.testing.assert_allclose(port, np.asarray(ref), rtol=RTOL, atol=ATOL)
    else:
        assert port.dtype == np.asarray(ref).dtype
        np.testing.assert_array_equal(port, np.asarray(ref))


# ------------------------------------------------------------ kernel level


def _streams(seed=0, p=4, V=33, E=77, negative=False):
    rng = np.random.default_rng(seed)
    lsrc = rng.integers(0, V, (p, E)).astype(np.int32)
    ldst = np.sort(rng.integers(0, V - 1, (p, E)), axis=1).astype(np.int32)
    w = (rng.random((p, E)) + 0.1).astype(np.float32)
    w[:, -3:] = np.float32(3.0e38)  # pads: the INF identity
    val = (rng.random((p, V)) * 10).astype(np.float32)
    if negative:
        val -= 7.0
    deg = rng.integers(0, 5, (p, V)).astype(np.float32)
    return lsrc, ldst, w, val, deg


@pytest.mark.parametrize("inner_cap", [1, 3, 1000])
@pytest.mark.parametrize("combine,negative", [("min", False), ("min", True), ("max", True),
                                              ("sum", False)])
def test_superstep_matches_reference_oracle(combine, negative, inner_cap):
    lsrc, ldst, w, val, deg = _streams(inner_cap, negative=negative)
    if combine == "sum":
        w[:, -3:] = 0.0  # sum pads carry 0
    if combine == "max":
        w[:, :-3] = 0.0  # max streams: real edges 0, pads INF
    kw = dict(num_out=33, combine=combine, inner_cap=inner_cap)
    j = jnp.asarray
    r_val, r_it = ref_ops.bsp_superstep(j(lsrc), j(ldst), j(w), j(val), impl="ref",
                                        out_degree=j(deg) if combine == "sum" else None, **kw)
    t = torch.from_numpy
    for block_e in (1, 16, 512):
        p_val, p_it = pt_ops.bsp_superstep(t(lsrc), t(ldst), t(w), t(val), block_e=block_e,
                                           out_degree=t(deg) if combine == "sum" else None, **kw)
        np.testing.assert_array_equal(p_it.numpy(), np.asarray(r_it))
        if combine == "sum":
            np.testing.assert_allclose(p_val.numpy(), np.asarray(r_val), rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(p_val.numpy(), np.asarray(r_val))


def _sum_streams(kind, seed=3, p=4, V=300, E=4000):
    """[p, E] dst-sorted sum streams with pads (weight 0) at the dump slot.
    hub: one destination owns 90 % of every worker's edges; both_signs:
    values of both signs, so that sums cancel."""
    rng = np.random.default_rng(seed)
    lsrc = rng.integers(0, V, (p, E)).astype(np.int32)
    dst = rng.integers(0, V - 1, (p, E))
    if kind == "hub":
        dst = np.where(rng.random((p, E)) < 0.9, 17, dst)
    ldst = np.sort(dst, axis=1).astype(np.int32)
    w = (rng.random((p, E)) + 0.1).astype(np.float32)
    w[:, -5:], ldst[:, -5:] = 0.0, V - 1
    val = (rng.random((p, V)) * 10).astype(np.float32)
    if kind == "both_signs":
        val -= 5.0
    deg = rng.integers(0, 6, (p, V)).astype(np.float32)
    return lsrc, ldst, w, val, deg


@pytest.mark.parametrize("kind", ["hub", "both_signs"])
def test_superstep_sum_matches_reference_oracle(kind):
    """The plain sum adds in float64 and rounds once; the reference adds in
    f32 in edge order. The port equals the exact sum of the f32 products
    rounded to f32 (to 1e-7), nearer to it than the reference everywhere,
    and the reference to rtol 1e-5 / atol 1e-8: on the hub as it is; on
    sums that cancel plus the reference's own rounding, since an f32 sum of
    k terms in order is off the exact sum by up to k * 2^-24 * (sum of
    |terms|), which exceeds 1e-5 of a sum that has cancelled."""
    lsrc, ldst, w, val, deg = _sum_streams(kind)
    if kind == "hub":
        assert (ldst == 17).mean(axis=1).min() > 0.85
    else:
        assert (val < 0).any() and (val > 0).any()
    j, t = jnp.asarray, torch.from_numpy
    p, n = val.shape
    kw = dict(num_out=n, combine="sum")
    r_val, r_it = ref_ops.bsp_superstep(j(lsrc), j(ldst), j(w), j(val), impl="ref",
                                        out_degree=j(deg), **kw)
    p_val, p_it = pt_ops.bsp_superstep(t(lsrc), t(ldst), t(w), t(val), out_degree=t(deg), **kw)
    np.testing.assert_array_equal(p_it.numpy(), np.asarray(r_it))
    # The exact sums, in float64, of the f32 products the reference takes.
    share = np.where(deg > 0, val / np.where(deg > 0, deg, 1), 0).astype(np.float32)
    terms = np.take_along_axis(share, lsrc, 1) * w
    rows = np.repeat(np.arange(p), lsrc.shape[1])
    exact, mag, count = (np.zeros((p, n)) for _ in range(3))
    np.add.at(exact, (rows, ldst.ravel()), terms.ravel().astype(np.float64))
    np.add.at(mag, (rows, ldst.ravel()), np.abs(terms.ravel()).astype(np.float64))
    np.add.at(count, (rows, ldst.ravel()), 1.0)
    got, ref = p_val.numpy(), np.asarray(r_val)
    np.testing.assert_allclose(got, exact.astype(np.float32), rtol=1e-7, atol=0.0)
    assert (np.abs(got - exact) <= np.abs(ref - exact)).all()
    if kind == "hub":
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    else:
        ref_rounding = count * 2.0**-24 * mag
        assert (np.abs(got - ref) <= ATOL + RTOL * np.abs(ref) + ref_rounding).all()


def test_superstep_wrapper_rejects_bad_arguments():
    lsrc, ldst, w, val, deg = (torch.from_numpy(a) for a in _streams())
    with pytest.raises(ValueError, match="combine"):
        pt_ops.bsp_superstep(lsrc, ldst, w, val, num_out=33, combine="prod")
    with pytest.raises(ValueError, match="out_degree"):
        pt_ops.bsp_superstep(lsrc, ldst, w, val, num_out=33, combine="sum")
    with pytest.raises(ValueError, match="out_degree"):
        pt_ops.bsp_superstep(lsrc, ldst, w, val, num_out=33, out_degree=deg)
    with pytest.raises(TypeError, match="lsrc must be torch.int32"):
        pt_bsp.bsp_superstep(lsrc.long(), ldst, w, val, num_out=33)
    with pytest.raises(ValueError, match="val must have shape"):
        pt_bsp.bsp_superstep(lsrc, ldst, w, val, num_out=34)
    with pytest.raises(ValueError, match="contiguous"):
        pt_bsp.bsp_superstep(lsrc, ldst, w, val.t().contiguous().t(), num_out=33)


def test_pad_stream_keeps_the_dump_slot_and_identity():
    lsrc, ldst, w, _, _ = (torch.from_numpy(a) for a in _streams(E=10))
    s, d, ww = pt_ops.pad_stream(lsrc, ldst, w, num_out=33, block_e=4, identity=0.0)
    assert s.shape == (4, 12)
    assert (d[:, 10:] == 32).all() and (ww[:, 10:] == 0.0).all() and (s[:, 10:] == 0).all()
    same = pt_ops.pad_stream(lsrc, ldst, w, num_out=33, block_e=5, identity=0.0)
    assert same[0] is lsrc


# ------------------------------------------------------------ engine level


@pytest.fixture(scope="module")
def carried(small_powerlaw):
    """{(addressing, symmetrize): (reference SubgraphSet, port SubgraphSet)}
    on the EBG 4-part partition of `small_powerlaw`."""
    from repro.core import PARTITIONERS

    res = PARTITIONERS["ebg"](small_powerlaw, 4)
    out = {}
    for addressing in ("two_level", "flat"):
        for sym in (False, True):
            ref = ref_build(small_powerlaw, res, symmetrize=sym, addressing=addressing)
            out[addressing, sym] = (ref, interop.to_port(ref, device="cpu"))
    return out


def _source(g):
    cov = g.covered_vertices()
    return int(cov[np.argmax(g.degrees()[cov])])


@pytest.mark.parametrize("addressing", ["two_level", "flat"])
@pytest.mark.parametrize("prog", PROGRAMS)
def test_programs_match_reference(small_powerlaw, carried, prog, addressing):
    sym = prog in ("cc", "reach")
    ref_sub, port_sub = carried[addressing, sym]
    kw = dict(num_vertices=small_powerlaw.num_vertices)
    if prog in ("sssp", "bfs"):
        kw["source"] = _source(small_powerlaw)
    r_val, r_st = ref_alg.run_program(ref_sub, prog, compute_backend="xla", **kw)
    p_val, p_st = pt_alg.run_program(port_sub, prog, **kw)
    assert_values(prog, p_val, r_val)
    assert_stats_equal(p_st, r_st)


@pytest.mark.parametrize("prog,kw", [
    ("cc", dict(exchange_period=2)),
    ("sssp", dict(exchange_period=3, inner_cap=2)),
    ("reach", dict(inner_cap=1)),
    ("bfs", dict(max_supersteps=2)),
    ("pr", dict(max_supersteps=50, tol=1e-3)),
])
def test_engine_options_match_reference(small_powerlaw, carried, prog, kw):
    ref_sub, port_sub = carried["two_level", prog in ("cc", "reach")]
    kw = dict(kw, num_vertices=small_powerlaw.num_vertices)
    if prog in ("sssp", "bfs"):
        kw["source"] = _source(small_powerlaw)
    r_val, r_st = ref_alg.run_program(ref_sub, prog, compute_backend="xla", **kw)
    p_val, p_st = pt_alg.run_program(port_sub, prog, **kw)
    assert_values(prog, p_val, r_val)
    assert_stats_equal(p_st, r_st)


def test_named_wrappers_and_oracles(small_powerlaw, carried):
    g = small_powerlaw
    _, sym = carried["two_level", True]
    _, dirn = carried["two_level", False]
    src = _source(g)
    cov = g.covered_vertices()

    def glob(sub, vals, reduce="min"):
        return pt_alg.scatter_to_global(sub, vals, g.num_vertices, reduce=reduce)[cov]

    cc, _ = pt_alg.connected_components(sym)
    np.testing.assert_array_equal(glob(sym, cc), ref_alg.cc_reference(g)[cov])
    reach, _ = pt_alg.reachability(sym)
    np.testing.assert_array_equal(glob(sym, reach, "max"), ref_alg.reachability_reference(g)[cov])
    bfs, _ = pt_alg.bfs(dirn, src)
    np.testing.assert_array_equal(glob(dirn, bfs), ref_alg.bfs_reference(g, src)[cov])
    sssp, _ = pt_alg.sssp(dirn, src)
    np.testing.assert_array_equal(glob(dirn, sssp),
                                  np.minimum(ref_alg.sssp_reference(g, src), 3.0e38)
                                  .astype(np.float32)[cov])
    pr, st = pt_alg.pagerank(dirn, g.num_vertices, damping=0.9, num_iters=15)
    r_pr, r_st = ref_alg.pagerank(carried["two_level", False][0], g.num_vertices, damping=0.9,
                                  num_iters=15)
    np.testing.assert_allclose(pr, np.asarray(r_pr), rtol=RTOL, atol=ATOL)
    assert_stats_equal(st, r_st)


def test_value_codec_round_trip():
    vals = torch.tensor([[5, -3, eng.INF_I32, 1 << 26], [-eng.INF_I32, 5, 7, 1 << 26]],
                        dtype=torch.int32)
    from repro.graph.engine import _ValueCodec as RefCodec

    codec = eng._ValueCodec.from_values(vals)
    ref = RefCodec.from_values(vals.numpy())
    assert codec.size == ref.size == 4
    enc = codec.encode(vals)
    np.testing.assert_array_equal(enc.numpy(), np.asarray(ref.encode(jnp.asarray(vals.numpy()))))
    assert enc.tolist() == [[1, 0, eng.INF_I32, 3], [-eng.INF_I32, 1, 2, 3]]
    assert codec.decode(enc).tolist() == vals.tolist()


def test_guards_raise(carried, small_powerlaw):
    _, sub = carried["flat", True]
    huge = dataclasses.replace(sub, gid=sub.gid + (1 << 24))
    with pytest.raises(ValueError, match="2\\^24"):
        eng.run_bsp(huge, "cc")
    two = dataclasses.replace(carried["two_level", True][1], gid=sub.gid + (1 << 24))
    eng.run_bsp(two, "cc")  # two-level: ranks, not global ids, reach the kernel
    with pytest.raises(ValueError, match="num_vertices"):
        eng.run_bsp(sub, "pr")
    with pytest.raises(ValueError, match="bounded staleness"):
        eng.run_bsp(sub, "pr", num_vertices=10, exchange_period=2)
    with pytest.raises(ValueError, match="out of range"):
        eng.run_bsp(sub, "sssp", source=small_powerlaw.num_vertices,
                    num_vertices=small_powerlaw.num_vertices)
    with pytest.raises(ValueError, match="source-rooted"):
        eng.run_bsp(sub, "bfs")
    with pytest.raises(ValueError, match="unknown program"):
        eng.get_program("triangles")
    with pytest.raises(ValueError, match="already registered"):
        eng.register_program(eng.VertexProgram(name="CC", dtype="int32"))
    with pytest.raises(ValueError, match="init_fn"):
        eng.run_bsp(sub, eng.VertexProgram(name="custom", dtype="int32"))
    with pytest.raises(ValueError, match="fixpoint semantics"):
        eng.VertexProgram(name="bad", dtype="float32", combine="sum")
    assert eng.get_program("Components") is eng.CC
    assert eng.program_names() == ("bfs", "cc", "pr", "reach", "sssp")


def test_custom_program_with_init_val(carried):
    ref_sub, sub = carried["two_level", False]
    prog = eng.VertexProgram(name="hops", dtype="float32", weight="unit")
    init = eng.init_sssp(sub, 3)
    val, st = eng.run_bsp(sub, prog, init)
    from repro.graph import engine as ref_eng

    r_prog = ref_eng.VertexProgram(name="hops", dtype="float32", weight="unit")
    r_val, r_st = ref_eng.run_bsp(ref_sub, r_prog, ref_eng.init_sssp(ref_sub, 3))
    np.testing.assert_array_equal(val.numpy(), np.asarray(r_val))
    assert_stats_equal(st, r_st)
