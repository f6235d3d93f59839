"""The superstep kernel's id guard and the pass loop of its min kernel.

`bsp_superstep` (and `ops.bsp_superstep`, and the engine's `run_bsp`) must
refuse an `lsrc`/`ldst` outside [0, num_out) with the ValueError of
`dispatch.check_ids`, for min, max and sum, and go on working after it.

The CUDA min kernel (`csrc/bsp_superstep.cu`) runs the workers' Jacobi
passes in lock step, drops a worker once a pass changed nothing, counts a
change as the plain version does (floats: `new != v`), and skips every edge
whose source kept its value bits in the pass before (the frontier). The
kernel runs only on the card; `_emulate_min` below is that loop in numpy,
step for step, and is held bitwise (values and iteration counts) against
`bsp_superstep_plain` on seeded streams. That pins the frontier's
exactness argument here, where no card is: an edge whose source did not
change offers the term it offered in the pass before, which the seed
already bounds.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.graph import engine as eng
from repro_torch.kernels import bsp_superstep as pt_bsp
from repro_torch.kernels import ops as pt_ops

INF = np.float32(3.0e38)
KEY_IDENTITY = np.int32(0x7FFFFFFF)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _fkey(x: np.ndarray) -> np.ndarray:
    """The kernel's order-preserving int key of an f32 (-0 below +0)."""
    b = x.astype(np.float32).view(np.int32)
    return np.where(b >= 0, b, b ^ np.int32(0x7FFFFFFF)).astype(np.int32)


def _funkey(k: np.ndarray) -> np.ndarray:
    return np.where(k >= 0, k, k ^ np.int32(0x7FFFFFFF)).astype(np.int32).view(np.float32)


def _emulate_min(lsrc, ldst, w, val, inner_cap, frontier="adaptive"):
    """The CUDA min kernel's pass loop: per pass, the edge phase over the
    active workers' edges (worker-major; an edge takes part in pass 0, and
    later only if its source's value bits changed in the pass before, when
    the pass reads the frontier), each destination's min candidate key
    committed when it lies below the seed as a float; then the vertex
    phase (decode, change count by floats, frontier by bits, next pass's
    values). A worker whose last change was in the pass before stays
    active. `frontier`: "adaptive" reads it as the kernel does, when at
    most half of the active workers' vertices changed in the pass before
    (either choice is exact), "always" in every pass after the first.
    Returns (values, iters, the edges that took part in each pass)."""
    p, E = lsrc.shape
    n = val.shape[1]
    prev = val.astype(np.float32).copy()
    key = _fkey(prev)
    chg = np.zeros(p, np.int32)
    front = np.ones((p, n), bool)
    taken = []
    flipped = 0  # vertices whose bits the pass before changed
    for k in range(inner_cap):
        active = [r for r in range(p) if chg[r] == k]
        if not active:
            break
        taken.append(0)
        use_front = k > 0 and (frontier == "always" or 2 * flipped <= len(active) * n)
        flipped = 0
        for r in active:  # edge phase
            s, d, wt = lsrc[r], ldst[r], w[r]
            on = front[r][s] if use_front else np.ones(E, bool)
            taken[-1] += int(on.sum())
            with np.errstate(over="ignore"):  # pads' sums are computed, then dropped
                x = np.where(wt < INF, prev[r][s] + wt, INF).astype(np.float32)
            cand = np.full(n, KEY_IDENTITY, np.int32)
            np.minimum.at(cand, d[on], _fkey(x[on]))
            commit = (cand != KEY_IDENTITY) & (_funkey(cand) < prev[r])
            key[r] = np.where(commit, np.minimum(key[r], cand), key[r])
        for r in active:  # vertex phase
            a = _funkey(key[r])
            if (a != prev[r]).any():
                chg[r] = k + 1
            front[r] = a.view(np.int32) != prev[r].view(np.int32)
            flipped += int(front[r].sum())
            prev[r] = np.where(front[r], a, prev[r])
    return prev, chg, taken


def _stream(seed, p, n, E):
    """Two dst-sorted halves (a hub in the second), weights 0 and small
    positive ones, INF pads, values of both signs with -0, +0 and INF; one
    worker all pads when p > 1."""
    rng = np.random.default_rng(seed)
    h = E // 2
    d1 = np.sort(rng.integers(0, n, (p, h)), axis=1)
    d2 = np.sort(np.where(rng.random((p, E - h)) < 0.5, 3 % n, rng.integers(0, n, (p, E - h))),
                 axis=1)
    ldst = np.concatenate([d1, d2], axis=1).astype(np.int32)
    lsrc = rng.integers(0, n, (p, E)).astype(np.int32)
    w = np.where(rng.random((p, E)) < 0.3, 0.0, rng.integers(1, 4, (p, E))).astype(np.float32)
    w[rng.random((p, E)) < 0.05] = INF
    if p > 1:
        w[p // 2] = INF
    val = (rng.integers(-20, 30, (p, n)) * 0.5).astype(np.float32)
    pick = rng.random((p, n))
    val[pick < 0.15] = np.float32(-0.0)
    val[(pick >= 0.15) & (pick < 0.25)] = np.float32(0.0)
    val[(pick >= 0.25) & (pick < 0.35)] = INF
    return lsrc, ldst, w, val


@pytest.mark.parametrize("frontier", ["adaptive", "always"])
@pytest.mark.parametrize("inner_cap", [1, 2, 10_000])
@pytest.mark.parametrize("p", [1, 3, 8])
def test_min_pass_loop_emulation_matches_plain(p, inner_cap, frontier):
    """Lock-step passes, the frontier by bits (read as the kernel reads it,
    and in every pass) and the change count by floats give the plain
    version's values and iteration counts bit for bit, on 40 seeded streams
    each (max through negation included)."""
    for seed in range(40):
        n = 10 + seed % 40
        lsrc, ldst, w, val = _stream(seed * 7 + p, p, n, 4 * n + seed)
        for v in (val, -val):
            want, want_it = pt_bsp.bsp_superstep_plain(_t(lsrc), _t(ldst), _t(w), _t(v), n,
                                                       inner_cap=inner_cap)
            got, got_it, _ = _emulate_min(lsrc, ldst, w, v, inner_cap, frontier)
            np.testing.assert_array_equal(got_it, want_it.numpy())
            np.testing.assert_array_equal(got.view(np.int32), want.numpy().view(np.int32))


def test_min_pass_loop_emulation_keeps_the_seed_on_a_tie():
    """+0 offered to a -0 seed stays -0, -0 offered to a +0 seed stays +0,
    and a lone -0 below the seed is taken as -0, as in the plain version."""
    z = np.float32(-0.0)
    val = np.array([[z, 0.0, 0.0, 5.0, z]], np.float32)
    lsrc = np.array([[1, 4, 4]], np.int32)
    ldst = np.array([[0, 1, 3]], np.int32)
    w = np.array([[0.0, z, z]], np.float32)
    want, want_it = pt_bsp.bsp_superstep_plain(_t(lsrc), _t(ldst), _t(w), _t(val), 5,
                                               inner_cap=10)
    np.testing.assert_array_equal(want.numpy().view(np.int32)[0, :4],
                                  np.array([z, 0.0, 0.0, z], np.float32).view(np.int32))
    got, got_it, _ = _emulate_min(lsrc, ldst, w, val, 10)
    np.testing.assert_array_equal(got.view(np.int32), want.numpy().view(np.int32))
    np.testing.assert_array_equal(got_it, want_it.numpy())


def test_min_pass_loop_emulation_skips_edges():
    """The frontier does skip: on a chain, every pass after the first takes
    part with the one edge out of the vertex that changed."""
    n = 12
    lsrc = np.arange(n - 1, dtype=np.int32)[None]
    ldst = np.arange(1, n, dtype=np.int32)[None]
    w = np.ones((1, n - 1), np.float32)
    val = np.full((1, n), INF)
    val[0, 0] = 0.0
    got, it, taken = _emulate_min(lsrc, ldst, w, val, 100)
    np.testing.assert_array_equal(got[0], np.arange(n, dtype=np.float32))
    assert it[0] == n - 1
    assert taken == [n - 1] + [1] * (n - 2) + [0]  # the last pass finds nothing to do


# ------------------------------------------------------------ the id guard


def _guard_inputs(combine):
    rng = np.random.default_rng(9)
    p, n, E = 3, 40, 200
    lsrc = rng.integers(0, n, (p, E)).astype(np.int32)
    ldst = np.sort(rng.integers(0, n, (p, E)), axis=1).astype(np.int32)
    w = (rng.random((p, E)) if combine != "max" else np.zeros((p, E))).astype(np.float32)
    val = (rng.random((p, n)) * 10 - 5).astype(np.float32)
    deg = rng.integers(0, 3, (p, n)).astype(np.float32)
    return lsrc, ldst, w, val, deg


@pytest.mark.parametrize("entry,combine", [("kernel", "min"), ("kernel", "sum"), ("ops", "min"),
                                           ("ops", "max"), ("ops", "sum")])
@pytest.mark.parametrize("name,bad", [("lsrc", -1), ("lsrc", 40), ("ldst", -1), ("ldst", 40)])
def test_superstep_rejects_out_of_range_ids(entry, combine, name, bad):
    """An id outside [0, num_out) raises the ValueError of check_ids before
    any gather, and a good call right after works (max is an `ops` entry:
    min through negation)."""
    lsrc, ldst, w, val, deg = _guard_inputs(combine)
    fn = pt_bsp.bsp_superstep if entry == "kernel" else pt_ops.bsp_superstep
    kw = dict(num_out=40, combine=combine, inner_cap=100)
    if combine == "sum":
        kw["out_degree"] = _t(deg)
    bad_ids = {"lsrc": lsrc.copy(), "ldst": ldst.copy()}
    bad_ids[name][1, 17] = bad
    with pytest.raises(ValueError, match=f"{name} has ids"):
        fn(_t(bad_ids["lsrc"]), _t(bad_ids["ldst"]), _t(w), _t(val), **kw)
    got, it = fn(_t(lsrc), _t(ldst), _t(w), _t(val), **kw)
    assert got.shape == (3, 40) and it.shape == (3,)
    assert torch.isfinite(got).all()


@pytest.fixture(scope="module")
def port_subgraphs(small_powerlaw):
    """{symmetrize: port SubgraphSet} on the EBG 4-part partition of
    `small_powerlaw`, built by the reference and carried across."""
    from repro.core import PARTITIONERS
    from repro.graph.build import build_subgraphs

    res = PARTITIONERS["ebg"](small_powerlaw, 4)
    return {sym: interop.to_port(build_subgraphs(small_powerlaw, res, symmetrize=sym),
                                 device="cpu") for sym in (False, True)}


@pytest.mark.parametrize("prog", ["cc", "reach", "pr"])
@pytest.mark.parametrize("name", ["lsrc", "ldst"])
def test_run_bsp_rejects_out_of_range_ids(small_powerlaw, port_subgraphs, prog, name):
    """A subgraph whose stream holds an id past the dump slot makes run_bsp
    raise the same ValueError; the untouched subgraph runs."""
    sub = port_subgraphs[prog != "pr"]
    ids = getattr(sub, name).clone()
    ids[2, 0] = sub.max_v + 1
    bad = dataclasses.replace(sub, **{name: ids})
    kw = dict(num_vertices=small_powerlaw.num_vertices)
    with pytest.raises(ValueError, match=f"{name} has ids"):
        eng.run_bsp(bad, prog, **kw)
    _, stats = eng.run_bsp(sub, prog, **kw)
    assert stats.supersteps >= 1
