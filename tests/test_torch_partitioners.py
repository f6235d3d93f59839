"""Port parity, the paper's baseline partitioners: `hash`, `dbh`, `cvc`,
`ne` and `metis` on the CPU against the reference (`repro.core`), bit for
bit; the registry's views and flags; `estimate_eta`; the reference's
qualitative tests run on the port; a baseline through `GraphPipeline` to
CC against the reference pipeline; and the `twitter_like` numbers that
`chip_smoke.py` pins on the card.

All exact: the hash family computes the reference's uint64 splitmix64 in
int64 bits, and NE and the METIS-like partitioner are the reference's host
loops, draw for draw.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as ref_api
from repro.api.pipeline import GraphPipeline as RefPipeline
from repro.core import PARTITIONERS as REF_PARTITIONERS
from repro.graph import generate as ref_generate
from repro_torch import api as pt_api
from repro_torch import interop
from repro_torch.api.pipeline import GraphPipeline
from repro_torch.core import PARTITIONERS, baselines, partition_metrics
from repro_torch.core import (
    cvc_partition,
    dbh_partition,
    ebg_partition,
    metis_like_partition,
    ne_partition,
    random_hash_partition,
)
from repro_torch.graph import generate as pt_generate

BASELINES = ("hash", "dbh", "cvc", "ne", "metis")
ROOT = Path(__file__).resolve().parents[1]

# The reference on the CPU (p = 32, each baseline's defaults, then a
# symmetric build and CC with compute_backend="xla") on the registry's
# twitter_like graph: RF, edge and vertex imbalance to 6 decimals, CC
# (supersteps, total messages). chip_smoke.py holds the same table.
PINNED_TWITTER_LIKE = {
    "hash": (("9.568018", "1.010620", "1.008537"), (4, 1_209_490)),
    "dbh": (("4.039308", "1.201895", "1.030388"), (4, 430_814)),
    "cvc": (("5.081672", "1.120543", "1.055968"), (4, 612_352)),
    "ne": (("2.847871", "1.000008", "2.273158"), (2, 263_570)),
    "metis": (("3.354389", "20.466453", "7.109937"), (3, 328_897)),
}


def _port(g):
    return interop.graph_from_numpy(g.src, g.dst, g.num_vertices)


@pytest.fixture(scope="module")
def graphs(tiny_powerlaw, tiny_road, paper_example):
    return {name: (g, _port(g)) for name, g in (("tiny_powerlaw", tiny_powerlaw),
                                                 ("tiny_road", tiny_road),
                                                 ("paper_example", paper_example))}


# ----------------------------------------------------------- assignments


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("p", [2, 5, 8, 32])
@pytest.mark.parametrize("graph", ["tiny_powerlaw", "tiny_road", "paper_example"])
@pytest.mark.parametrize("name", BASELINES)
def test_baseline_matches_reference(graphs, name, graph, p, seed):
    ref_g, port_g = graphs[graph]
    want = REF_PARTITIONERS[name](ref_g, p, seed=seed)
    got = PARTITIONERS[name](port_g, p, seed=seed, device="cpu")
    assert got.num_parts == p and got.order is None
    assert got.part.dtype == torch.int32 and got.part.device.type == "cpu"
    np.testing.assert_array_equal(got.part_in_input_order(), want.part_in_input_order())


@pytest.mark.parametrize("p", [3, 5, 7, 1000, 2**31 - 1])
@pytest.mark.parametrize("name", ["hash", "cvc"])
def test_hash_takes_the_unsigned_remainder_at_the_top_ids(name, p):
    """Ids up to 2^31 - 1: the hashes' top bit is set for about half of
    them, and only the unsigned `%` gives the reference's parts."""
    from repro.core.types import Graph as RefGraph

    top = 2**31 - 1
    src = np.array([top, top - 1, 0, 5, top, 12345, top - 7], np.int32)
    dst = np.array([top, 3, top, 9, 0, top - 2, 77], np.int32)
    want = REF_PARTITIONERS[name](RefGraph(src=src, dst=dst, num_vertices=2**31), p)
    got = PARTITIONERS[name](interop.graph_from_numpy(src, dst, 2**31), p, device="cpu")
    np.testing.assert_array_equal(got.part.numpy(), np.asarray(want.part))


def test_unsigned_helpers_match_uint64():
    """`_hash_u64` and `_mod_u64` against numpy's uint64 on random words,
    both halves of the sign bit."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 2**63 - 1, 4096, dtype=np.int64)
    want = ref_baselines_hash(x, 3)
    got = baselines._hash_u64(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    assert (want >= np.uint64(1 << 63)).any() and (want < np.uint64(1 << 63)).any()
    for m in (1, 2, 3, 31, 1000, 2**31 - 1, 2**40 + 3):
        np.testing.assert_array_equal(baselines._mod_u64(got, m).numpy(),
                                      (want % np.uint64(m)).astype(np.int64))


def ref_baselines_hash(x, seed):
    from repro.core.baselines import _hash_u64

    with np.errstate(over="ignore"):
        return _hash_u64(x, seed)


@pytest.mark.parametrize("p", [1, 2, 6, 7, 12, 32, 36, 97, 1024])
def test_grid_shape_matches_reference(p):
    from repro.core.baselines import _grid_shape

    assert baselines._grid_shape(p) == _grid_shape(p)


def test_metis_knobs_match_reference(tiny_powerlaw):
    port_g = _port(tiny_powerlaw)
    for kw in (dict(coarsen_to=64), dict(coarsen_to=300, refine_passes=0), dict(seed=3)):
        want = REF_PARTITIONERS["metis"](tiny_powerlaw, 6, **kw)
        got = PARTITIONERS["metis"](port_g, 6, device="cpu", **kw)
        np.testing.assert_array_equal(got.part.numpy(), np.asarray(want.part))


# -------------------------------------------------------------- registry


def test_registry_views_match_reference():
    assert pt_api.partitioner_names() == ref_api.partitioner_names()
    assert pt_api.benchmark_partitioners() == ref_api.benchmark_partitioners()
    assert list(PARTITIONERS) == list(REF_PARTITIONERS)
    assert len(PARTITIONERS) == len(REF_PARTITIONERS)
    assert "RegistryFunctionView" in repr(PARTITIONERS)
    for name in pt_api.partitioner_names():
        spec, ref = pt_api.get_partitioner(name), ref_api.get_partitioner(name)
        assert (spec.deterministic, spec.benchmark_default, spec.chunked, spec.scorer) == \
            (ref.deterministic, ref.benchmark_default, ref.chunked, ref.scorer), name
        assert spec.config_cls.__name__ == ref.config_cls.__name__
        assert PARTITIONERS[name] is spec.fn
    assert PARTITIONERS["dbh"] is dbh_partition and PARTITIONERS["hash"] is random_hash_partition
    assert PARTITIONERS["cvc"] is cvc_partition and PARTITIONERS["ne"] is ne_partition
    assert PARTITIONERS["metis"] is metis_like_partition


@pytest.mark.parametrize("cls", ["HashConfig", "NEConfig", "MetisLikeConfig"])
def test_baseline_configs_match_reference(cls):
    import dataclasses

    port, ref = getattr(pt_api, cls), getattr(ref_api, cls)
    assert [(f.name, f.default) for f in dataclasses.fields(port)] == \
        [(f.name, f.default) for f in dataclasses.fields(ref)]
    for bad in (dict(seed=-1), dict(seed=1.5), dict(seed=True)):
        with pytest.raises(ValueError, match="seed"):
            ref(**bad)
        with pytest.raises(ValueError, match="seed"):
            port(**bad)
    if cls == "MetisLikeConfig":
        for bad, what in ((dict(coarsen_to=1), "coarsen_to"), (dict(refine_passes=-1),
                                                               "refine_passes")):
            with pytest.raises(ValueError, match=what):
                port(**bad)
            with pytest.raises(ValueError, match=what):
                ref(**bad)


def test_baselines_through_the_pipeline_take_their_knobs(tiny_powerlaw):
    pipe = GraphPipeline(_port(tiny_powerlaw), device="cpu")
    run = pipe.partition("metis", parts=4, coarsen_to=128, refine_passes=2)
    want = REF_PARTITIONERS["metis"](tiny_powerlaw, 4, coarsen_to=128, refine_passes=2)
    np.testing.assert_array_equal(run.result.part.numpy(), np.asarray(want.part))
    assert run.config == pt_api.MetisLikeConfig(coarsen_to=128, refine_passes=2)
    with pytest.raises(TypeError, match="block"):  # not a HashConfig field
        pipe.partition("hash", parts=4, block=8)
    with pytest.raises(ValueError, match="seed"):
        pipe.partition("ne", parts=4, seed=-2)


# ------------------------------------------------------------------ eta


@pytest.mark.parametrize("name", list(ref_generate.REGISTRY))
def test_estimate_eta_matches_reference(name):
    g = ref_generate.make_graph(name)
    want = ref_generate.estimate_eta(g)
    got = pt_generate.estimate_eta(_port(g))
    assert (math.isnan(got) and math.isnan(want)) or got == want


def test_estimate_eta_is_nan_for_uniform_degrees():
    ring = np.arange(64, dtype=np.int32)
    g = interop.graph_from_numpy(ring, (ring + 1) % 64, 64)
    assert math.isnan(pt_generate.estimate_eta(g))


# ------------------------------------------- the reference's claims, on the port


def test_paper_qualitative_claims(tiny_powerlaw):
    """Table III pattern: EBG < min(DBH, CVC) on replication; NE
    edge-balanced but vertex-imbalanced; hash worst replication."""
    g, p = _port(tiny_powerlaw), 8
    ebg = partition_metrics(g, ebg_partition(g, p, device="cpu"))
    dbh = partition_metrics(g, dbh_partition(g, p, device="cpu"))
    cvc = partition_metrics(g, cvc_partition(g, p, device="cpu"))
    ne = partition_metrics(g, ne_partition(g, p, device="cpu"))
    hsh = partition_metrics(g, random_hash_partition(g, p, device="cpu"))
    assert ebg.replication_factor < min(dbh.replication_factor, cvc.replication_factor)
    assert ebg.edge_imbalance < 1.15 and ebg.vertex_imbalance < 1.15
    assert ne.edge_imbalance < 1.05
    assert ne.vertex_imbalance > ebg.vertex_imbalance
    assert hsh.replication_factor > ebg.replication_factor


def test_metis_like_on_road_vs_powerlaw(tiny_road, tiny_powerlaw):
    """The paper's METIS pathology: fine on road-like graphs,
    edge-imbalanced on power-law graphs."""
    road_g, pl_g = _port(tiny_road), _port(tiny_powerlaw)
    road = partition_metrics(road_g, metis_like_partition(road_g, 8, device="cpu"))
    pl = partition_metrics(pl_g, metis_like_partition(pl_g, 8, device="cpu"))
    assert road.replication_factor < 1.6
    assert pl.edge_imbalance > road.edge_imbalance


# ------------------------------------------------------------- pipeline


@pytest.mark.parametrize("name", ["dbh", "ne"])
def test_baseline_pipeline_cc_matches_reference(tiny_powerlaw, name):
    """Partition, symmetric build and CC through both pipelines: labels,
    supersteps and every `BSPStats` field equal."""
    ref = RefPipeline(tiny_powerlaw).partition(name, parts=8).build(symmetrize=True)
    port = GraphPipeline(_port(tiny_powerlaw), device="cpu").partition(name, parts=8).build(
        symmetrize=True)
    assert port.metrics.row() == ref.metrics.row()
    r = ref.run("cc", compute_backend="xla")
    p = port.run("cc")
    np.testing.assert_array_equal(p.values, np.asarray(r.values))
    np.testing.assert_array_equal(p.to_global(), r.to_global())
    assert p.stats.supersteps == r.stats.supersteps
    assert p.stats.total_messages == r.stats.total_messages
    assert p.stats.max_mean == r.stats.max_mean
    for f in ("messages_per_worker", "messages_per_step_worker", "inner_iters_per_step",
              "comp_work_per_worker"):
        np.testing.assert_array_equal(getattr(p.stats, f), getattr(r.stats, f), err_msg=f)
    assert p.num_components() == r.num_components()


# ------------------------------------------- the numbers chip_smoke pins


@pytest.fixture(scope="module")
def twitter_like():
    return pt_generate.make_graph("twitter_like")


def test_chip_smoke_pins_the_same_numbers():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.PINNED_BASELINES == PINNED_TWITTER_LIKE


@pytest.mark.parametrize("name", BASELINES)
def test_twitter_like_pinned_numbers(twitter_like, name):
    """The port on the CPU gives the reference's twitter_like numbers, the
    ones chip_smoke.py holds the card to."""
    metrics, cc = PINNED_TWITTER_LIKE[name]
    pipe = GraphPipeline(twitter_like, device="cpu").partition(name, parts=32)
    m = pipe.metrics
    assert tuple(f"{x:.6f}" for x in (m.replication_factor, m.edge_imbalance,
                                      m.vertex_imbalance)) == metrics
    r = pipe.build(symmetrize=True).run("cc")
    assert (r.stats.supersteps, r.stats.total_messages) == cc
    assert r.num_components() == 46
