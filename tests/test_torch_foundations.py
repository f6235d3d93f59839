"""Port parity, foundations: generators, degree order, metrics, types,
configs and registry, device resolution, and the package's import rule.

Every check feeds the same seeded inputs to the JAX reference (`repro`)
and to the PyTorch port (`repro_torch`) on the CPU and demands identical
results: these modules are integer/float64 numpy on both sides.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro.core import metrics as ref_metrics
from repro.core.order import degree_sum_order as ref_order
from repro.core.types import PartitionResult as RefResult
from repro.graph import generate as ref_gen
from repro.kernels import ops as ref_ops
from repro_torch import interop
from repro_torch.api import config as pt_config
from repro_torch.api import registry as pt_registry
from repro_torch.core import metrics as pt_metrics
from repro_torch.core.order import degree_sum_order as pt_order
from repro_torch.core.types import PartitionResult as PtResult
from repro_torch.graph import generate as pt_gen
from repro_torch.kernels import dispatch, ops as pt_ops

PORT_ROOT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same_graph(ref, port):
    assert port.num_vertices == ref.num_vertices
    np.testing.assert_array_equal(_np(port.src), np.asarray(ref.src))
    np.testing.assert_array_equal(_np(port.dst), np.asarray(ref.dst))
    assert port.src.dtype == torch.int32 and port.dst.dtype == torch.int32


@pytest.mark.parametrize("kw", [
    dict(num_vertices=256, num_edges=1024, seed=3),
    dict(num_vertices=1 << 12, num_edges=30_000, a=0.65, b=0.15, c=0.15, seed=7),
    dict(num_vertices=64, num_edges=5000, seed=1),  # dedup leaves fewer than asked
])
def test_rmat_edges_identical(kw):
    _assert_same_graph(ref_gen.rmat(**kw), pt_gen.rmat(**kw))


@pytest.mark.parametrize("name", ["tiny_powerlaw", "tiny_road"])
def test_registry_graphs_identical(name):
    assert set(pt_gen.REGISTRY) == set(ref_gen.REGISTRY)
    _assert_same_graph(ref_gen.make_graph(name), pt_gen.make_graph(name))


def test_barabasi_and_road_identical():
    _assert_same_graph(ref_gen.barabasi(500, 4, seed=2), pt_gen.barabasi(500, 4, seed=2))
    _assert_same_graph(ref_gen.barabasi(5, 8), pt_gen.barabasi(5, 8))  # no blocks
    _assert_same_graph(ref_gen.road_grid(20, seed=4), pt_gen.road_grid(20, seed=4))


def test_rmat_bitplane_identical():
    rng = np.random.default_rng(0)
    r = rng.random(1000)
    s0 = rng.integers(0, 50, 1000)
    d0 = rng.integers(0, 50, 1000)
    for a, b in zip(ref_gen._rmat_bitplane(s0, d0, r, 0.5, 0.2, 0.2),
                    pt_gen._rmat_bitplane(s0, d0, r, 0.5, 0.2, 0.2)):
        np.testing.assert_array_equal(a, b)


def test_rmat_chunks_draw_the_reference_stream(monkeypatch):
    """Many small chunks on the thread pool, each drawing from its own
    advanced copy of the generator, give the reference's edges."""
    monkeypatch.setattr(pt_gen, "_CHUNK", 4096)
    kw = dict(num_vertices=1 << 12, num_edges=30_000, seed=11)
    _assert_same_graph(ref_gen.rmat(**kw), pt_gen.rmat(**kw))


def test_rmat_rejects_non_power_of_two():
    with pytest.raises(ValueError, match="power of 2"):
        pt_gen.rmat(100, 10)


@pytest.mark.parametrize("name", ["tiny_powerlaw", "tiny_road"])
def test_degree_order_and_graph_methods(name):
    ref, port = ref_gen.make_graph(name), pt_gen.make_graph(name)
    np.testing.assert_array_equal(pt_order(port), ref_order(ref))
    np.testing.assert_array_equal(port.degrees(), ref.degrees())
    np.testing.assert_array_equal(port.covered_vertices(), ref.covered_vertices())
    assert port.num_edges == ref.num_edges


def test_graph_validate_names_the_field():
    bad = interop.graph_from_numpy(np.array([0, 5]), np.array([1, 2]), 4)
    with pytest.raises(ValueError, match="src has vertex id 5"):
        bad.validate()
    neg = interop.graph_from_numpy(np.array([0, 1]), np.array([-1, 2]), 4)
    with pytest.raises(ValueError, match="dst has negative"):
        neg.validate()
    interop.graph_from_numpy(np.array([0, 1]), np.array([1, 2]), 4).validate()


def test_part_in_input_order():
    rng = np.random.default_rng(0)
    part = rng.integers(0, 4, 50).astype(np.int32)
    order = rng.permutation(50)
    ref = RefResult(part=part, num_parts=4, order=order)
    port = interop.partition_from_numpy(part, 4, order, device="cpu")
    np.testing.assert_array_equal(port.part_in_input_order(), ref.part_in_input_order())
    plain = PtResult(part=torch.from_numpy(part), num_parts=4)
    np.testing.assert_array_equal(plain.part_in_input_order(), part)


@pytest.mark.parametrize("p", [1, 4, 32])
def test_partition_metrics_identical(tiny_powerlaw, p):
    rng = np.random.default_rng(p)
    part = rng.integers(0, p, tiny_powerlaw.num_edges).astype(np.int32)
    order = rng.permutation(tiny_powerlaw.num_edges)
    ref = ref_metrics.partition_metrics(tiny_powerlaw, RefResult(part=part, num_parts=p, order=order))
    g = interop.graph_from_numpy(tiny_powerlaw.src, tiny_powerlaw.dst, tiny_powerlaw.num_vertices)
    port = pt_metrics.partition_metrics(g, interop.partition_from_numpy(part, p, order, device="cpu"))
    assert port.replication_factor == ref.replication_factor
    assert port.edge_imbalance == ref.edge_imbalance
    assert port.vertex_imbalance == ref.vertex_imbalance
    np.testing.assert_array_equal(port.edges_per_part, ref.edges_per_part)
    np.testing.assert_array_equal(port.vertices_per_part, ref.vertices_per_part)
    assert port.row() == ref.row()


def test_bounds_and_max_mean_identical():
    for E, p, a, b in [(1000, 4, 1.0, 1.0), (77, 8, 0.5, 2.0)]:
        assert pt_metrics.theorem1_edge_bound(E, p, a, b) == ref_metrics.theorem1_edge_bound(E, p, a, b)
        assert (pt_metrics.theorem2_vertex_bound(3 * E, E, p, a, b)
                == ref_metrics.theorem2_vertex_bound(3 * E, E, p, a, b))
    for c in ([1, 2, 3, 10], [0, 0], [5]):
        assert pt_metrics.max_mean_ratio(c) == ref_metrics.max_mean_ratio(c)


def test_configs_validate_like_the_reference():
    cfg = pt_config.EBGConfig()
    assert (cfg.alpha, cfg.beta, cfg.block, cfg.sort_edges, cfg.commit) == (1.0, 1.0, 256, True, "frozen")
    assert pt_config.EBVConfig is pt_config.EBGConfig
    assert pt_config.COMMIT_MODES == ("frozen", "window")
    assert not hasattr(cfg, "compute_backend")
    for bad in (dict(alpha=0), dict(beta=float("inf")), dict(block=0), dict(block=True),
                dict(sort_edges=1), dict(commit="optimistic")):
        with pytest.raises(ValueError):
            pt_config.EBGConfig(**bad)
    with pytest.raises(ValueError, match="lam"):
        pt_config.HDRFConfig(lam=-1.0)
    with pytest.raises(ValueError, match="eps"):
        pt_config.GreedyConfig(eps=0.0)
    assert cfg.replace(block=64).block == 64


def test_registry_lists_the_streaming_partitioners():
    names = [s.name for s in pt_registry.list_partitioners()]
    # The streaming family first, then the paper's baselines, as the reference registers them.
    assert names == ["ebg", "ebg_chunked", "hdrf", "greedy", "hash", "dbh", "cvc", "ne", "metis"]
    spec = pt_registry.get_partitioner("ebg_chunked")
    assert spec.scorer == "ebv" and spec.chunked
    assert "device" not in spec.accepted_kwargs and "block" in spec.accepted_kwargs
    with pytest.raises(KeyError, match="unknown partitioner"):
        pt_registry.get_partitioner("metis_like")
    with pytest.raises(ValueError, match="does not use"):
        pt_registry.get_partitioner("ebg").check_overrides({"block": 8})
    for bad in (0, -1, 2.0, True):
        with pytest.raises(ValueError, match="num_parts"):
            pt_registry.check_num_parts(bad)
    with pytest.raises(ValueError, match="already registered"):
        pt_registry.register_partitioner("ebg")(lambda g, p: None)


def test_resolve_device_never_falls_back(monkeypatch):
    assert dispatch.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dispatch.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dispatch.resolve_device("cuda")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        dispatch.resolve_device("meta")


def test_pack_keep_bits_matches_reference():
    rng = np.random.default_rng(0)
    keep = rng.random((5, 70)) < 0.5
    ref = np.asarray(ref_ops.pack_keep_bits(keep)).view(np.int32)
    np.testing.assert_array_equal(pt_ops.pack_keep_bits(torch.from_numpy(keep)).numpy(), ref)


def test_port_imports_neither_jax_nor_reference():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)
    files = sorted(PORT_ROOT.rglob("*.py")) + [PORT_ROOT.parents[1] / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        assert not pattern.search(path.read_text()), f"{path} imports jax or repro"
