"""Port parity, subgraph build: every `SubgraphSet` field of the port's
build equals the reference's, bit for bit, in both addressing modes, with
and without symmetrization, weights and padding — on the same partition,
carried across with `repro_torch.interop`.
"""
import numpy as np
import pytest
import torch

from repro.core import PARTITIONERS
from repro.graph.build import build_subgraphs as ref_build
from repro_torch import interop
from repro_torch.graph.build import ARRAY_FIELDS, build_subgraphs as pt_build

TORCH_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32,
                np.dtype(np.bool_): torch.bool}


def _carry(graph, result):
    g = interop.graph_from_numpy(graph.src, graph.dst, graph.num_vertices)
    order = None if result.order is None else np.asarray(result.order)
    return g, interop.partition_from_numpy(np.asarray(result.part), result.num_parts, order,
                                           device="cpu")


def assert_same_subgraphs(port, ref):
    arrays, statics = interop.subgraph_fields(ref)
    for k, v in statics.items():
        assert getattr(port, k) == v, k
    for name in ARRAY_FIELDS:
        got = getattr(port, name)
        assert got.dtype == TORCH_DTYPES[arrays[name].dtype], name
        np.testing.assert_array_equal(got.numpy(), arrays[name], err_msg=name)


@pytest.mark.parametrize("addressing", ["two_level", "flat"])
@pytest.mark.parametrize("symmetrize", [False, True])
@pytest.mark.parametrize("graph_key,partitioner,p", [
    ("tiny_powerlaw", "ebg", 8), ("small_powerlaw", "hdrf", 4), ("paper_example", "ebg", 2),
    ("tiny_road", "greedy", 4),
])
def test_build_matches_reference(request, graph_key, partitioner, p, symmetrize, addressing):
    graph = request.getfixturevalue(graph_key)
    res = PARTITIONERS[partitioner](graph, p)
    ref = ref_build(graph, res, symmetrize=symmetrize, addressing=addressing)
    port = pt_build(*_carry(graph, res), symmetrize=symmetrize, addressing=addressing,
                    device="cpu")
    assert_same_subgraphs(port, ref)


def test_build_weights_and_padding_match(tiny_powerlaw):
    res = PARTITIONERS["ebg_chunked"](tiny_powerlaw, 4, block=64)
    w = np.random.default_rng(0).random(tiny_powerlaw.num_edges).astype(np.float32) + 0.5
    for pad in (1, 8, 32):
        ref = ref_build(tiny_powerlaw, res, weights=w, pad_multiple=pad)
        port = pt_build(*_carry(tiny_powerlaw, res), weights=w, pad_multiple=pad, device="cpu")
        assert_same_subgraphs(port, ref)


def test_singleton_parts_and_duplicate_edges():
    from repro.core.types import Graph, PartitionResult

    g = Graph(src=np.array([0, 0, 1, 2], np.int32), dst=np.array([1, 1, 2, 0], np.int32),
              num_vertices=5)
    res = PartitionResult(part=np.array([0, 2, 2, 2], np.int32), num_parts=3)
    ref = ref_build(g, res)
    port = pt_build(*_carry(g, res), device="cpu")
    assert_same_subgraphs(port, ref)


def test_carried_subgraphs_round_trip(tiny_powerlaw):
    res = PARTITIONERS["ebg"](tiny_powerlaw, 4)
    ref = ref_build(tiny_powerlaw, res, addressing="flat")
    arrays, statics = interop.subgraph_fields(ref)
    port = interop.subgraphs_from_numpy(arrays, **statics, device="cpu")
    assert_same_subgraphs(port, ref)
    np.testing.assert_array_equal(port.local_to_global, ref.local_to_global)
    np.testing.assert_array_equal(port.num_local_vertices.numpy(),
                                  np.asarray(ref.num_local_vertices))
    assert port.to("cpu") is port
    bad = dict(arrays, gid=arrays["gid"][:, :-1])
    with pytest.raises(ValueError, match="gid has shape"):
        interop.subgraphs_from_numpy(bad, **statics, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        interop.subgraphs_from_numpy({"gid": arrays["gid"]}, **statics, device="cpu")
    with pytest.raises(ValueError, match="addressing"):
        pt_build(*_carry(tiny_powerlaw, res), addressing="three_level", device="cpu")
