"""Port parity, the out-of-core pipeline on the CPU: the edge-shard store
(`repro_torch.data.edgeshards`), the external degree-sum order, the
out-of-core partition driver (`repro_torch.core.outofcore`, the plain
`ebg_commit` here) and the streamed builder
(`repro_torch.graph.build_stream`).

Each test is the counterpart of one in tests/test_scale.py, at its sizes
(V, E, P = 2^10, 2^12, 4; shards of 500 edges, so at least 4), on the
same seeded inputs: the reference's `rmat(V, E, seed=3)` carried across.
The oracles are the port's in-memory drivers and the reference's
out-of-core ones (`partition_store(compute_backend="ref")`, the
reference's bitset path), all bit for bit: shard files and manifests,
block streams, degrees, the order, assignments in stream and input
order, the counters, every `SubgraphSet` field, CC's labels and stats.
"""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from repro.core import outofcore as ref_oc
from repro.core.order import degree_sum_order as ref_degree_sum_order
from repro.data import edgeshards as ref_es
from repro.graph.build_stream import build_subgraphs_stream as ref_build_stream
from repro.graph.generate import rmat as ref_rmat
from repro_torch import interop
from repro_torch.core import outofcore as oc
from repro_torch.core.metrics import partition_metrics
from repro_torch.core.order import degree_sum_order
from repro_torch.core.streaming import streaming_chunked_partition
from repro_torch.core.types import Graph, PartitionResult
from repro_torch.data import edgeshards as es
from repro_torch.graph import engine as eng
from repro_torch.graph.build import build_subgraphs
from repro_torch.graph.build_stream import build_subgraphs_stream

V, E, P = 1 << 10, 1 << 12, 4
CPU = "cpu"


@pytest.fixture(scope="module")
def ref_graph():
    return ref_rmat(V, E, seed=3)


@pytest.fixture(scope="module")
def graph(ref_graph):
    return interop.graph_from_numpy(ref_graph.src, ref_graph.dst, ref_graph.num_vertices)


@pytest.fixture(scope="module")
def store(graph, tmp_path_factory):
    path = tmp_path_factory.mktemp("shards") / "store"
    return es.write_graph(graph, path, shard_edges=500)  # >= 4 shards


@pytest.fixture(scope="module")
def ref_store(ref_graph, tmp_path_factory):
    path = tmp_path_factory.mktemp("ref_shards") / "store"
    return ref_es.write_graph(ref_graph, path, shard_edges=500)


def assert_subgraphs_equal(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, (int, str)):
            assert va == vb, f.name
        else:
            va = va.cpu().numpy() if isinstance(va, torch.Tensor) else np.asarray(va)
            vb = vb.cpu().numpy() if isinstance(vb, torch.Tensor) else np.asarray(vb)
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)


# ------------------------------------------------------------ shard store


def test_store_roundtrip_and_manifest(graph, store):
    assert store.num_shards >= 4
    g2 = es.load_graph(store)
    np.testing.assert_array_equal(graph.src.numpy(), g2.src.numpy())
    np.testing.assert_array_equal(graph.dst.numpy(), g2.dst.numpy())
    assert g2.src.dtype == torch.int32 and g2.num_vertices == V
    # manifest: shard edge counts sum to E; every shard carries its
    # log2-bucketed degree histogram (#distinct endpoints, bucketed)
    assert sum(s["num_edges"] for s in store.shards) == graph.num_edges
    for s in store.shards:
        assert sum(s["degree_hist"]) >= 1


def test_stores_are_the_same_files_in_both_packages(store, ref_store):
    """The same graph sharded by either package: the same manifest and the
    same shard bytes; each package opens the other's store."""
    assert (json.loads((store.path / es.MANIFEST_NAME).read_text())
            == json.loads((ref_store.path / ref_es.MANIFEST_NAME).read_text()))
    for s in store.shards:
        assert (store.path / s["file"]).read_bytes() == (ref_store.path / s["file"]).read_bytes()
    mine = es.load_graph(es.EdgeShardStore.open(ref_store.path))
    theirs = ref_es.load_graph(ref_es.EdgeShardStore.open(store.path))
    np.testing.assert_array_equal(mine.src.numpy(), np.asarray(theirs.src))
    np.testing.assert_array_equal(mine.dst.numpy(), np.asarray(theirs.dst))


def test_writer_appends_in_pieces(graph, store, tmp_path):
    """Appending the edges in uneven pieces gives the same shards."""
    src, dst = graph.src.numpy(), graph.dst.numpy()
    with es.ShardWriter(tmp_path / "pieces", V, shard_edges=500) as w:
        for lo, hi in ((0, 7), (7, 1200), (1200, 1201), (1201, src.size)):
            w.append(src[lo:hi], dst[lo:hi])
    again = es.EdgeShardStore.open(tmp_path / "pieces")
    assert again.shards == store.shards
    for s in store.shards:
        assert (again.path / s["file"]).read_bytes() == (store.path / s["file"]).read_bytes()


@pytest.mark.parametrize("block", [1, 333, 500, 1000, 5000])
def test_iter_blocks_spans_shards(graph, store, ref_store, block):
    """Blocks across shard boundaries, block for block the reference's."""
    mine = list(store.iter_blocks(block))
    theirs = list(ref_store.iter_blocks(block))
    assert len(mine) == len(theirs) == -(-graph.num_edges // block)
    for a, b in zip(mine, theirs):
        for x, y in zip(a, b):
            assert x.dtype == np.int64
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(np.concatenate([s for s, _, _ in mine]), graph.src.numpy())
    np.testing.assert_array_equal(np.concatenate([i for _, _, i in mine]), np.arange(graph.num_edges))


def test_degrees_from_shards(graph, store):
    np.testing.assert_array_equal(es.degrees_from_shards(store), graph.degrees())


@pytest.mark.parametrize("bucket_edges", [1 << 22, 700])
def test_external_degree_sum_order(graph, ref_graph, store, ref_store, tmp_path, bucket_edges):
    """The external order equals the in-memory §IV-C permutation of both
    packages, with one bucket and with several; its blocks and bucket files
    are the reference's."""
    stream = es.degree_sum_stream(store, workdir=tmp_path / "order", bucket_edges=bucket_edges)
    ref_stream = ref_es.degree_sum_stream(ref_store, workdir=tmp_path / "ref_order",
                                          bucket_edges=bucket_edges)
    try:
        assert stream.num_buckets >= (1 if bucket_edges > E else 5)
        assert stream.bucket_counts == ref_stream.bucket_counts
        perm = stream.permutation()
        np.testing.assert_array_equal(perm, degree_sum_order(graph))
        np.testing.assert_array_equal(perm, np.asarray(ref_degree_sum_order(ref_graph)))
        for i in range(stream.num_buckets):
            name = f"bucket-{i:05d}.bin"
            assert (tmp_path / "order" / name).read_bytes() == (
                tmp_path / "ref_order" / name).read_bytes()
        for a, b in zip(stream.iter_blocks(300), ref_stream.iter_blocks(300)):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    finally:
        stream.cleanup()
        ref_stream.cleanup()
    assert not list((tmp_path / "order").glob("bucket-*"))


def test_rmat_to_store_deterministic_and_valid(tmp_path):
    s1 = es.rmat_to_store(tmp_path / "r1", V, E, seed=7, shard_edges=700, chunk=900)
    s2 = es.rmat_to_store(tmp_path / "r2", V, E, seed=7, shard_edges=700, chunk=900)
    ga, gb = es.load_graph(s1), es.load_graph(s2)
    np.testing.assert_array_equal(ga.src.numpy(), gb.src.numpy())
    np.testing.assert_array_equal(ga.dst.numpy(), gb.dst.numpy())
    assert ga.num_edges == E
    key = ga.src.numpy().astype(np.int64) * V + ga.dst.numpy()
    assert np.all(np.diff(key) > 0)  # key-sorted, deduped, no self loops
    assert np.all(key // V != key % V)


def test_rmat_to_store_equals_reference_edge_for_edge(tmp_path):
    """The same seed and shard size: the reference's store, edge for edge
    and file for file."""
    mine = es.rmat_to_store(tmp_path / "mine", V, E, seed=7, shard_edges=700, chunk=900)
    ref = ref_es.rmat_to_store(tmp_path / "ref", V, E, seed=7, shard_edges=700, chunk=900)
    assert mine.shards == ref.shards
    for s in mine.shards:
        assert (mine.path / s["file"]).read_bytes() == (ref.path / s["file"]).read_bytes()


# -------------------------------------------- out-of-core == in-memory


@pytest.mark.parametrize("commit", ("frozen", "window"))
@pytest.mark.parametrize("scorer", ("ebv", "hdrf", "greedy"))
def test_partition_store_matches_in_memory_and_reference(graph, store, ref_store, tmp_path,
                                                         scorer, commit):
    r_mem = streaming_chunked_partition(graph, P, scorer, block=128, commit=commit, device=CPU)
    r_oc = oc.partition_store(store, P, scorer, block=128, commit=commit,
                              order_workdir=tmp_path / "order", device=CPU)
    np.testing.assert_array_equal(r_mem.part.numpy(), r_oc.result.part.numpy())
    np.testing.assert_array_equal(r_mem.part_in_input_order(), r_oc.result.part_in_input_order())
    r_ref = ref_oc.partition_store(ref_store, P, scorer, block=128, compute_backend="ref",
                                   commit=commit, order_workdir=tmp_path / "ref_order")
    np.testing.assert_array_equal(r_oc.result.part.numpy(), np.asarray(r_ref.result.part))
    np.testing.assert_array_equal(r_oc.result.part_in_input_order(),
                                  np.asarray(r_ref.result.part_in_input_order()))
    np.testing.assert_array_equal(r_oc.e_count, np.asarray(r_ref.e_count))
    np.testing.assert_array_equal(r_oc.v_count, np.asarray(r_ref.v_count))
    assert (r_oc.covered, r_oc.num_blocks) == (r_ref.covered, r_ref.num_blocks)
    assert r_oc.replication_factor == r_ref.replication_factor
    assert r_oc.replication_factor >= 1.0
    # The counters against the partition's metrics: edge counts exact; the
    # vertex counters are |V_i| under window commit, and over-count under
    # frozen commit (a vertex new to a part is counted once for each edge
    # of a block that brings it, as in the reference).
    m = partition_metrics(graph, r_oc.result)
    np.testing.assert_array_equal(r_oc.e_count, m.edges_per_part.astype(np.float32))
    if commit == "window":
        np.testing.assert_array_equal(r_oc.v_count, m.vertices_per_part.astype(np.float32))
    else:
        assert (r_oc.v_count >= m.vertices_per_part).all()


@pytest.mark.parametrize("block,group_edges", [(128, 256), (100, 250), (128, 128), (3000, 64)])
def test_partition_store_groups_of_blocks(store, monkeypatch, block, group_edges):
    """However many whole blocks a commit call takes (the last group's last
    block short), the assignments and counters are the same."""
    want = oc.partition_store(store, P, "hdrf", block=block, device=CPU)
    monkeypatch.setattr(oc, "GROUP_EDGES", group_edges)
    got = oc.partition_store(store, P, "hdrf", block=block, device=CPU)
    np.testing.assert_array_equal(got.result.part.numpy(), want.result.part.numpy())
    np.testing.assert_array_equal(got.e_count, want.e_count)
    np.testing.assert_array_equal(got.v_count, want.v_count)
    assert got.num_blocks == want.num_blocks == -(-store.num_edges // block)


def test_partition_store_reuses_external_passes(store, tmp_path):
    """Precomputed degrees and ordered stream give the same partition."""
    deg = es.degrees_from_shards(store)
    ordered = es.degree_sum_stream(store, deg, workdir=tmp_path / "o")
    a = oc.partition_store(store, P, "ebv", block=128, degrees=deg, ordered=ordered, device=CPU)
    b = oc.partition_store(store, P, "ebv", block=128, order_workdir=tmp_path / "o2", device=CPU)
    np.testing.assert_array_equal(a.result.part.numpy(), b.result.part.numpy())
    assert a.result.order.dtype == torch.int64


def test_sharded_state_layout_raises(store, monkeypatch):
    # state_layout="sharded" is ported (tests/test_torch_distributed.py
    # holds it against "replicated" at worlds 1 and 2). num_parts must
    # divide over the mesh, checked before any collective (a 3-wide
    # stand-in mesh), and the default mesh is the card's, with no fallback.
    three = types.SimpleNamespace(shape=(3,), mesh_dim_names=("workers",), device_type="cpu")
    with pytest.raises(ValueError, match=f"num_parts={P} must divide evenly over 3"):
        oc.partition_store(store, P, "ebv", state_layout="sharded", mesh=three, device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        oc.partition_store(store, P, "ebv", state_layout="sharded", device=CPU)
    with pytest.raises(ValueError, match="state_layout"):
        oc.partition_store(store, P, "ebv", state_layout="striped", device=CPU)
    assert oc.check_state_layout("replicated") == "replicated"


def test_edge_part_stream_replays_every_edge(graph, store, tmp_path):
    r_oc = oc.partition_store(store, P, "ebv", block=128, order_workdir=tmp_path / "o",
                              device=CPU)
    total, parts = 0, []
    for s, d, pt in r_oc.edge_part_stream(200):
        assert s.shape == d.shape == pt.shape
        assert pt.min() >= 0 and pt.max() < P
        total += s.shape[0]
        parts.append(pt)
    assert total == graph.num_edges
    np.testing.assert_array_equal(np.concatenate(parts), r_oc.result.part.numpy())


# ------------------------------------------------------ streamed builder


@pytest.mark.parametrize("symmetrize", (False, True))
def test_build_stream_bitwise_equals_in_memory(graph, store, ref_store, tmp_path, symmetrize):
    """Every SubgraphSet field: the port's in-memory build on the same
    partition, and the reference's streamed build on the same stream."""
    r_oc = oc.partition_store(store, P, "ebv", block=128, order_workdir=tmp_path / "o",
                              device=CPU)
    part_in = r_oc.result.part_in_input_order().astype(np.int64)

    def factory():
        for s, d, i in store.iter_blocks(300):
            yield s, d, part_in[i]

    a = build_subgraphs(graph, r_oc.result, symmetrize=symmetrize, device=CPU)
    b = build_subgraphs_stream(factory, V, P, symmetrize=symmetrize, device=CPU)
    assert_subgraphs_equal(a, b)
    assert b.addressing == "two_level"
    l2g = b.local_to_global
    assert l2g.dtype == np.int64 and l2g.shape == (P, b.max_v)
    ref = ref_build_stream(factory, V, P, symmetrize=symmetrize)
    assert_subgraphs_equal(b, ref)
    # The partition's own replay, in its stream order, builds the set the
    # in-memory builder makes of the edge list in that order.
    c = build_subgraphs_stream(lambda: r_oc.edge_part_stream(500), V, P,
                               symmetrize=symmetrize, device=CPU)
    order = r_oc.result.order
    in_stream = Graph(src=graph.src[order], dst=graph.dst[order], num_vertices=V)
    d = build_subgraphs(in_stream, PartitionResult(part=r_oc.result.part, num_parts=P),
                        symmetrize=symmetrize, device=CPU)
    assert_subgraphs_equal(c, d)


def test_end_to_end_out_of_core_cc_matches_in_memory(graph, store, tmp_path):
    """shards -> external order -> out-of-core partition -> streamed build
    -> CC, against the fully in-memory pipeline on the same graph."""
    r_mem = streaming_chunked_partition(graph, P, "ebv", block=128, device=CPU)
    sub_mem = build_subgraphs(graph, r_mem, symmetrize=True, device=CPU)
    val_mem, stats_mem = eng.run_bsp(sub_mem, "cc")

    r_oc = oc.partition_store(store, P, "ebv", block=128, order_workdir=tmp_path / "o",
                              device=CPU)
    sub_oc = build_subgraphs_stream(lambda: r_oc.edge_part_stream(300), V, P,
                                    symmetrize=True, device=CPU)
    val_oc, stats_oc = eng.run_bsp(sub_oc, "cc")
    np.testing.assert_array_equal(val_mem.numpy(), val_oc.numpy())
    assert stats_mem.supersteps == stats_oc.supersteps
    np.testing.assert_array_equal(stats_mem.messages_per_step_worker,
                                  stats_oc.messages_per_step_worker)


def test_builder_rejects_past_engine_ceiling():
    with pytest.raises(ValueError, match="engine ceiling"):
        build_subgraphs_stream(lambda: iter(()), (1 << 31) + 8, P, device=CPU)
