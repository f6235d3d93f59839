"""The Graph500 generator on the CPU at small scales."""
import pytest
import torch

from bench import gen

SEED = 2**31 + 977


@pytest.mark.parametrize("scale", [8, 11])
def test_same_seed_same_graph(scale):
    a = gen.kronecker(scale, 16, 0.57, 0.19, 0.19, seed=SEED, device="cpu")
    b = gen.kronecker(scale, 16, 0.57, 0.19, 0.19, seed=SEED, device="cpu")
    assert torch.equal(a.src, b.src) and torch.equal(a.dst, b.dst)
    assert torch.equal(a.weight, b.weight) and a.num_vertices == b.num_vertices
    c = gen.kronecker(scale, 16, 0.57, 0.19, 0.19, seed=SEED + 1, device="cpu")
    assert c.num_edges != a.num_edges or not torch.equal(c.src, a.src)


@pytest.mark.parametrize("scale", [8, 11])
def test_no_self_loops_or_duplicates(scale):
    el = gen.kronecker(scale, 16, 0.57, 0.19, 0.19, seed=SEED, device="cpu")
    assert el.src.dtype == torch.int32 and el.dst.dtype == torch.int32
    assert bool((el.src < el.dst).all())  # no self-loop, one orientation
    key = el.src.long() * el.num_vertices + el.dst.long()
    assert torch.unique(key).numel() == el.num_edges
    assert bool((key[1:] > key[:-1]).all())  # sorted by (src, dst)


def test_edge_count_and_vertices():
    el = gen.kronecker(12, 16, 0.57, 0.19, 0.19, seed=SEED, device="cpu")
    assert el.generated_edges == 16 << 12
    # Duplicates and self-loops take a share that shrinks with the scale
    # (Graphalytics' graph500-22 keeps 95.6 % of 2**26); at scale 12 most
    # edges stay.
    assert 0.6 * el.generated_edges < el.num_edges <= el.generated_edges
    deg = torch.bincount(el.src.long(), minlength=el.num_vertices) + torch.bincount(
        el.dst.long(), minlength=el.num_vertices)
    assert el.num_vertices <= 1 << 12 and bool((deg > 0).all())
    assert 0 <= float(el.weight.min()) and float(el.weight.max()) < 1


def test_search_keys_have_edges():
    el = gen.kronecker(10, 16, 0.57, 0.19, 0.19, seed=SEED, device="cpu")
    keys = gen.search_keys(el.num_vertices, 256, seed=SEED, device="cpu")
    deg = torch.bincount(torch.cat([el.src, el.dst]).long(), minlength=el.num_vertices)
    assert bool((deg[keys] >= 1).all())
    assert torch.equal(keys, gen.search_keys(el.num_vertices, 256, seed=SEED, device="cpu"))


def test_stream_seeds_differ_and_fit():
    a, b = gen.stream_seed(SEED, "kronecker"), gen.stream_seed(SEED, "weights")
    assert a != b and 0 <= a < 2**63 and 0 <= b < 2**63


def test_bad_initiator_refused():
    with pytest.raises(ValueError):
        gen.kronecker(6, 16, 0.6, 0.3, 0.2, seed=1, device="cpu")
