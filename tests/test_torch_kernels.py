"""Port parity, the public kernel entries: `repro_torch.kernels.ops`'s
segment reductions, membership and decode attention against
`repro.kernels.ops`, on the same seeded numpy inputs.

Here the port runs its plain PyTorch versions (device "cpu"). The segment
reductions are held against the reference's `impl="ref"` only (its Pallas
path calls `pl.load`, which the installed JAX no longer has); membership
and attention also against the Pallas kernels in interpret mode.

Exact: segment min and max (min is order-free and each val+w is one f32
add), membership (values 0, 1 or 2). Tolerance: segment sums rtol 1e-5 /
atol 1e-6, as `tests/test_kernels.py` holds the Pallas sum (f32 sums in
another order); attention 2e-5 in f32 and, in bf16, one rounding of the
output (rtol 2^-7, atol 1e-5), which a 1 % error fails. The kernels
themselves are held against these plain versions on the card in
`tests/test_torch_cuda_kernels.py`.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch import interop
from repro_torch.kernels import decode_attn as pt_attn
from repro_torch.kernels import ebg_score as pt_memb
from repro_torch.kernels import ops as pt_ops
from repro_torch.kernels import segment_reduce as pt_seg

SUM_RTOL, SUM_ATOL = 1e-5, 1e-6
ENTRIES = {
    "min": ("segment_min_plus", pt_ops.segment_min_plus),
    "max": ("segment_max", pt_ops.segment_max),
    "sum": ("segment_sum_scaled", pt_ops.segment_sum_scaled),
}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _both(op, lsrc, ldst, w, val, num_out, block_e=512):
    """(reference impl="ref", port) of one segment entry on the same arrays."""
    name, port = ENTRIES[op]
    ref = getattr(ref_ops, name)(jnp.array(lsrc), jnp.array(ldst), jnp.array(w),
                                 jnp.array(val), num_out=num_out, impl="ref")
    got = port(_t(lsrc), _t(ldst), _t(w), _t(val), num_out=num_out, block_e=block_e)
    assert got.dtype == torch.float32 and tuple(got.shape) == (num_out,)
    return np.asarray(ref), got.numpy()


def _assert_segment(op, got, ref):
    if op == "sum":
        np.testing.assert_allclose(got, ref, rtol=SUM_RTOL, atol=SUM_ATOL)
    else:
        np.testing.assert_array_equal(got, ref)


def _segment_inputs(V, E, seed):
    rng = np.random.default_rng(seed)
    ldst = np.sort(rng.integers(0, V, E)).astype(np.int32)
    lsrc = rng.integers(0, V, E).astype(np.int32)
    w = rng.random(E).astype(np.float32) + 0.1
    val = (rng.random(V + 1) * 10).astype(np.float32)
    return lsrc, ldst, w, val


# ------------------------------------------------------------ segment_reduce


@pytest.mark.parametrize("V,E,block", [(64, 512, 128), (300, 2048, 512), (1000, 4096, 256)])
@pytest.mark.parametrize("op", ["min", "sum"])
def test_segment_reduce_sweep_matches_reference(V, E, block, op):
    """The shapes of `tests/test_kernels.py::test_segment_reduce_sweep`."""
    lsrc, ldst, w, val = _segment_inputs(V, E, V + E)
    ref, got = _both(op, lsrc, ldst, w, val, V + 1, block_e=block)
    _assert_segment(op, got, ref)


@pytest.mark.parametrize("op", ["min", "sum"])
def test_segment_reduce_hub_heavy_matches_reference(op):
    """Power-law pattern: one hub destination owns 90% of the edges."""
    rng = np.random.default_rng(7)
    V, E = 128, 1024
    ldst = np.sort(np.where(rng.random(E) < 0.9, 7, rng.integers(0, V, E))).astype(np.int32)
    lsrc = rng.integers(0, V, E).astype(np.int32)
    w = rng.random(E).astype(np.float32)
    val = (rng.random(V + 1) * 5).astype(np.float32)
    ref, got = _both(op, lsrc, ldst, w, val, V + 1, block_e=256)
    _assert_segment(op, got, ref)


def test_segment_max_negative_values_matches_reference():
    """max runs on the min kernel through negation; values of both signs,
    real edges weight 0, pads INF, and val longer than num_out."""
    rng = np.random.default_rng(11)
    V, E, num_out = 200, 900, 150
    ldst = np.sort(rng.integers(0, num_out - 1, E)).astype(np.int32)
    lsrc = rng.integers(0, V, E).astype(np.int32)
    w = np.zeros(E, np.float32)
    w[-40:] = np.float32(3.0e38)
    ldst[-40:] = num_out - 1
    val = (rng.random(V) * 20 - 15).astype(np.float32)
    ref, got = _both("max", lsrc, ldst, w, val, num_out, block_e=128)
    assert (got < 0).any() and (got > 0).any()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("op", ["min", "max", "sum"])
def test_segment_entries_take_any_length(op):
    """E = 777 is no multiple of block_e: the entry takes the stream as it
    is (nothing is padded) and gives the reference's result."""
    V, E, block = 90, 777, 256
    lsrc, ldst, w, val = _segment_inputs(V, E, 5)
    if op == "max":
        w[:] = 0.0
        val = -val
    ref, got = _both(op, lsrc, ldst, w, val, V + 1, block_e=block)
    _assert_segment(op, got, ref)


def test_segment_reduce_checks_its_arguments():
    lsrc, ldst, w, val = (_t(a) for a in _segment_inputs(10, 20, 0))
    with pytest.raises(ValueError, match="op must be"):
        pt_seg.segment_reduce(lsrc, ldst, w, val, num_out=11, op="max")
    with pytest.raises(ValueError, match="num_out"):
        pt_seg.segment_reduce(lsrc, ldst, w, val, num_out=12)
    with pytest.raises(TypeError, match="ldst"):
        pt_seg.segment_reduce(lsrc, ldst.long(), w, val, num_out=11)


@pytest.mark.parametrize("name,bad", [("lsrc", 11), ("lsrc", -1), ("ldst", 11), ("ldst", -2)])
def test_segment_reduce_rejects_out_of_range_ids(name, bad):
    """An id outside val (lsrc) or outside the output (ldst) is refused
    before any kernel could read or write through it."""
    args = dict(zip(("lsrc", "ldst", "w", "val"), (_t(a) for a in _segment_inputs(10, 20, 0))))
    args[name][3] = bad
    with pytest.raises(ValueError, match=f"{name} has ids"):
        pt_ops.segment_min_plus(args["lsrc"], args["ldst"], args["w"], args["val"], num_out=11)


# ------------------------------------------------------------ ebg_membership


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("p,V,E", [(4, 256, 512), (16, 1024, 1024), (32, 4096, 2048)])
def test_ebg_membership_matches_reference(p, V, E, impl):
    """The shapes of `tests/test_kernels.py::test_ebg_membership_sweep`; one
    uint32 bitset carried into both packages."""
    rng = np.random.default_rng(p * V)
    keep = rng.random((p, V)) < 0.25
    kb = ref_ops.pack_keep_bits(jnp.array(keep))
    u = rng.integers(0, V, E).astype(np.int32)
    v = rng.integers(0, V, E).astype(np.int32)
    kw = dict(interpret=True, block_e=256) if impl == "pallas" else {}
    ref = np.asarray(ref_ops.ebg_membership(kb, jnp.array(u), jnp.array(v), impl=impl, **kw))
    port_bits = interop.keep_bits_from_numpy(np.asarray(kb), device="cpu")
    torch.testing.assert_close(port_bits, pt_ops.pack_keep_bits(torch.from_numpy(keep)),
                               rtol=0, atol=0)
    got = pt_ops.ebg_membership(port_bits, _t(u), _t(v))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_keep_bits_round_trip_is_exact():
    """uint32 words with the top bit set, all ones and zero survive both ways."""
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2**32, (7, 33), dtype=np.uint64).astype(np.uint32)
    bits[0, :3] = (0, 2**31, 2**32 - 1)
    port = interop.keep_bits_from_numpy(bits, device="cpu")
    assert port.dtype == torch.int32
    back = interop.keep_bits_to_numpy(port)
    assert back.dtype == np.uint32
    np.testing.assert_array_equal(back, bits)
    ids = torch.arange(33 * 32, dtype=torch.int32)
    memb = pt_memb.ebg_membership_plain(port, ids, ids)
    expect = 2.0 * (1 - ((bits[:, ids.numpy() >> 5] >> (ids.numpy() & 31)) & 1))
    np.testing.assert_array_equal(memb.numpy(), expect.astype(np.float32))


@pytest.mark.parametrize("name,bad", [("u", 64), ("u", -1), ("v", 1000)])
def test_ebg_membership_rejects_out_of_range_ids(name, bad):
    """Ids past the bitset's 32·Vw vertices are refused, not gathered."""
    bits = torch.zeros((3, 2), dtype=torch.int32)
    ends = {"u": torch.arange(8, dtype=torch.int32), "v": torch.arange(8, dtype=torch.int32)}
    ends[name][5] = bad
    with pytest.raises(ValueError, match=f"{name} has ids"):
        pt_ops.ebg_membership(bits, ends["u"], ends["v"])


# ---------------------------------------------------------- decode_attention

DECODE_SHAPES = [(2, 8, 4, 64, 512, 256), (1, 4, 4, 32, 1024, 512), (3, 12, 2, 64, 512, 128)]
# (rtol, atol). bf16: one bf16 rounding of the output (a one-ulp
# disagreement is at most 2^-7 of the value) plus an f32-level atol for
# values near zero; a 1 % error must fail it, and `_decode_both` checks so.
DTYPES = {"float32": (jnp.float32, torch.float32, (2e-5, 2e-5)),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, (2**-7, 1e-5))}


def _decode_both(B, Hq, Hkv, D, S, block, dtype, impl, softcap, seed):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrs = [jnp.array(rng.standard_normal(s).astype(np.float32), jdt)
            for s in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]
    kw = dict(interpret=True, block_s=block) if impl == "pallas" else {}
    ref = ref_ops.decode_attention(*arrs, impl=impl, softcap=softcap, **kw)
    port = [_t(a.astype(jnp.float32)).to(tdt) for a in arrs]
    got = pt_ops.decode_attention(*port, softcap=softcap, block_s=block)
    assert got.dtype == tdt and tuple(got.shape) == (B, Hq, D)
    rtol, atol = tol
    want = _t(np.asarray(ref, np.float32))
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)
    # The control: the same output off by 1 % must fail the limit.
    assert not torch.allclose(got.float() * 1.01, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,Hq,Hkv,D,S,block", DECODE_SHAPES)
def test_decode_attention_matches_reference(B, Hq, Hkv, D, S, block, dtype, impl):
    """The shapes of `tests/test_kernels.py::test_decode_attention_sweep`."""
    _decode_both(B, Hq, Hkv, D, S, block, dtype, impl, 0.0, B * S)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_attention_softcap_matches_reference(dtype, impl):
    _decode_both(2, 8, 4, 64, 512, 256, dtype, impl, 30.0, 0)


def test_decode_attention_checks_its_arguments():
    q = torch.zeros((1, 6, 32))
    k = torch.zeros((1, 16, 4, 32))
    with pytest.raises(ValueError, match="Hq % Hkv"):
        pt_attn.decode_attention(q, k, k)
    with pytest.raises(TypeError, match="f32 or bf16"):
        pt_attn.decode_attention(q.half(), k.half(), k.half())


# ------------------------------------------------------------ the import rule


def test_repro_torch_loads_neither_jax_nor_reference():
    """Importing every module of the port, in a fresh interpreter, loads no
    module of jax or of the reference package."""
    src = Path(__file__).resolve().parents[1] / "src"
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(src))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert int(run.stdout.split()[0]) >= 20  # every module was imported


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("D", [16, 112])
def test_decode_attention_other_head_dims_match_reference(D, dtype, impl):
    """Head dims outside the CUDA kernel's built widths (16: the reduced
    model configs'; 112: kimi_k2's), which the card runs zero-padded."""
    _decode_both(2, 8, 2, D, 384, 128, dtype, impl, 0.0, D)
    _decode_both(1, 4, 4, D, 256, 128, dtype, impl, 30.0, D + 1)
