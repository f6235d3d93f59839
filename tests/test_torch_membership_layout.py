"""The commit kernel's bitset layouts on the CPU: the plain transposes
between the public packed bitset `keep_bits` [p, ⌈V/32⌉] and the CUDA
path's vertex-major `memb` [32·⌈V/32⌉, ⌈p/32⌉] against a numpy bit loop,
their round trips, the wrappers' CPU dispatch and argument checks, and the
split rule of `decode_attention`'s split-S kernel. Exact; torch and numpy
only."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attn as pt_attn
from repro_torch.kernels import ebg_commit as pt_ebg

PARTS = [1, 31, 32, 33, 64]
VERTICES = [1, 33, 1000]


def _keep(p, V, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(-2**31, 2**31, (p, (V + 31) // 32), dtype=np.int64)
    return torch.from_numpy(words.astype(np.int32))


def _memb_by_bit_loop(keep: np.ndarray) -> np.ndarray:
    """memb[x, i // 32] bit i % 32 = bit x % 32 of keep[i, x // 32], part by part."""
    p, vw = keep.shape
    kb = keep.view(np.uint32).astype(np.uint64)
    x = np.arange(32 * vw)
    memb = np.zeros((32 * vw, (p + 31) // 32), np.uint64)
    for i in range(p):
        bit = (kb[i, x // 32] >> (x % 32).astype(np.uint64)) & 1
        memb[:, i // 32] |= bit << np.uint64(i % 32)
    return memb.astype(np.uint32)


@pytest.mark.parametrize("p", PARTS)
@pytest.mark.parametrize("V", VERTICES)
def test_keep_to_memb_matches_bit_loop(p, V):
    keep = _keep(p, V, seed=p * 1000 + V)
    memb = pt_ebg.keep_bits_to_memb_plain(keep)
    assert memb.dtype == torch.int32 and memb.shape == (32 * ((V + 31) // 32), (p + 31) // 32)
    np.testing.assert_array_equal(memb.numpy().view(np.uint32),
                                  _memb_by_bit_loop(keep.numpy()))


@pytest.mark.parametrize("p", PARTS)
@pytest.mark.parametrize("V", VERTICES)
def test_memb_transposes_round_trip(p, V):
    """keep -> memb -> keep is the identity; memb -> keep -> memb is too,
    once the bits of parts past p (which keep has no row for) are cleared."""
    keep = _keep(p, V, seed=p + V)
    assert torch.equal(pt_ebg.memb_to_keep_bits_plain(pt_ebg.keep_bits_to_memb_plain(keep), p),
                       keep)
    memb = _keep(32 * ((V + 31) // 32), 32 * ((p + 31) // 32), seed=V)  # any words
    back = pt_ebg.keep_bits_to_memb_plain(pt_ebg.memb_to_keep_bits_plain(memb, p))
    live = [(1 << min(32, p - 32 * w)) - 1 for w in range((p + 31) // 32)]  # parts < p
    mask = torch.tensor(np.array(live, np.uint64).astype(np.uint32).view(np.int32))
    assert torch.equal(back, memb & mask)


def test_transpose_wrappers_run_the_plain_version_on_the_cpu():
    keep = _keep(40, 300, seed=1)
    memb = pt_ebg.keep_bits_to_memb(keep)
    assert torch.equal(memb, pt_ebg.keep_bits_to_memb_plain(keep))
    out = torch.zeros_like(keep)
    got = pt_ebg.memb_to_keep_bits(memb, 40, out=out)
    assert got is out and torch.equal(out, keep)
    assert torch.equal(pt_ebg.memb_to_keep_bits(memb, 40), keep)


def test_transpose_wrappers_check_their_arguments():
    keep = _keep(40, 300, seed=2)
    memb = pt_ebg.keep_bits_to_memb(keep)
    with pytest.raises(ValueError, match="must be"):
        pt_ebg.keep_bits_to_memb(keep[0])
    with pytest.raises(TypeError):
        pt_ebg.keep_bits_to_memb(keep.long())
    with pytest.raises(ValueError, match="memb of 70 parts"):
        pt_ebg.memb_to_keep_bits(memb, 70)
    with pytest.raises(ValueError, match="memb of 40 parts"):
        pt_ebg.memb_to_keep_bits(memb[:-1], 40)
    with pytest.raises(ValueError, match="must have shape"):
        pt_ebg.memb_to_keep_bits(memb, 40, out=keep[:, :-1])


@pytest.mark.parametrize("B,S,Hkv,G", [(8, 32_768, 16, 2), (1, 32_768, 16, 2), (3, 1, 2, 8),
                                       (1, 31, 2, 1), (3, 20_001, 2, 4), (2, 10**6, 1, 16)])
@pytest.mark.parametrize("D,dtype", [(128, torch.bfloat16), (256, torch.float32)])
def test_decode_split_count(B, S, Hkv, G, D, dtype):
    """Whole tiles a split, no empty split, at most MAX_SPLITS, splits of at
    most SPLIT_KEYS keys unless that cap binds, and the kernel's own
    re-derivation of the split count (whole tiles, the last split takes what
    is left) gives it back."""
    tile = pt_attn.tile_keys(D, dtype)
    assert tile == (64 if D * torch.finfo(dtype).bits // 8 < 512 else 32)
    nsplit = pt_attn.split_count(B, S, Hkv, G, sms=132, tile=tile)
    tiles = -(-S // tile)
    per = -(-tiles // nsplit)
    assert 1 <= nsplit <= min(tiles, pt_attn.MAX_SPLITS)
    assert (nsplit - 1) * per < tiles
    assert -(-tiles // per) == nsplit
    if -(-S // pt_attn.SPLIT_KEYS) <= pt_attn.MAX_SPLITS:
        assert per * tile <= max(pt_attn.SPLIT_KEYS, tile)
