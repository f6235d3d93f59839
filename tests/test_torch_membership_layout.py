"""The commit kernel's bitset layouts on the CPU: the plain transposes
between the public packed bitset `keep_bits` [p, ⌈V/32⌉] and the CUDA
path's vertex-major `memb` [32·⌈V/32⌉, ⌈p/32⌉] against a numpy bit loop,
their round trips, a numpy model of `csrc/memb_transpose.cuh`'s tiles
(swizzled shared memory, the five-round butterfly) against them, the
wrappers' CPU dispatch and argument checks, and the split rules of
`decode_attention`'s split-S kernels (`decode_attn.cu`, and
`decode_attn_wide.cu`'s splits, stages and workspace). Exact; torch and
numpy only."""
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


def _butterfly(words: np.ndarray) -> np.ndarray:
    """`transpose32` over a warp's 32 lanes: round j trades, with lane ^ j,
    the j-bit halves of each 2j-bit group under mask 0xFFFFFFFF / (2^j + 1)."""
    a = words.astype(np.uint64)
    lanes = np.arange(32)
    for j in (16, 8, 4, 2, 1):
        m = np.uint64(0xFFFFFFFF // ((1 << j) + 1))
        nm = np.uint64(0xFFFFFFFF) ^ m
        b = a[lanes ^ j]
        hi = (a & nm) | ((b >> np.uint64(j)) & m)
        lo = (a & m) | ((b << np.uint64(j)) & nm)
        a = np.where(lanes & j, hi, lo) & np.uint64(0xFFFFFFFF)
    return a.astype(np.uint32)


def _tile_model(src: np.ndarray, p: int, vw: int, to_memb: bool) -> np.ndarray:
    """csrc/memb_transpose.cuh's kernel, tile by tile, in numpy: WT memb
    words × T = 256 / WT vertex words a CTA; the keep tile holds word c of
    part row r at c ^ (r mod 32), the memb tile word w of vertex row x at
    w ^ (x mod 32)·WT/32; a warp reads one 32x32 block of either a word a
    lane, transposes it by the butterfly and writes it back in the other
    layout; parts >= p read 0 and are not written."""
    W = (p + 31) // 32
    WT = 1 if W == 1 else 2 if W == 2 else 4 if W <= 4 else 8
    T = 256 // WT
    dst = np.full((32 * vw, W) if to_memb else (p, vw), 0xDEADBEEF, np.uint32)
    lanes = np.arange(32)
    for c0 in range(0, vw, T):
        for w0 in range(0, W, WT):
            ncols, nw, prows = min(T, vw - c0), min(WT, W - w0), p - 32 * w0
            s = np.zeros(8192, np.uint32)
            r, c = np.divmod(np.arange(8192), T)        # keep tile: part row, vertex word
            row, col = np.divmod(np.arange(8192), WT)   # memb tile: vertex row, memb word
            keep_at = r * T + (c ^ (r & 31))
            memb_at = row * WT + (col ^ ((row & 31) // (32 // WT)))
            if to_memb:
                ok = (r < prows) & (c < ncols)
                s[keep_at[ok]] = src[32 * w0 + r[ok], c0 + c[ok]]
            else:
                ok = (row < 32 * ncols) & (col < nw)
                s[memb_at[ok]] = src[32 * c0 + row[ok], w0 + col[ok]]
            out = {}
            for b in range(256):
                wi, cb = divmod(b, T)
                if to_memb:
                    out[b] = _butterfly(s[(32 * wi + lanes) * T + (cb ^ lanes)])
                else:
                    out[b] = _butterfly(s[(32 * cb + lanes) * WT + (wi ^ (lanes // (32 // WT)))])
            for b in range(256):
                wi, cb = divmod(b, T)
                if to_memb:
                    s[(32 * cb + lanes) * WT + (wi ^ (lanes // (32 // WT)))] = out[b]
                else:
                    s[(32 * wi + lanes) * T + (cb ^ lanes)] = out[b]
            if to_memb:
                ok = (row < 32 * ncols) & (col < nw)
                dst[32 * c0 + row[ok], w0 + col[ok]] = s[memb_at[ok]]
            else:
                ok = (r < prows) & (c < ncols)
                dst[32 * w0 + r[ok], c0 + c[ok]] = s[keep_at[ok]]
    return dst


def test_butterfly_transposes_a_block():
    """Lane x of the butterfly's result holds bit x of every lane's word."""
    words = np.random.default_rng(3).integers(0, 2**32, 32, dtype=np.uint64).astype(np.uint32)
    got = _butterfly(words)
    bits = (words[:, None] >> np.arange(32, dtype=np.uint32)) & 1  # [lane i, bit x]
    want = (bits.T.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(1)
    np.testing.assert_array_equal(got, want.astype(np.uint32))


@pytest.mark.parametrize("p", [1, 31, 33, 64, 100, 300])
@pytest.mark.parametrize("V", [1, 1000, 9000])
def test_transpose_tile_model_matches_plain(p, V):
    """The kernel's tiles, swizzles and butterfly (modelled in numpy) give
    the plain transposes bit for bit, with ragged words, parts and W."""
    keep = _keep(p, V, seed=7 * p + V)
    vw = keep.shape[1]
    memb = _tile_model(keep.numpy().view(np.uint32), p, vw, True)
    np.testing.assert_array_equal(memb,
                                  pt_ebg.keep_bits_to_memb_plain(keep).numpy().view(np.uint32))
    rand = _keep(32 * vw, 32 * ((p + 31) // 32), seed=V)
    np.testing.assert_array_equal(
        _tile_model(rand.numpy().view(np.uint32), p, vw, False),
        pt_ebg.memb_to_keep_bits_plain(rand, p).numpy().view(np.uint32))


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


def test_decode_padded_widths_reach_512():
    """The CUDA kernels' routing: any head_dim 1-512 runs on the least built
    width of `decode_attn.cu` at or above it (rows of 2 KB, f32 at 512, in
    tiles of 16 keys); above 512 it runs on `decode_attn_wide.cu`, so no
    head_dim is refused (the split-S builds' width rule names the wide
    source past its last width)."""
    assert pt_attn.HEAD_DIMS[-1] == 512
    for D, want in ((1, 32), (256, 256), (257, 512), (320, 512), (384, 512), (512, 512)):
        assert pt_attn.padded_dim(D) == want
        assert pt_attn.kernel_source(D) == "decode_attn"
    for D in (513, 640, 1024, 4096):
        assert pt_attn.kernel_source(D) == "decode_attn_wide"
    assert pt_attn.tile_keys(512, torch.bfloat16) == 32
    assert pt_attn.tile_keys(300, torch.float32) == 16
    assert pt_attn.tile_keys(256, torch.float32) == 32
    with pytest.raises(ValueError, match="head_dim up to 512, got 513; wider rows run on "
                                         "decode_attn_wide.cu"):
        pt_attn.padded_dim(513)


@pytest.mark.parametrize("B,S,Hkv,G", [(2, 2048, 2, 4), (1, 1, 2, 8), (1, 31, 2, 1),
                                       (1, 20_001, 2, 4), (8, 32_768, 8, 4), (1, 10**6, 1, 16),
                                       (64, 4096, 8, 3)])
def test_decode_wide_split_count(B, S, Hkv, G):
    """decode_attn_wide.cu's splits: whole tiles of WIDE_TILE_KEYS, no empty
    split, at most WIDE_MAX_TILES tiles a split (its scores fit in shared
    memory) however long the range, about a CTA an SM where the keys allow,
    and the kernel's re-derivation (the last split takes what is left) gives
    the count back. The bench shape splits 4 rows into 32 of 64 keys."""
    sms = 132
    nsplit = pt_attn.wide_split_count(B, S, Hkv, G, sms)
    tiles = -(-S // pt_attn.WIDE_TILE_KEYS)
    per = -(-tiles // nsplit)
    assert 1 <= nsplit <= tiles
    assert per <= pt_attn.WIDE_MAX_TILES
    assert (nsplit - 1) * per < tiles
    assert -(-tiles // per) == nsplit
    rows = B * Hkv * -(-G // pt_attn.group_rows(G))
    if tiles >= -(-sms // rows):
        assert rows * nsplit >= sms * pt_attn.WIDE_WAVE_CTAS - rows * (per - 1)
    if (B, S, Hkv, G) == (2, 2048, 2, 4):
        assert (rows, nsplit, per * pt_attn.WIDE_TILE_KEYS) == (4, 32, 64)
    if S == 20_001:
        assert tiles % per  # the last split is short


def test_decode_wide_stages_and_workspace():
    """The ring's stages from an H100's 227 KB a block (the kernel reads the
    card's): 6 stages of 33 KB at up to 4 query rows a CTA, 5 at 8; none
    below two; the workspace holds each split's unnormalised row and (m, l)
    for every query head, and nothing for one split."""
    assert pt_attn.WIDE_STAGE_BYTES == 16 * (2048 + 16)
    for dtype in (torch.bfloat16, torch.float32):
        assert [pt_attn.wide_stages(G, dtype) for G in (1, 2, 3, 4, 5, 8)] == [6, 6, 6, 6, 5, 5]
        assert pt_attn.wide_stages(4, dtype, optin=48 * 1024) == 0
        assert pt_attn.wide_stages(1, dtype, optin=100 * 1024) == 2
    assert [pt_attn.group_rows(G) for G in (1, 2, 3, 4, 5, 8, 16)] == [1, 2, 4, 4, 8, 8, 8]
    assert pt_attn.wide_workspace_floats(2, 2, 4, 1024, 32) == 2 * 8 * 32 * 1026
    assert pt_attn.wide_workspace_floats(2, 2, 4, 1024, 1) == 0
    assert pt_attn.wide_workspace_floats(1, 3, 5, 513, 7) == 15 * 7 * 515
