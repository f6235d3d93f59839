"""Deterministic synthetic token pipeline (port of `repro.data.pipeline`).

A reproducible, shardable stream of (tokens, targets) with a zipf-ish
unigram distribution and a little n-gram structure, so that the LM loss
falls in the example runs. Each global step's batch is a pure function of
(seed, step), so every data-parallel host materializes its own shard
without coordination and restarts at any step: the pipeline has no state
to checkpoint beyond the step counter.

The port draws the reference's random bits. `jax.random` is counter-based
(threefry2x32, 20 rounds); under JAX's partitionable threefry (the default
of the JAX the reference runs on) a key (k0, k1) gives element n of a draw
the two words threefry2x32((k0, k1), (n >> 32, n & 0xffffffff)), XORed for
32 random bits; `split` and `fold_in` hash the counts (0, i) and (0, data)
the same way. The port computes threefry2x32 in int64 PyTorch ops masked
to 32 bits, on the device it is asked for, and turns bits into floats as
`jax.random.uniform` does (the mantissa's 23 bits under exponent 0, minus
one, scaled and shifted with one rounding, as XLA's fused multiply-add
does, then at least minval), so the uniform draws and the Bernoulli mask
are the reference's bit for bit.

The ids are floor(vocab · u³). XLA's f32 `pow` on the CPU is not
correctly rounded; the port takes u³ in f64 and rounds it to f32 once,
which gives the reference's ids but for a few that land one apart at a
floor boundary (over 256 × 4,097 draws: none at vocab 2,048, one at
32,064, two at 128,256); `tests/test_torch_data_pipeline.py` counts them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.dispatch import resolve_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(key, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) of the count words x0, x1 (int64 tensors
    holding uint32 values) under key = (k0, k1), Python ints: the two
    output words, int64 tensors of uint32 values."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _hash_counts(key, n: int, device):
    """The words of counts 0..n-1 (hi, lo) under `key`."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return threefry2x32(key, idx >> 32, idx & _MASK)


def prng_key(seed: int) -> tuple:
    """`jax.random.PRNGKey(seed)` with 64-bit types off (the reference's
    setting): the seed's low 32 bits, under a zero high word."""
    return (0, seed & _MASK)


def fold_in(key, data: int) -> tuple:
    """`jax.random.fold_in(key, data)`: the hash of the count (0, data)."""
    one = torch.tensor([0], dtype=torch.int64)
    y0, y1 = threefry2x32(key, one, one + (data & _MASK))
    return int(y0), int(y1)


def split(key, num: int = 2) -> list:
    """`jax.random.split(key, num)`: key i is the hash of the count (0, i)."""
    y0, y1 = _hash_counts(key, num, "cpu")
    return [(int(a), int(b)) for a, b in zip(y0.tolist(), y1.tolist())]


def random_bits(key, shape, device) -> torch.Tensor:
    """32 random bits an element (int64 tensor of uint32 values): the XOR
    of the two words of the element's flat index."""
    n = 1
    for s in shape:
        n *= s
    y0, y1 = _hash_counts(key, n, device)
    return (y0 ^ y1).reshape(shape)


def uniform(key, shape, *, minval: float = 0.0, maxval: float = 1.0,
            device="cpu") -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`."""
    bits = random_bits(key, shape, device)
    one = 0x3F800000  # the bits of 1.0f
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    # XLA fuses floats·(hi - lo) + lo into one FMA. A float is a multiple of
    # 2^-23 below 1 and the f32 factor has 24 bits, so the f64 product and,
    # for these bounds, the f64 sum are exact: one rounding to f32, as the
    # FMA rounds.
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def bernoulli(key, p: float, shape, device="cpu") -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)`: uniform draws below f32(p)."""
    return uniform(key, shape, device=device) < torch.tensor(p, dtype=torch.float32,
                                                             device=device)


def _draws(cfg: DataConfig, step: int, shard: int, num_shards: int, device):
    """(u [b, seq_len + 1] f32, rep [b, seq_len + 1] bool): the shard's
    uniform draws and n-gram mask."""
    if cfg.global_batch % num_shards:
        raise ValueError(f"global_batch {cfg.global_batch} does not split into {num_shards} "
                         f"shards")
    b = cfg.global_batch // num_shards
    key = fold_in(fold_in(prng_key(cfg.seed), step), shard)
    k1, k2 = split(key)
    shape = (b, cfg.seq_len + 1)
    u = uniform(k1, shape, minval=1e-6, maxval=1.0, device=device)
    return u, bernoulli(k2, 0.3, shape, device=device)


def batch_at_step(cfg: DataConfig, step: int, *, device=None) -> dict:
    """The full global batch of `step` (tests, one host)."""
    return shard_batch_at_step(cfg, step, 0, 1, device=device)


def shard_batch_at_step(cfg: DataConfig, step: int, shard: int, num_shards: int, *,
                        device=None) -> dict:
    """This host's slice of the global batch, a pure function of the
    inputs: tokens and targets, int64 [b, seq_len], on `device` (the CUDA
    card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    u, rep = _draws(cfg, step, shard, num_shards, dev)
    # zipf-ish unigram: u³ in f64, rounded to f32 once (module docstring).
    ids = torch.floor(cfg.vocab * (u.double() ** 3).float()).to(torch.int64)
    # n-gram structure: a token repeats its predecessor + 1 where rep holds.
    shifted = torch.roll(ids, 1, dims=1) + 1
    ids = torch.where(rep, torch.clamp(shifted, 0, cfg.vocab - 1), ids)
    return dict(tokens=ids[:, :-1], targets=ids[:, 1:])
