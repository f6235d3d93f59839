"""Port parity, the synthetic token pipeline: `repro_torch.data.pipeline`
against `repro.data.pipeline` and `jax.random` (partitionable threefry,
the JAX the reference runs on), on the CPU.

Held bit for bit: the keys (`PRNGKey`, `fold_in`, `split`), the uniform
draws and the Bernoulli mask of several (seed, step, shard, num_shards).
The token ids: equal but for a counted handful, each one apart. The ids
are floor(vocab · u³), and XLA's f32 `pow` on the CPU is not correctly
rounded where the port rounds the f64 cube once; over one batch of
256 × 4,097 draws (seed 0, step 0) the two land one id apart at 0, 1 and
2 positions at vocab 2,048, 32,064 and 128,256 (a changed id can carry to
the next position, which repeats its predecessor + 1).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as ref_pipeline
from repro_torch.data import pipeline

SEEDS = (0, 7, 123456789, -7, 2**31 + 3, 2**33 + 5)
CASES = list(itertools.product((0, 7), (0, 1, 5), ((0, 1), (1, 4), (3, 4))))
ID_DIFFS = {2048: 0, 32064: 1, 128256: 2}  # over 256 × 4,097 draws, seed 0, step 0


def _key(k):
    return tuple(int(w) for w in np.asarray(k).tolist())


def test_keys_match_jax_random():
    assert jax.config.jax_threefry_partitionable
    for seed in SEEDS:
        k = jax.random.PRNGKey(seed)
        assert _key(k) == pipeline.prng_key(seed)
        for data in (0, 1, 5, 77, 2**31 + 3):
            assert _key(jax.random.fold_in(k, data)) == pipeline.fold_in(pipeline.prng_key(seed),
                                                                         data)
        for num in (2, 3):
            want = [_key(x) for x in jax.random.split(k, num)]
            assert pipeline.split(pipeline.prng_key(seed), num) == want


@pytest.mark.parametrize("seed,step,shards", CASES)
def test_uniform_draws_and_mask_bit_for_bit(seed, step, shards):
    shard, num = shards
    cfg = pipeline.DataConfig(vocab=32064, seq_len=255, global_batch=8, seed=seed)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), step), shard)
    k1, k2 = jax.random.split(key)
    shape = (8 // num, 256)
    u = np.asarray(jax.random.uniform(k1, shape, minval=1e-6, maxval=1.0))
    rep = np.asarray(jax.random.bernoulli(k2, 0.3, shape))
    got_u, got_rep = pipeline._draws(cfg, step, shard, num, torch.device("cpu"))
    assert got_u.dtype == torch.float32 and got_rep.dtype == torch.bool
    assert np.array_equal(got_u.numpy().view(np.uint32), u.view(np.uint32))
    assert np.array_equal(got_rep.numpy(), rep)


@pytest.mark.parametrize("seed,step,shards", CASES)
def test_shard_batches_match_reference(seed, step, shards):
    """The batches the parity and launcher tests train on: tokens and
    targets equal the reference's (no id lands apart at these sizes)."""
    shard, num = shards
    for vocab in (2048, 32064):
        ref = ref_pipeline.shard_batch_at_step(
            ref_pipeline.DataConfig(vocab=vocab, seq_len=64, global_batch=8, seed=seed),
            step, shard, num)
        got = pipeline.shard_batch_at_step(
            pipeline.DataConfig(vocab=vocab, seq_len=64, global_batch=8, seed=seed), step,
            shard, num, device="cpu")
        for k in ("tokens", "targets"):
            assert got[k].dtype == torch.int64 and got[k].shape == (8 // num, 64)
            assert np.array_equal(got[k].numpy(), np.asarray(ref[k]))
        assert torch.equal(got["tokens"][:, 1:], got["targets"][:, :-1])


@pytest.mark.parametrize("vocab", list(ID_DIFFS))
def test_token_ids_differ_only_at_a_counted_handful(vocab):
    """256 × 4,097 draws: the ids equal the reference's but at ID_DIFFS
    positions, each one apart; the draws themselves are equal."""
    ref = ref_pipeline.batch_at_step(ref_pipeline.DataConfig(vocab, 4096, 256), 0)
    got = pipeline.batch_at_step(pipeline.DataConfig(vocab, 4096, 256), 0, device="cpu")

    def ids(b):
        return np.concatenate([np.asarray(b["tokens"]), np.asarray(b["targets"])[:, -1:]],
                              axis=1).astype(np.int64)

    want, have = ids(ref), ids({k: v.numpy() for k, v in got.items()})
    diff = np.abs(have - want)
    assert int((diff != 0).sum()) == ID_DIFFS[vocab]
    assert diff.max() <= 1
    assert have.min() >= 0 and have.max() < vocab


def test_pipeline_checks_its_shards_and_device(monkeypatch):
    cfg = pipeline.DataConfig(vocab=100, seq_len=8, global_batch=6)
    with pytest.raises(ValueError, match="does not split"):
        pipeline.shard_batch_at_step(cfg, 0, 0, 4, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.batch_at_step(cfg, 0)


def test_uniform_matches_jax_at_other_bounds():
    """`uniform` with the reference's default bounds and with others,
    bit for bit."""
    k = jax.random.PRNGKey(11)
    for lo, hi in ((0.0, 1.0), (1e-6, 1.0), (-2.0, 3.0)):
        want = np.asarray(jax.random.uniform(k, (4, 1000), jnp.float32, lo, hi))
        got = pipeline.uniform(pipeline.prng_key(11), (4, 1000), minval=lo, maxval=hi)
        assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32)), (lo, hi)
