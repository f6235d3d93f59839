"""Padded-batch policy of the serving tier (port of `repro.serve.padding`).

A ragged request batch is padded up to the smallest member of a fixed
bucket ladder before it reaches a captured executable, so the number of
distinct captured shapes stays bounded: steady-state traffic hits a warm
executable (a CUDA graph on the card) for its (program, bucket) key
instead of capturing per batch size. The graph-query server
(`repro_torch.serve.server`) uses it; the reference's LM serving loop
shares the same ladder, rounding and waste accounting.
"""
from __future__ import annotations

import numpy as np

# Powers of two: each bucket at most doubles the work of the batch it
# rounds up, so padding waste is bounded at 50% while the executable
# count stays logarithmic in the largest batch.
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def bucket_size(n: int, buckets=DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n — the padded batch size for a batch of n.

    >>> bucket_size(1)
    1
    >>> bucket_size(2)
    2
    >>> bucket_size(3)
    4
    >>> bucket_size(4)
    4
    >>> bucket_size(5)
    8
    >>> bucket_size(8)
    8
    >>> bucket_size(9)
    16
    >>> bucket_size(64)
    64
    >>> bucket_size(6, buckets=(2, 8))
    8
    >>> bucket_size(0)
    Traceback (most recent call last):
        ...
    ValueError: batch size must be >= 1, got 0
    >>> bucket_size(65)
    Traceback (most recent call last):
        ...
    ValueError: batch of 65 exceeds the largest bucket 64
    """
    if n < 1:
        raise ValueError(f"batch size must be >= 1, got {n}")
    for b in sorted(buckets):
        if n <= b:
            return int(b)
    raise ValueError(f"batch of {n} exceeds the largest bucket {max(buckets)}")


def padding_waste(n: int, bucket: int) -> float:
    """Fraction of the padded batch that is padding.

    >>> padding_waste(3, 4)
    0.25
    >>> padding_waste(8, 8)
    0.0
    """
    if not 1 <= n <= bucket:
        raise ValueError(f"need 1 <= n <= bucket, got n={n}, bucket={bucket}")
    return float(bucket - n) / float(bucket)


def pad_items(items: list, bucket: int) -> list:
    """Pad a request list to its bucket by repeating the last item.

    The repeats are discarded after execution; repeating a REAL request
    (instead of a sentinel) keeps padded lanes on the same convergence
    trajectory as a live lane, so they never become the batch straggler.

    >>> pad_items([10, 11, 12], 4)
    [10, 11, 12, 12]
    >>> pad_items([7], 1)
    [7]
    """
    if not 1 <= len(items) <= bucket:
        raise ValueError(f"need 1 <= len(items) <= bucket, got {len(items)}, bucket={bucket}")
    return list(items) + [items[-1]] * (bucket - len(items))


def pad_batch_rows(x: np.ndarray, bucket: int) -> np.ndarray:
    """Pad a [B, ...] array to [bucket, ...] by repeating the last row
    (the array view of `pad_items`, as the LM serving loop pads prompts).

    >>> pad_batch_rows(np.array([[1, 2], [3, 4]]), 4).tolist()
    [[1, 2], [3, 4], [3, 4], [3, 4]]
    >>> pad_batch_rows(np.array([[1, 2]]), 1).tolist()
    [[1, 2]]
    """
    x = np.asarray(x)
    if not 1 <= x.shape[0] <= bucket:
        raise ValueError(f"need 1 <= rows <= bucket, got {x.shape[0]}, bucket={bucket}")
    if x.shape[0] == bucket:
        return x
    return np.concatenate([x, np.repeat(x[-1:], bucket - x.shape[0], axis=0)], axis=0)
