"""Fault-tolerant checkpointing (port of `repro.checkpoint.ckpt`): one file
a leaf, an atomic manifest, latest-step discovery, an async save thread.

Layout:  <dir>/step_000123/
            manifest.json   {step, leaves: [{path, shape, dtype, file, codec}]}
            L00000.bin.zst  raw little-endian bytes per leaf (zstd), or
            L00000.bin      uncompressed when zstandard is not installed
A checkpoint only "exists" once its directory is renamed into place from
`.tmp_step_*`, so a killed writer never corrupts a restart.

The layout, the leaf path keys and the bytes are the reference's, so
either package restores the other's checkpoints. Trees are nested
`dict` / `list` / `tuple` containers of torch tensors, numpy arrays or
scalars; a leaf's key is its path joined with "|" (dict keys in sorted
order, sequence positions as integers), as the reference's
`tree_flatten_with_path` spells it. `None` is an empty subtree.

`zstandard` is optional: without it, saves write uncompressed leaves and
a restore of a compressed leaf raises with an install hint.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

try:  # optional dep — degrade to uncompressed leaves when absent
    import zstandard
except ModuleNotFoundError:
    zstandard = None

_KEY_SEP = "|"


def _flatten_with_paths(tree) -> list:
    """[(key, leaf)] in the reference's order: dict keys sorted, sequences
    in order, depth first."""
    out = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], (*path, k))
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(child, (*path, i))
        else:
            out.append((_KEY_SEP.join(str(k) for k in path), node))

    walk(tree, ())
    return out


def _unflatten(tree, leaves):
    """`tree` with its leaves replaced, in `_flatten_with_paths` order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            seq = [build(child) for child in node]
            return seq if isinstance(node, list) else type(node)(seq)
        return next(it)

    return build(tree)


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host numpy array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str | Path, step: int, tree) -> Path:
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    cctx = zstandard.ZstdCompressor(level=3) if zstandard is not None else None
    manifest = {"step": step, "leaves": []}
    for i, (key, leaf) in enumerate(_flatten_with_paths(tree)):
        arr = _to_host(leaf)
        payload = np.ascontiguousarray(arr).tobytes()
        if cctx is None:
            fn, codec = f"L{i:05d}.bin", "raw"
        else:
            fn, codec = f"L{i:05d}.bin.zst", "zstd"
            payload = cctx.compress(payload)
        (tmp / fn).write_bytes(payload)
        manifest["leaves"].append(
            dict(path=key, shape=list(arr.shape), dtype=str(arr.dtype), file=fn, codec=codec)
        )
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic publish
    return final


def latest_step(ckpt_dir: str | Path) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for p in ckpt_dir.iterdir():
        if p.name.startswith("step_") and (p / "manifest.json").exists():
            steps.append(int(p.name.split("_")[1]))
    return max(steps) if steps else None


def _leaf_from_bytes(raw: bytes, m: dict, like):
    """A restored leaf: a tensor on `like`'s device (in `like`'s dtype) when
    `like` is a tensor, else the numpy array as stored."""
    arr = np.frombuffer(raw, dtype=np.dtype(m["dtype"])).reshape(m["shape"]).copy()
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)
    return arr


def restore(ckpt_dir: str | Path, step: int, like_tree):
    """Restore into the structure of `like_tree`: tensor leaves come back as
    tensors on their device and in their dtype, other leaves as numpy."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    dctx = zstandard.ZstdDecompressor() if zstandard is not None else None
    by_path = {m["path"]: m for m in manifest["leaves"]}
    out = []
    for key, like in _flatten_with_paths(like_tree):
        m = by_path[key]
        raw = (d / m["file"]).read_bytes()
        # Pre-codec manifests only ever wrote zstd leaves.
        codec = m.get("codec", "zstd")
        if codec == "zstd":
            if dctx is None:
                raise ModuleNotFoundError(
                    f"checkpoint leaf {m['file']} is zstd-compressed but 'zstandard' "
                    "is not installed (pip install zstandard, or the 'ckpt' extra)"
                )
            raw = dctx.decompress(raw)
        elif codec != "raw":
            raise ValueError(f"unknown checkpoint codec {codec!r} for leaf {m['file']}")
        out.append(_leaf_from_bytes(raw, m, like))
    return _unflatten(like_tree, out)


def _snapshot(tree):
    """A host copy of every leaf, taken before a save thread starts: device
    tensors are copied off the card (`.cpu()`), host tensors cloned."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu() if x.device.type != "cpu" else x.detach().clone()
        return np.array(x, copy=True)

    return _unflatten(tree, [leaf(x) for _, x in _flatten_with_paths(tree)])


class AsyncCheckpointer:
    """Overlaps checkpoint I/O with the next step.

    A failure on the writer thread (disk full, bad path, permission)
    is captured and re-raised on the NEXT `save()` or on `wait()` —
    a failed checkpoint must never be silently treated as durable, or
    a later crash would "resume" from a snapshot that does not exist.
    """

    def __init__(self, ckpt_dir: str | Path):
        self.ckpt_dir = Path(ckpt_dir)
        self._thread: threading.Thread | None = None
        self._exc: BaseException | None = None

    def _save_guarded(self, step: int, tree):
        try:
            save(self.ckpt_dir, step, tree)
        except BaseException as e:  # captured; re-raised on wait()/next save()
            self._exc = e

    def save(self, step: int, tree):
        self.wait()
        host_tree = _snapshot(tree)  # the values as they are now, on the host
        self._thread = threading.Thread(target=self._save_guarded, args=(step, host_tree))
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise RuntimeError(
                f"async checkpoint save to {self.ckpt_dir} failed"
            ) from exc
