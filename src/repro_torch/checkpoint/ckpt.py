"""Atomic checkpoints in the reference's on-disk layout.

Port of ``repro.checkpoint.ckpt``: ``<dir>/step_<N:08d>/`` holds one
``leaf_<i:05d>.npy`` per leaf of the state's dict tree, in sorted-key
order, plus ``META.json`` (``step``, a ``manifest`` of key / file /
dtype / shape per leaf with keys the ``/``-joined dict paths, and
``extra``).  Writes go to ``step_<N>.tmp/`` and are renamed into place
after every leaf and the metadata are written and ``META.json`` is
fsync'd, so :func:`latest_step` only ever sees complete directories.
A checkpoint written by either package restores in the other.

bfloat16 leaves: numpy has no bfloat16.  The JAX package saves them
through ``ml_dtypes``, whose ``.npy`` header reads ``'<V2'`` (raw
2-byte words, manifest dtype ``bfloat16``); :func:`restore` reads those
words back bit for bit.  The port writes bfloat16 leaves as float32
arrays (exact: every bfloat16 is a float32), which any numpy reads and
both packages cast back to the state's bfloat16 without rounding.
"""

from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

from repro_torch.models.params import _leaves


def _flatten_with_paths(tree):
    """``(key, leaf)`` pairs in sorted-key order, keys ``/``-joined."""
    return [("/".join(map(str, path)), leaf) for path, leaf in _leaves(tree)]


def _to_numpy(leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None) -> str:
    """Atomically write ``tree`` as step ``step``.  Returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = []
    for i, (key, leaf) in enumerate(_flatten_with_paths(tree)):
        arr = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest.append(
            {
                "key": key,
                "file": fname,
                "dtype": str(arr.dtype),
                "shape": list(arr.shape),
            }
        )
    meta = {"step": step, "manifest": manifest, "extra": extra or {}}
    with open(os.path.join(tmp, "META.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "META.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _to_tensor(arr: np.ndarray, entry: dict, like) -> torch.Tensor:
    if arr.dtype.kind == "V" and entry["dtype"] == "bfloat16":
        bits = torch.from_numpy(arr.view(np.int16).copy())
        t = bits.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t


def restore(ckpt_dir: str, tree_like, step: int | None = None):
    """Restore into the structure (dtypes, devices) of ``tree_like``.
    Returns ``(tree, meta_extra, step)``."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "META.json")) as f:
        meta = json.load(f)
    like = _flatten_with_paths(tree_like)
    manifest = meta["manifest"]
    if len(like) != len(manifest):
        raise ValueError(
            f"checkpoint has {len(manifest)} leaves, expected {len(like)}"
        )
    out: dict = {}
    for (key, leaf), entry in zip(like, manifest):
        if entry["key"] != key:
            raise ValueError(f"checkpoint leaf {entry['key']!r} != {key!r}")
        arr = np.load(os.path.join(path, entry["file"]))
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _to_tensor(arr, entry, leaf)
    return out, meta["extra"], step

