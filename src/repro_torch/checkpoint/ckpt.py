"""Atomic checkpoints in the reference's on-disk layout.

Port of ``repro.checkpoint.ckpt``: ``<dir>/step_<N:08d>/`` holds one
``leaf_<i:05d>.npy`` per leaf of the state's dict tree, in sorted-key
order, plus ``META.json`` (``step``, a ``manifest`` of key / file /
dtype / shape per leaf with keys the ``/``-joined dict paths, and
``extra``).  Writes go to ``step_<N>.tmp/`` and are renamed into place
after every leaf and the metadata are written and ``META.json`` is
fsync'd, so :func:`latest_step` only ever sees complete directories.
A checkpoint written by either package restores in the other.

On a ``torch.distributed`` world every rank holds the whole state, so
:func:`save` writes from rank 0 alone and the others wait at a barrier
until the rename is done: no rank restores from, or lists, a half-written
step.  :func:`restore_resharded` restores a checkpoint whatever mesh
saved it and places every leaf as the current mesh says.

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
import torch.distributed as dist

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
    """Atomically write ``tree`` as step ``step``.  Returns the path.  In
    a world of several ranks rank 0 writes and every rank returns after
    the checkpoint is complete."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if dist.is_initialized() and dist.get_world_size() > 1:
        if dist.get_rank() == 0:
            _write(ckpt_dir, final, step, tree, extra)
        dist.barrier()
        return final
    return _write(ckpt_dir, final, step, tree, extra)


def _write(ckpt_dir: str, final: str, step: int, tree, extra) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
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


def restore_resharded(ckpt_dir: str, tree_like, shardings,
                      step: int | None = None):
    """Elastic restore: :func:`restore`, then every leaf placed by the
    matching leaf of ``shardings`` (``sharding.param_shardings``'s
    :class:`~repro_torch.sharding.Placement` tree, built from the
    CURRENT mesh, whatever mesh saved the checkpoint).  Every rank holds
    each leaf whole, so placing is moving it to the rank's device.  As in
    the reference, the leaves are placed only when ``shardings`` has as
    many leaves as the state."""
    tree, extra, step = restore(ckpt_dir, tree_like, step)
    flat_t = list(_leaves(tree))
    flat_s = [s for _, s in _leaves(shardings)]
    if len(flat_s) == len(flat_t):
        out: dict = {}
        for (path, v), s in zip(flat_t, flat_s):
            device = getattr(s, "device", None)
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = v if device is None else v.to(device)
        tree = out
    return tree, extra, step
