"""Atomic checkpoints in the reference's on-disk layout.

Port of ``repro.checkpoint.ckpt``: ``<dir>/step_<N:08d>/`` holds one
``leaf_<i:05d>.npy`` per leaf of the state's dict tree, in sorted-key
order, plus ``META.json`` (``step``, a ``manifest`` of key / file /
dtype / shape per leaf with keys the ``/``-joined dict paths, and
``extra``).  Writes go to ``step_<N>.tmp/`` and are renamed into place
after every leaf and the metadata are written and ``META.json`` is
fsync'd, so :func:`latest_step` only ever sees complete directories.
A checkpoint written by either package restores in the other.

On a ``torch.distributed`` world :func:`save` writes from rank 0 alone
and the others wait at a barrier until the rename is done: no rank
restores from, or lists, a half-written step.  A state held whole on
every rank is written as it is; a state in the train step's FSDP ∘ TP
layout (``shardings``: a ``Placement`` per leaf,
``sharding.fsdp.state_placements``) is gathered leaf by leaf, every rank
taking part, so one whole leaf at a time is live, and written in the
same layout.  :func:`restore_resharded` restores a checkpoint whatever
mesh saved it and keeps each leaf as the current mesh places it: the
rank's shard, cut on the host before it moves to the device.

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


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None, *,
         shardings=None) -> str:
    """Atomically write ``tree`` as step ``step``.  Returns the path.  In
    a world of several ranks rank 0 writes and every rank returns after
    the checkpoint is complete.  With ``shardings`` (a ``Placement`` for
    every leaf) the leaves are shards, gathered one at a time."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    items = _flatten_with_paths(tree)
    if shardings is not None:
        pls = [s for _, s in _leaves(shardings)]
        if len(pls) != len(items):
            raise ValueError(f"{len(pls)} placements for a state of "
                             f"{len(items)} leaves")
        items = ((key, pl.gather(leaf) if isinstance(leaf, torch.Tensor)
                  else leaf) for (key, leaf), pl in zip(items, pls))
    if dist.is_initialized() and dist.get_world_size() > 1:
        if dist.get_rank() == 0:
            _write(ckpt_dir, final, step, items, extra)
        else:
            for _ in items:  # take part in every gather
                pass
        dist.barrier()
        return final
    return _write(ckpt_dir, final, step, items, extra)


def _write(ckpt_dir: str, final: str, step: int, items, extra) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = []
    for i, (key, leaf) in enumerate(items):
        arr = _to_numpy(leaf)
        del leaf
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


def _to_tensor(arr: np.ndarray, entry: dict, like, cut=None
               ) -> torch.Tensor:
    if arr.dtype.kind == "V" and entry["dtype"] == "bfloat16":
        bits = torch.from_numpy(arr.view(np.int16).copy())
        t = bits.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if cut is not None:
        t = cut(t)
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t


def restore(ckpt_dir: str, tree_like, step: int | None = None):
    """Restore into the structure (dtypes, devices) of ``tree_like``.
    Returns ``(tree, meta_extra, step)``."""
    return _restore(ckpt_dir, tree_like, step)


def _restore(ckpt_dir: str, tree_like, step, cuts=None):
    """:func:`restore`, each whole leaf first taken on the host by its
    callable in ``cuts`` (one a leaf) to what this rank keeps."""
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
    cuts = cuts or [None] * len(like)
    out: dict = {}
    for (key, leaf), entry, cut in zip(like, manifest, cuts):
        if entry["key"] != key:
            raise ValueError(f"checkpoint leaf {entry['key']!r} != {key!r}")
        arr = np.load(os.path.join(path, entry["file"]))
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _to_tensor(arr, entry, leaf, cut)
    return out, meta["extra"], step


def restore_resharded(ckpt_dir: str, tree_like, shardings,
                      step: int | None = None):
    """Elastic restore: :func:`restore`, every leaf kept as the matching
    leaf of ``shardings`` places it (a
    :class:`~repro_torch.sharding.Placement` tree built from the CURRENT
    mesh, whatever mesh saved the checkpoint; ``sharding.fsdp.
    state_placements`` for a whole train state): the rank's shard, on
    ``tree_like``'s device.  As in the reference, the leaves are placed
    only when ``shardings`` has as many leaves as the state; otherwise
    every leaf is restored whole."""
    flat_s = [s for _, s in _leaves(shardings)]
    cuts = None
    if len(flat_s) == len(list(_leaves(tree_like))):
        cuts = [s.shard for s in flat_s]
    return _restore(ckpt_dir, tree_like, step, cuts)
