"""Parameter declaration: shapes + logical axes in one place.

Port of ``repro.models.params`` for eager PyTorch.  Modules declare their
parameters as a dict tree of :class:`ParamSpec`; :func:`init_params`
materializes it from an explicit ``torch.Generator`` and
:func:`params_from_numpy` carries the JAX package's parameter pytree
(``jax.tree.map(np.asarray, params)``: same nesting, ``blocks`` stacked
on a leading layer axis) into tensors, which is how the parity tests
give both packages the same weights — and the same full train state
(``params``, ``opt.m`` / ``opt.v`` with their int8 ``{"q", "scale"}``
leaves, the int32 ``opt.step``).  :func:`partition_specs` maps each
leaf's logical axes onto mesh axes (``sharding/rules.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple  # logical axis name (or None) per dimension
    init: str = "normal"  # normal | zeros | ones | scaled (fan-in)
    dtype: Any = None  # overrides the model-wide param dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def tree_map_specs(f, tree):
    """Apply ``f`` to every :class:`ParamSpec` leaf of a dict tree."""
    if isinstance(tree, ParamSpec):
        return f(tree)
    return {k: tree_map_specs(f, v) for k, v in tree.items()}


def _leaves(tree, path=()):
    """(path, leaf) pairs in sorted-key order — the order ``jax.tree``
    flattens a dict tree in."""
    if not isinstance(tree, dict):
        yield path, tree
        return
    for k in sorted(tree):
        yield from _leaves(tree[k], path + (k,))


def tree_leaves(tree) -> list:
    """The leaves of a dict tree in sorted-key order."""
    return [leaf for _, leaf in _leaves(tree)]


def tree_map(fn, tree, *rest):
    """``fn(leaf, *matching)`` over the leaves of the dict tree ``tree``;
    each of ``rest`` is walked along ``tree``'s keys, so its matching
    node may itself be a subtree (an int8 optimizer state's
    ``{"q", "scale"}``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def init_params(specs, generator, device=None, dtype=torch.float32):
    """Materialize a ParamSpec tree into tensors on ``device``.

    Values are drawn on ``generator``'s device, leaf by leaf in sorted-key
    order, so one seed gives the same weights on every target device.
    """
    device = resolve_device(device)
    out: dict = {}
    gdev = generator.device
    for path, s in _leaves(specs):
        dt = s.dtype or dtype
        if s.init == "zeros":
            v = torch.zeros(s.shape)
        elif s.init == "ones":
            v = torch.ones(s.shape)
        else:
            v = torch.randn(s.shape, generator=generator, device=gdev)
            if s.init == "scaled":
                fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
                v = v * (1.0 / math.sqrt(fan_in))
            else:
                v = v * 0.02
        _set(out, path, v.to(device=device, dtype=dt))
    return out


def abstract_params(specs, dtype=torch.float32):
    """A tree of ``meta`` tensors, each spec's own dtype where it has one:
    shapes and dtypes with no allocation (what the dry-run traces with)."""
    return tree_map_specs(
        lambda s: torch.empty(s.shape, dtype=s.dtype or dtype,
                              device="meta"), specs)


def params_from_numpy(tree, device=None, dtype=None):
    """A nested dict of numpy arrays -> the same tree of tensors.

    Floating leaves take ``dtype`` when given, else keep their own
    (``bfloat16`` arrays from ``ml_dtypes`` become ``torch.bfloat16``
    exactly, through float32).
    """
    device = resolve_device(device)
    out: dict = {}
    for path, leaf in _leaves(tree):
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        _set(out, path, t.to(device))
    return out


def partition_specs(specs, rules: dict):
    """Map logical axes -> mesh axes per ``rules`` ({logical: mesh|None}).

    One tuple per leaf, one entry per dimension (what the reference's
    ``PartitionSpec`` holds).  A logical axis missing from the rules maps
    to None (replicated), and so does a dimension that its mesh axes'
    span (from the rules' ``__sizes__`` entry) does not divide.
    """
    sizes = rules.get("__sizes__", {})

    def one(s: ParamSpec):
        entries = []
        for dim, ax in zip(s.shape, s.axes):
            mesh_ax = rules.get(ax)
            if mesh_ax is None:
                entries.append(None)
                continue
            size = sizes.get(mesh_ax)
            if isinstance(mesh_ax, tuple):
                size = math.prod(sizes.get(a, 1) for a in mesh_ax)
            if size and dim % size != 0:
                entries.append(None)  # indivisible -> replicate this dim
            else:
                entries.append(mesh_ax)
        return tuple(entries)

    return tree_map_specs(one, specs)
