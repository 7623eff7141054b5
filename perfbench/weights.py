"""The benchmark's weights: made on the device from the seed, in one
``torch.randn`` call for every drawn leaf, so that the program and the
reference are handed the same tensors."""

from __future__ import annotations

import math

import torch


def make(shapes: dict, seed: int, device, dtype) -> dict:
    """``{path: tensor}`` for ``shapes`` (``{path: (shape, init)}``, the
    reference's declaration): ``normal`` leaves 0.02 N(0, 1), ``scaled``
    ones N(0, 1) / sqrt(fan-in), the fan-in being the next-to-last
    dimension (the last of a vector); views of one draw, in sorted path
    order."""
    drawn = [k for k in sorted(shapes) if shapes[k][1] in ("normal",
                                                           "scaled")]
    total = sum(math.prod(shapes[k][0]) for k in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, off = {}, 0
    for k in sorted(shapes):
        shape, init = shapes[k]
        if init == "zeros":
            out[k] = torch.zeros(shape, device=device, dtype=dtype)
        elif init == "ones":
            out[k] = torch.ones(shape, device=device, dtype=dtype)
        else:
            n = math.prod(shape)
            leaf = buf[off:off + n].view(shape)
            off += n
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            leaf.mul_(0.02 if init == "normal" else 1 / math.sqrt(fan_in))
            out[k] = leaf
    return out


def nest(flat: dict) -> dict:
    """``{"a.b": t}`` -> ``{"a": {"b": t}}``."""
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *head, last = path.split(".")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = t
    return tree


def flatten(tree: dict, prefix: str = "") -> dict:
    """Inverse of :func:`nest`."""
    out = {}
    for k, v in tree.items():
        path = prefix + k
        if isinstance(v, dict):
            out.update(flatten(v, path + "."))
        else:
            out[path] = v
    return out
