"""Counter-based Threefry-2x32 and the samplers the SC moment law draws
its noise with, in plain PyTorch.

A frozen copy of the arithmetic (Salmon et al., SC'11; ``jax.random``'s
key chain under ``jax_threefry_partitionable``), written for the
benchmark's reference so that it shares no code with the program:

* ``threefry(k0, k1, c0, c1)``: 20 rounds, the first output word and
  the second;
* ``fold_in(key, d)`` = ``threefry(key, (0, d))``; ``prng_key(s)`` =
  ``[0, s]``;
* ``normal(key, shape)``: element ``i`` (row-major) takes the word
  ``x0 ^ x1`` of ``threefry(key, (i >> 32, i & 0xFFFFFFFF))``, makes a
  float in ``[-1 + 2**-24, 1)`` by the mantissa trick, and returns
  ``sqrt(2) * erfinv`` of it.

Words are held in int64 tensors masked to 32 bits.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
LO = -0.99999994  # float32 nextafter(-1, 0)
SQRT2 = 1.4142135  # float32 sqrt(2)


def _i64(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int64)
    return torch.tensor(int(v) & M32, dtype=torch.int64, device=device)


def threefry(k0, k1, c0, c1, device=None):
    """Threefry-2x32 (20 rounds) -> ``(x0, x1)`` int64 words."""
    if device is None:
        device = next((a.device for a in (k0, k1, c0, c1)
                       if isinstance(a, torch.Tensor)), "cpu")
    k0, k1, c0, c1 = (_i64(a, device) for a in (k0, k1, c0, c1))
    k2 = k0 ^ k1 ^ PARITY
    keys = (k0, k1, k2)
    x0, x1 = torch.broadcast_tensors((c0 + k0) & M32, (c1 + k1) & M32)
    x0, x1 = x0.clone(), x1.clone()
    for g in range(5):
        for r in ROT[g % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & M32
            x1 = x1 ^ x0
        x0 = (x0 + keys[(g + 1) % 3]) & M32
        x1 = (x1 + keys[(g + 2) % 3] + g + 1) & M32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def fold_in(key, data) -> torch.Tensor:
    """``key`` (..., 2) folded with ``data`` (an int or a tensor that
    broadcasts against ``key.shape[:-1]``) -> (..., 2) int64 words."""
    x0, x1 = threefry(key[..., 0], key[..., 1], 0, data, key.device)
    return torch.stack([x0, x1], dim=-1)


def _normal_from_words(word):
    f = ((word >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(LO, dtype=torch.float32, device=word.device)
    hi = torch.tensor(1.0, dtype=torch.float32, device=word.device)
    # one rounding of f * (hi - lo) + lo, as a fused multiply-add gives
    u = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.special.erfinv(torch.maximum(lo, u)) * SQRT2


def normal(key, shape, device=None) -> torch.Tensor:
    """Standard normals of one key, ``shape`` row-major."""
    n = 1
    for d in shape:
        n *= int(d)
    dev = key.device if device is None else device
    i = torch.arange(n, dtype=torch.int64, device=dev)
    k = key.to(dev)
    x0, x1 = threefry(k[0], k[1], i >> 32, i & M32)
    return _normal_from_words(x0 ^ x1).reshape(tuple(shape))


def normal_rows(keys, n: int) -> torch.Tensor:
    """``normal(keys[r], (n,))`` for each row key of ``keys`` (R, 2)."""
    j = torch.arange(n, dtype=torch.int64, device=keys.device)
    x0, x1 = threefry(keys[:, 0, None], keys[:, 1, None], 0, j[None])
    return _normal_from_words(x0 ^ x1)
