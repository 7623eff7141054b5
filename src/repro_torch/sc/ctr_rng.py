"""Counter-based RNG shared by the bit-exact SC engines (Threefry-2x32).

Port of ``repro.sc.ctr_rng``.  The stream is pinned explicitly:

    word(key, c0, c1) = Threefry-2x32(key, (c0, c1))[0]

with the counter layout of :func:`product_counters`:

    c0 = flat product index  (i·K + k)·N + j
    c1 = s·nwords + w        (Horner slice s, word w)

Values are 32-bit words, but torch's ``uint32`` has no ``+ - << >> ~``
on the CPU and ``int32 >>`` is an arithmetic shift, so every function
here computes in ``int64`` tensors masked to ``0xFFFFFFFF``.  The CUDA
kernels (``csrc/sc_device.cuh``) compute the same words in native
``uint32_t``.

The JAX key chain reduces to this one function (jax 0.9.0 with
``jax_threefry_partitionable=True``):

* ``PRNGKey(s)``      = raw ``[0, s]``            (:func:`prng_key`)
* ``fold_in(k, d)``   = ``threefry2x32(k, (0, d))``  (:func:`fold_in`)
* ``split(k, n)[i]``  = ``threefry2x32(k, (0, i))``  (:func:`split`)

so every per-request, per-position, per-layer and per-site key of the
reference reproduces here.  Keys are explicit ``(..., 2)`` ``uint32``
tensors; there is no global RNG state.

The samplers the reference draws with reduce to the same function:

* ``bits(k, shape, uint32)`` flattened row-major: element ``i`` is
  ``x0 ^ x1`` of ``threefry2x32(k, (i >> 32, i & 0xFFFFFFFF))``
  (:func:`random_bits`);
* ``uniform(k, shape, f32, lo, hi)``: ``f = bitcast((bits >> 9) |
  0x3F800000) - 1``, then ``max(lo, f·(hi - lo) + lo)`` in float32
  (:func:`uniform`);
* ``normal(k, shape, f32)``: ``√2·erfinv(uniform(k, shape,
  nextafter(-1, 0), 1))`` (:func:`normal`) — equal to the reference up to
  ``erfinv``'s rounding in the tails (a few 1e-6);
* ``bernoulli(k, p, shape)`` = ``uniform(k, shape) < p`` and
  ``randint(k, shape, lo, hi)`` from two ``bits`` draws of ``split(k)``.

Each is a pure function of the key — never of a ``torch.Generator`` —
so a forward pass recomputed under activation checkpointing draws the
same noise.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

# Threefry-2x32 constants (Salmon et al., SC'11): 20 rounds = 5 groups of
# 4, rotation schedule alternating between the two quartets, key words
# re-injected after every group with the round-group counter.
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _u64(v, device=None) -> torch.Tensor:
    """A 32-bit word (int, uint32 or int64 tensor) as an int64 tensor."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64)
    return torch.tensor(int(v) & MASK32, dtype=torch.int64, device=device)


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32 (20 rounds); returns ``(x0, x1)`` as int64 words.

    Arguments are ints or tensors holding 32-bit words (``uint32`` or
    ``int64``); they broadcast against each other.  Results are int64
    tensors with values in ``[0, 2**32)``.
    """
    dev = next(
        (a.device for a in (c0, c1, k0, k1) if isinstance(a, torch.Tensor)),
        None,
    )
    k0, k1, c0, c1 = (_u64(a, dev) for a in (k0, k1, c0, c1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = torch.broadcast_tensors(c0 + k0, c1 + k1)
    x0 = x0.bitwise_and(MASK32)
    x1 = x1.bitwise_and(MASK32)
    for group in range(5):
        for rot in _ROTATIONS[group % 2]:
            x0.add_(x1).bitwise_and_(MASK32)
            x1 = (x1 << rot).bitwise_or_(x1 >> (32 - rot))
            x1.bitwise_and_(MASK32).bitwise_xor_(x0)
        x0.add_(ks[(group + 1) % 3]).bitwise_and_(MASK32)
        x1.add_(ks[(group + 2) % 3] + (group + 1)).bitwise_and_(MASK32)
    return x0, x1


def uniform_words(key2, c0, c1):
    """One iid-uniform 32-bit word per counter pair (first lane)."""
    return threefry2x32(key2[..., 0], key2[..., 1], c0, c1)[0]


def raw_key(key) -> torch.Tensor:
    """Normalize a key to its raw ``(..., 2)`` ``uint32`` tensor."""
    if not isinstance(key, torch.Tensor):
        key = torch.as_tensor(key, dtype=torch.int64)
    if key.dtype != torch.uint32:
        key = key.to(torch.int64).bitwise_and(MASK32).to(torch.uint32)
    return key


def _as_key(x0, x1) -> torch.Tensor:
    return torch.stack([x0, x1], dim=-1).to(torch.uint32)


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for ``0 <= seed < 2**32``: ``[0, s]``."""
    if not 0 <= seed <= MASK32:
        raise ValueError(f"seed must fit in 32 bits, got {seed}")
    return torch.tensor([0, seed], dtype=torch.uint32, device=device)


def fold_in(key, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``threefry2x32(key, (0, data))``.

    ``key`` is ``(..., 2)``; ``data`` an int or a tensor broadcasting
    against ``key.shape[:-1]``.
    """
    key = raw_key(key)
    x0, x1 = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return _as_key(x0, x1)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(num, 2)`` keys, ``threefry2x32(key,
    (0, i))`` for ``i < num``; batched keys give ``(..., num, 2)``."""
    key = raw_key(key)
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    x0, x1 = threefry2x32(key[..., 0, None], key[..., 1, None], 0, idx)
    return _as_key(x0, x1)


def product_counters(n_products: int, nwords: int, device=None, start=0):
    """The pinned (c0, c1) layout of one operand's per-product stream:
    ``c0`` of shape ``(n_products, 1, 1)`` and ``c1`` of shape
    ``(1, NSLICES, nwords)`` (``s·nwords + w``).  ``start`` offsets the
    product index (mod 2^32), so a caller may walk the stream in
    chunks."""
    from repro_torch.kernels.sc_mul import NSLICES

    c0 = torch.arange(n_products, dtype=torch.int64, device=device)
    c0 = (c0 + start) & MASK32
    s = torch.arange(NSLICES, dtype=torch.int64, device=device)
    w = torch.arange(nwords, dtype=torch.int64, device=device)
    c1 = s[:, None] * nwords + w[None, :]
    return c0[:, None, None], c1[None]


def operand_stream(key2, n_products: int, nwords: int, start: int = 0):
    """Materialization: ``(n_products, NSLICES, nwords)`` int64 words of
    products ``start .. start + n_products - 1`` — the stream the packed
    engine consumes.  Product p's words depend on p alone."""
    key2 = raw_key(key2)
    c0, c1 = product_counters(n_products, nwords, key2.device, start)
    return uniform_words(key2, c0, c1)


# ---------------------------------------------------------------------------
# Samplers: jax.random's bits / uniform / normal / bernoulli / randint
# ---------------------------------------------------------------------------


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def random_bits(key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 words in
    ``[0, 2**32)``: element ``i`` (row-major) is ``x0 ^ x1`` of
    ``threefry2x32(key, (i >> 32, i))``."""
    key = raw_key(key)
    dev = key.device if device is None else torch.device(device)
    i = torch.arange(_numel(shape), dtype=torch.int64, device=dev)
    return bits_at(key, i).reshape(tuple(shape))


def bits_at(key, index) -> torch.Tensor:
    """The words of :func:`random_bits` at the given row-major flat
    indices (an int64 tensor) of the draw, on ``index``'s device: a
    large draw can be walked in pieces without changing an element."""
    k = raw_key(key).to(device=index.device, dtype=torch.int64)
    x0, x1 = threefry2x32(k[0], k[1], index >> 32, index & MASK32)
    return x0 ^ x1


def _unit_floats(bits) -> torch.Tensor:
    """Mantissa trick of ``jax.random.uniform``: floats in [0, 1)."""
    fb = (bits >> 9) | 0x3F800000
    return fb.to(torch.int32).view(torch.float32) - 1.0


def uniform(key, shape, minval=0.0, maxval=1.0, device=None):
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    return _scaled_uniform(random_bits(key, shape, device), minval, maxval)


def _scaled_uniform(bits, minval, maxval):
    floats = _unit_floats(bits)
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    # XLA contracts ``floats * span + lo`` into one fused multiply-add:
    # the float32 product is exact in float64, so one rounding of the
    # float64 sum reproduces it
    span = (hi - lo).double()
    fused = (floats.double() * span + lo.double()).float()
    return torch.maximum(lo, fused)


_NORMAL_LO = -0.99999994  # float32 nextafter(-1, 0)
_SQRT2 = 1.4142135  # float32 sqrt(2)


def normal(key, shape, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``√2·erfinv(u)`` with
    ``u`` uniform on ``[nextafter(-1, 0), 1)``."""
    u = uniform(key, shape, _NORMAL_LO, 1.0, device)
    return torch.special.erfinv(u) * _SQRT2


def normal_at(key, index) -> torch.Tensor:
    """The elements of :func:`normal` at the given row-major flat indices
    (an int64 tensor) of the draw."""
    u = _scaled_uniform(bits_at(key, index), _NORMAL_LO, 1.0)
    return torch.special.erfinv(u) * _SQRT2


def normal_rows(keys, n: int, device=None) -> torch.Tensor:
    """``normal(keys[i], (1, n))[0]`` for every row key at once: an
    ``(M, n)`` draw whose row i is bit-equal to that one-row draw (its
    element j is flat index j of row i's own stream).  keys: ``(M, 2)``
    raw keys; the draw lies on ``device`` (default: the keys')."""
    keys = raw_key(keys)
    dev = keys.device if device is None else torch.device(device)
    k = keys.to(device=dev, dtype=torch.int64)
    j = torch.arange(n, dtype=torch.int64, device=dev)
    x0, x1 = threefry2x32(k[:, 0, None], k[:, 1, None], 0, j[None])
    u = _scaled_uniform(x0 ^ x1, _NORMAL_LO, 1.0)
    return torch.special.erfinv(u) * _SQRT2


def bernoulli(key, p, shape, device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (float32 ``p``)."""
    return uniform(key, shape, device=device) < torch.tensor(
        p, dtype=torch.float32
    )


def randint(key, shape, minval: int, maxval: int, device=None):
    """``jax.random.randint(key, shape, minval, maxval, int32)`` for
    ``0 < maxval - minval < 2**31``: two words per value from
    ``split(key)``, reduced modulo the span as the reference does."""
    span = int(maxval) - int(minval)
    if not 0 < span < 2**31:
        raise ValueError(f"randint span {span} outside (0, 2**31)")
    k1, k2 = split(key)
    hi = random_bits(k1, shape, device)
    lo = random_bits(k2, shape, device)
    # the reference squares 2**16 % span in uint32, which wraps
    mult = ((((1 << 16) % span) ** 2) & MASK32) % span
    off = ((hi % span) * mult + lo % span) & MASK32
    return (off % span + int(minval)).to(torch.int32)
