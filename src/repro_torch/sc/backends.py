"""The registered SC matmul backends.

Port of ``repro.sc.backends``:

* ``exact`` — a float32 matmul;
* ``moment`` — the CLT moment-matched path in torch ops: three matmuls
  and one ``jax.random.normal``-equal draw (``ctr_rng.normal``);
* ``bitexact`` — the paper's Monte-Carlo: one Binomial(nbit, p_x·p_w)
  pop-count per scalar product (``torch.binomial``);
* ``pallas_moment`` — the moment law through the fused moment kernel
  (``kernels/sc_mac.py``, CUDA ``csrc/sc_mac.cu``);
* ``pallas_bitexact`` — the packed engine (``kernels/sc_mul.py``, CUDA
  ``csrc/sc_mul.cu``) lifted to matmul shape: one bank of 32-cell words
  per (i, k, j) product from the pinned counter stream, then the exact
  signed integer sum over K;
* ``pallas_fused`` — the fused bit-exact engine, per call and per row
  key, sharing ``_fused_engine`` as the reference does.  It draws the
  same stream as ``pallas_bitexact``, so the two are bit-identical per
  key and ``fast_backend`` upgrades one to the other.

Moment law (``moment`` / ``pallas_moment``): the signed MAC output is
Normal(mean, var) with ``mean = x@w`` and ``var = scale²·(p_x@p_w −
p_x²@p_w²)/nbit`` on the encoded probabilities.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.kernels import sc_fused as sc_fused_kernel
from repro_torch.kernels import sc_mac as sc_mac_kernel
from repro_torch.kernels import sc_mul as sc_mul_kernel
from repro_torch.sc import ctr_rng, encoding
from repro_torch.sc.config import ScConfig
from repro_torch.sc.registry import register_backend, register_rows_backend


@register_backend("exact")
def exact(key, x, w, cfg: ScConfig):
    del key
    return x.to(torch.float32) @ w.to(torch.float32)


@register_backend("moment")
def moment(key, x, w, cfg: ScConfig):
    sx, px, scx = encoding.encode(x, cfg)
    sw, pw, scw = encoding.encode(w, cfg)
    mean = (sx * px) @ (sw * pw)
    # Var of each product estimate = p(1-p)/nbit with p = p_x·p_w
    sum_p = px @ pw
    sum_p2 = (px * px) @ (pw * pw)
    var = torch.clamp_min(sum_p - sum_p2, 0.0) / cfg.nbit
    noise = ctr_rng.normal(key, mean.shape, device=x.device)
    return (mean + noise * torch.sqrt(var)) * (scx * scw)


def _key_seed(key) -> int:
    """One 64-bit generator seed from a raw key's two words."""
    k0, k1 = (int(v) for v in ctr_rng.raw_key(key).to(torch.int64).cpu())
    return (k0 << 32) | k1


@register_backend("bitexact")
def bitexact(key, x, w, cfg: ScConfig):
    """Every product's pop-count ~ Binomial(nbit, p_x·p_w).

    The reference draws ``jax.random.binomial``, whose stream the port
    does not reproduce: the counts come from ``torch.binomial`` on a
    generator seeded with the key's two words, so one key gives one
    result within the port and the law (not the bits) equals the
    reference's.
    """
    sx, px, scx = encoding.encode(x, cfg)
    sw, pw, scw = encoding.encode(w, cfg)
    p_prod = px[:, :, None] * pw[None]  # (M, K, N) = P_x·P_w
    sign = sx[:, :, None] * sw[None]
    gen = torch.Generator(device=x.device).manual_seed(_key_seed(key))
    trials = torch.full_like(p_prod, float(cfg.nbit))
    counts = torch.binomial(trials, p_prod, generator=gen)
    est = counts / cfg.nbit  # ≈ P_x·P_w per product
    return torch.sum(sign * est, dim=1) * (scx * scw)


# The reference moment kernel's default column tile (``ScConfig.block_n``
# of ``repro.sc.config``): ``repro/sc/backends.py:95`` pads N to it
# before drawing the noise, so it fixes which counter each element reads.
_REF_BLOCK_N = 128


def _moment_noise(key, m: int, n: int, device):
    """The (m, n) corner of the reference's padded noise draw: it draws
    ``normal(key, (M_pad, N_pad))`` with ``N_pad`` = n rounded up to a
    multiple of ``min(_REF_BLOCK_N, n)``, so element (i, j) is flat
    index ``i·N_pad + j`` (rows past m are never read)."""
    tile = max(1, min(_REF_BLOCK_N, n))
    n_pad = -(-n // tile) * tile
    noise = ctr_rng.normal(key, (m, n_pad), device=device)
    return noise if n_pad == n else noise[:, :n]


@register_backend("pallas_moment")
def pallas_moment(key, x, w, cfg: ScConfig):
    """The moment law through the fused moment kernel (any M, N, K: the
    kernel masks its ragged tiles, so only the noise follows the
    reference's padding).  On the operand grid at ``operand_bits`` <= 10
    every signed probability is exact in TF32 (``on_grid``)."""
    sx, px, scx = encoding.encode(x, cfg)
    sw, pw, scw = encoding.encode(w, cfg)
    noise = _moment_noise(key, x.shape[0], w.shape[1], x.device)
    out = sc_mac_kernel.sc_mac_fused(
        sx * px, sw * pw, noise, nbit=cfg.nbit,
        on_grid=cfg.quantize and cfg.operand_bits <= 10,
    )
    return out * (scx * scw)


# uniform words per step of ``pallas_bitexact``'s stream walk (each
# int64 temporary of the Threefry pass is 8 bytes per word)
_STREAM_WORDS = 1 << 25


@register_backend("pallas_bitexact")
def pallas_bitexact(key, x, w, cfg: ScConfig):
    """The packed engine at matmul shape.

    Product p = (i·K + k)·N + j draws its operands' words at counters
    ``(p, s·nwords + w)`` of ``split(key)``'s two keys — the stream the
    fused kernel regenerates in-kernel, which makes the two backends
    bit-identical.  The reference materializes the whole
    (M·K·N, 16, nwords) stream; it depends on p alone, so the port walks
    the products in chunks (draw, cast to uint32, launch) and no count
    changes.
    """
    if cfg.nbit % sc_mul_kernel.LANE_BITS:
        raise ValueError("pallas_bitexact needs nbit to be a multiple of 32")
    nwords = cfg.nbit // sc_mul_kernel.LANE_BITS
    sx, px, scx = encoding.encode(x, cfg)
    sw, pw, scw = encoding.encode(w, cfg)
    m, k = x.shape
    n = w.shape[1]
    total = m * k * n
    fx = encoding.to_fx16(px)[:, :, None].expand(m, k, n).reshape(-1)
    fw = encoding.to_fx16(pw)[None].expand(m, k, n).reshape(-1)
    fx, fw = fx.to(torch.uint32), fw.to(torch.uint32)
    kx, ky = ctr_rng.split(key)
    counts = torch.empty((total,), dtype=torch.int32, device=x.device)
    step = max(1, _STREAM_WORDS // (sc_mul_kernel.NSLICES * nwords))
    for p0 in range(0, total, step):
        p1 = min(total, p0 + step)
        # a profiler range: the stream's share of a call is read from it
        with record_function("pallas_bitexact.stream"):
            rx = ctr_rng.operand_stream(kx, p1 - p0, nwords, p0)
            ry = ctr_rng.operand_stream(ky, p1 - p0, nwords, p0)
            rx, ry = rx.to(torch.uint32), ry.to(torch.uint32)
        counts[p0:p1] = sc_mul_kernel.sc_mul_popcount(
            fx[p0:p1], fw[p0:p1], rx, ry
        )
    # exact signed integer reduction over K: associative, so it matches
    # the fused kernel's accumulation bit for bit
    sign = sx.to(torch.int32)[:, :, None] * sw.to(torch.int32)[None]
    tot = torch.sum(sign * counts.reshape(m, k, n), dim=1)
    return tot.to(torch.float32) / cfg.nbit * (scx * scw)


def _fused_engine(keys4, x, w, cfg: ScConfig, scx, scw, *, row_keys):
    """The ONE scale/launch/rescale recipe behind both fused entry points.

    keys4: (M, 4) uint32 raw per-row key words [kx0, kx1, ky0, ky1];
    scx: () in per-call mode, (M, 1) in rows mode.  The reference's f32
    order: ``total / nbit * (scx * scw)``.
    """
    if cfg.nbit % sc_fused_kernel.LANE_BITS:
        raise ValueError("pallas_fused needs nbit to be a multiple of 32")
    m, k = x.shape
    n = w.shape[1]
    total = sc_fused_kernel.sc_fused_popcount(
        keys4,
        x / scx,
        w / scw,
        k_orig=k,
        n_orig=n,
        nbit=cfg.nbit,
        levels=1 << cfg.operand_bits,
        quantize=cfg.quantize,
        row_keys=row_keys,
    )
    return total.to(torch.float32) / cfg.nbit * (scx * scw)


def _max_abs(v, dim=None):
    a = v.abs().amax() if dim is None else v.abs().amax(dim, keepdim=True)
    return torch.clamp_min(a, 1e-30)


@register_backend("pallas_fused")
def pallas_fused(key, x, w, cfg: ScConfig):
    """One-kernel bit-exact SC matmul with one key for the whole call."""
    kx, ky = ctr_rng.split(key)
    keys4 = torch.cat([kx, ky]).to(x.device)
    keys4 = keys4[None].expand(x.shape[0], 4).contiguous()
    return _fused_engine(
        keys4, x, w, cfg, _max_abs(x), _max_abs(w), row_keys=False
    )


@register_rows_backend("pallas_fused")
def pallas_fused_rows(keys, x, w, cfg: ScConfig):
    """Per-row-key fused path (the serve engine's batch-invariance path).

    keys: (M, 2) raw keys — row i's bits AND encoding scale depend on
    ``keys[i]`` and ``x[i]`` alone, and equal the single-row call
    ``pallas_fused(keys[i], x[i:i+1], w, cfg)`` bit for bit.
    """
    split = ctr_rng.split(keys)  # (M, 2, 2)
    keys4 = torch.cat([split[:, 0], split[:, 1]], dim=-1).contiguous()
    return _fused_engine(
        keys4, x, w, cfg, _max_abs(x, 1), _max_abs(w), row_keys=True
    )
