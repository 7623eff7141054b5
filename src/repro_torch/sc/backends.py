"""The registered SC matmul backends.

Port of ``repro.sc.backends``:

* ``exact`` — a float32 matmul;
* ``moment`` — the CLT moment-matched path in torch ops: three matmuls
  and one ``jax.random.normal``-equal draw (``ctr_rng.normal``);
* ``pallas_moment`` — the same law through the fused moment kernel
  (``kernels/sc_mac.py``, CUDA ``csrc/sc_mac.cu``);
* ``pallas_fused`` — the fused bit-exact engine, per call and per row
  key, sharing ``_fused_engine`` as the reference does.

The Monte-Carlo ``bitexact`` backend and the packed ``pallas_bitexact``
kernel come with later slices (``registry._UNPORTED``);
``pallas_bitexact`` configs reach ``pallas_fused`` through
``fast_backend``, which is bit-identical by the reference's own
contract.

Moment law (``moment`` / ``pallas_moment``): the signed MAC output is
Normal(mean, var) with ``mean = x@w`` and ``var = scale²·(p_x@p_w −
p_x²@p_w²)/nbit`` on the encoded probabilities.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import sc_fused as sc_fused_kernel
from repro_torch.kernels import sc_mac as sc_mac_kernel
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
    reference's padding)."""
    sx, px, scx = encoding.encode(x, cfg)
    sw, pw, scw = encoding.encode(w, cfg)
    noise = _moment_noise(key, x.shape[0], w.shape[1], x.device)
    out = sc_mac_kernel.sc_mac_fused(sx * px, sw * pw, noise, nbit=cfg.nbit)
    return out * (scx * scw)


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
