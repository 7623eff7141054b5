"""The registered SC matmul backends of this slice.

Port of the ``exact`` and ``pallas_fused`` backends of
``repro.sc.backends`` (the fused engine's per-call and per-row-key
paths, sharing ``_fused_engine`` as the reference does).  The moment and
Monte-Carlo backends and the packed ``pallas_bitexact`` kernel come with
later slices (``registry._UNPORTED``); ``pallas_bitexact`` configs reach
``pallas_fused`` through ``fast_backend``, which is bit-identical by the
reference's own contract.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import sc_fused as sc_fused_kernel
from repro_torch.sc import ctr_rng
from repro_torch.sc.config import ScConfig
from repro_torch.sc.registry import register_backend, register_rows_backend


@register_backend("exact")
def exact(key, x, w, cfg: ScConfig):
    del key
    return x.to(torch.float32) @ w.to(torch.float32)


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
