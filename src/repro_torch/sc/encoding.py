"""Canonical operand encoding shared by every SC backend.

Port of ``repro.sc.encoding``, formula for formula, so the fx16 bias
words are bit-identical to the reference:

* sign/magnitude split — the paper's engine multiplies unsigned
  probabilities; signs are carried beside the magnitudes.
* per-tensor max-abs scale — magnitudes map onto [0, 1].
* operand-grid quantization — ``clip(round(p·2^n), 0, 2^n - 1) / 2^n``:
  round half to even (``torch.round``), then an IEEE division by the
  level count, as the reference does.
* fx16 bias words — ``clip(round(p·2^16), 0, 65535)``.
"""

from __future__ import annotations

import torch

FX16_ONE = 1 << 16  # fixed-point unit of the packed-engine bias words


def encode(v, cfg, dim=None):
    """float tensor -> (sign, probability, scale); v ≈ sign·p·scale.

    ``cfg`` needs ``quantize`` and ``operand_bits``.  The grid is the
    paper's n-bit LUT index space, clamped to ``2^n - 1`` levels.  With
    ``dim`` the max-abs scale is taken along that axis (kept), so each
    slice is encoded as the tensor of that slice alone would be.
    """
    a = v.abs()
    scale = torch.clamp_min(a.amax() if dim is None
                            else a.amax(dim, keepdim=True), 1e-30)
    p = a / scale
    if cfg.quantize:
        p = quantize_grid(p, 1 << cfg.operand_bits)
    return torch.sign(v), p, scale


def decode(sign, p, scale):
    """Inverse of :func:`encode` (up to quantization)."""
    return sign * p * scale


def quantize_grid(p, levels: int):
    """Snap probabilities onto the paper's n-bit LUT/DTC operand grid."""
    return torch.clamp(torch.round(p * levels), 0, levels - 1) / levels


def to_fx16(p):
    """Probability in [0, 1] -> 16-bit bias word (held in int64).

    Round half to even, clamped to 65535 (p = 1.0 has no 16-bit word).
    """
    return torch.clamp(torch.round(p * FX16_ONE), 0, FX16_ONE - 1).to(
        torch.int64
    )


def from_fx16(w):
    """Bias word -> the probability the packed engine realizes."""
    return w.to(torch.float32) / FX16_ONE


def pad_to(x, multiple, axis):
    """Zero-pad ``axis`` of ``x`` up to the next multiple of ``multiple``."""
    rem = (-x.shape[axis]) % multiple
    if rem == 0:
        return x
    shape = list(x.shape)
    shape[axis] = rem
    return torch.cat([x, x.new_zeros(shape)], dim=axis)
