"""Shared helpers of the bit-exact SC engines: the Horner ladder and the
SWAR pop-count, as plain PyTorch on int64 words.

Port of the helpers in ``repro.kernels.sc_mul``.  The packed Pallas
kernel of that module (``sc_mul_popcount``) is not ported yet; the fused
kernel (``sc_fused.py``) and the SC attention kernel compute the same
ladder and pop-count in CUDA (``csrc/sc_device.cuh``), and these helpers
are their plain versions' building blocks.

Bernoulli(p) bits come from the bit-sliced Horner ladder over 16 uniform
words (``p`` in 16-bit fixed point, LSB first):

    t = u_j | t   if bit_j(p) else   u_j & t
"""

from __future__ import annotations

import torch

NSLICES = 16  # fixed-point precision of the Bernoulli bias (2^-16)
LANE_BITS = 32  # stochastic cells per packed word

_MASK32 = 0xFFFFFFFF


def horner_step(t, u, p_fx16, s: int):
    """One ladder slice: ``u | t`` where bit ``s`` of ``p`` is set, else
    ``u & t``.  All int64 words; ``p_fx16`` broadcasts against ``t``."""
    bit = (p_fx16 >> s) & 1
    return torch.where(bit.bool(), u | t, u & t)


def bernoulli_words(p_fx16, u_slices):
    """Packed Bernoulli(p) words from NSLICES uniform words.

    p_fx16:   (bm, 1) int64 — bias in 16-bit fixed point
    u_slices: (bm, NSLICES, bw) int64 — iid uniform 32-bit words
    returns:  (bm, bw) int64 — each bit iid Bernoulli(p) per row
    """
    t = torch.zeros_like(u_slices[:, 0, :])
    for j in range(NSLICES):  # LSB -> MSB of the fixed-point bias
        t = horner_step(t, u_slices[:, j, :], p_fx16, j)
    return t


def popcount32(v):
    """SWAR pop-count of every 32-bit word (int64 in, int64 out)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _MASK32) >> 24
