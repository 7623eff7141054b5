"""Packed bit-exact SC MUL: the CUDA kernel's wrapper, its plain PyTorch
version, and the Horner-ladder / pop-count helpers the other bit-exact
engines share.

Port of ``repro.kernels.sc_mul`` (and of its oracle
``repro.kernels.ref.sc_mul_popcount_ref``).  For each of M MULs the
engine turns 16 uniform words per packed word into Bernoulli(p) bits with
the bit-sliced Horner ladder (``p`` in 16-bit fixed point, LSB first):

    t = u_j | t   if bit_j(p) else   u_j & t

for both operands, ANDs the two words (two-pulse write), pop-counts, and
sums over the ``W = nbit/32`` words into an int32 total.

:func:`sc_mul_popcount` launches ``csrc/sc_mul.cu`` for CUDA tensors and
runs :func:`sc_mul_popcount_plain` for CPU tensors.  Unlike the Pallas
wrapper it takes any M (the kernel masks the ragged edge).  The fused
kernel (``sc_fused.py``) and the SC attention kernel compute the same
ladder and pop-count in CUDA (``csrc/sc_device.cuh``), and the helpers
below are their plain versions' building blocks too.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda_lib

NSLICES = 16  # fixed-point precision of the Bernoulli bias (2^-16)
LANE_BITS = 32  # stochastic cells per packed word

_MASK32 = 0xFFFFFFFF
# MULs per step of the plain version (bounds its int64 temporaries)
_PLAIN_CHUNK = 1 << 14


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


def _check(p_x, p_y, rand_x, rand_y):
    tensors = (p_x, p_y, rand_x, rand_y)
    if any(t.dtype != torch.uint32 for t in tensors):
        raise ValueError("sc_mul_popcount takes uint32 biases and words")
    m = p_x.shape[0]
    if p_x.shape != (m,) or p_y.shape != (m,):
        raise ValueError(f"biases must be (M,), got {p_x.shape}, {p_y.shape}")
    if rand_x.dim() != 3 or rand_x.shape[:2] != (m, NSLICES):
        raise ValueError(
            f"rand_x must be ({m}, {NSLICES}, W), got {tuple(rand_x.shape)}"
        )
    if rand_y.shape != rand_x.shape:
        raise ValueError("rand_x and rand_y must have one shape")
    if any(t.device != p_x.device for t in tensors):
        raise ValueError("sc_mul_popcount operands must share one device")


def sc_mul_popcount(p_x_fx16, p_y_fx16, rand_x, rand_y):
    """Batched bit-exact SC MUL -> (M,) int32 pop-counts.

    p_*_fx16: (M,) uint32 biases (p·2^16); rand_*: (M, NSLICES, W) uint32
    uniform words; nbit = 32·W stochastic cells per MUL.
    """
    _check(p_x_fx16, p_y_fx16, rand_x, rand_y)
    if not p_x_fx16.is_cuda:
        return sc_mul_popcount_plain(p_x_fx16, p_y_fx16, rand_x, rand_y)
    px, py, rx, ry = (
        t.contiguous() for t in (p_x_fx16, p_y_fx16, rand_x, rand_y)
    )
    m, _, w = rx.shape
    out = torch.empty((m,), dtype=torch.int32, device=px.device)
    if m == 0:
        return out
    lib = _lib()
    with torch.cuda.device(px.device):
        code = lib.sc_mul_popcount(
            px.data_ptr(),
            py.data_ptr(),
            rx.data_ptr(),
            ry.data_ptr(),
            out.data_ptr(),
            m,
            w,
            cuda_lib.stream_ptr(px.device),
        )
    cuda_lib.check(lib, code, "sc_mul_popcount")
    cuda_lib.launches["sc_mul_popcount"] += 1
    return out


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_lib.load("sc_mul")
        p = ctypes.c_void_p
        lib.sc_mul_popcount.argtypes = [p, p, p, p, p, ctypes.c_longlong]
        lib.sc_mul_popcount.argtypes += [ctypes.c_int, p]
        lib.sc_mul_popcount.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def sc_mul_popcount_plain(p_x_fx16, p_y_fx16, rand_x, rand_y):
    """The kernel's function in ordinary tensor ops (int64 words), on
    whatever device the inputs lie; the reference's oracle
    ``sc_mul_popcount_ref``.  Same arguments and result as
    :func:`sc_mul_popcount`."""
    _check(p_x_fx16, p_y_fx16, rand_x, rand_y)
    m = p_x_fx16.shape[0]
    out = torch.empty((m,), dtype=torch.int32, device=p_x_fx16.device)
    for a in range(0, m, _PLAIN_CHUNK):
        b = min(m, a + _PLAIN_CHUNK)
        px = p_x_fx16[a:b, None].to(torch.int64)
        py = p_y_fx16[a:b, None].to(torch.int64)
        bx = bernoulli_words(px, rand_x[a:b].to(torch.int64))
        by = bernoulli_words(py, rand_y[a:b].to(torch.int64))
        out[a:b] = popcount32(bx & by).sum(dim=-1).to(torch.int32)
    return out


def sc_mul_bitexact(key, p_x, p_y, *, nbit: int = 1024):
    """Batched bit-exact SC MUL of probability vectors through the packed
    engine: p_x, p_y (M,) float probabilities -> (M,) float32 estimates
    of p_x·p_y (pop-count / nbit).

    The words are ``jax.random.bits(split(key)[i], (M, 16, nbit/32))``
    (``ctr_rng.random_bits``), so the result equals the reference's bit
    for bit; the device is ``p_x``'s.
    """
    from repro_torch.sc import ctr_rng, encoding

    if nbit % LANE_BITS or nbit <= 0:
        raise ValueError("nbit must be a positive multiple of 32")
    w = nbit // LANE_BITS
    m = p_x.shape[0]
    dev = p_x.device
    px = encoding.to_fx16(p_x).to(torch.uint32)
    py = encoding.to_fx16(p_y).to(torch.uint32)
    kx, ky = ctr_rng.split(ctr_rng.raw_key(key).to(dev))
    shape = (m, NSLICES, w)
    rx = ctr_rng.random_bits(kx, shape).to(torch.uint32)
    ry = ctr_rng.random_bits(ky, shape).to(torch.uint32)
    counts = sc_mul_popcount(px, py, rx, ry)
    return counts.to(torch.float32) / nbit
