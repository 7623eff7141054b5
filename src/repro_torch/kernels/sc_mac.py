"""Moment-matched SC matmul: the CUDA kernels' wrappers and their plain
PyTorch versions.

Port of ``repro.kernels.sc_mac``.  On signed probabilities x (M, K) and
w (K, N) both kernels compute

    out = x@w + z · sqrt(max(|x|@|w| − x²@w², 0) / nbit)

with z a standard normal per output: :func:`sc_mac_fused` takes z as an
(M, N) input (the ``pallas_moment`` backend draws it), and
:func:`sc_mac_fused_prng` makes it in the kernel from a seed with
Threefry-2x32 and the reference's :func:`_box_muller`.  The caller
multiplies by the operands' scales.

Both wrappers launch ``csrc/sc_mac.cu`` for CUDA tensors and run the
plain versions for CPU tensors.  Unlike the Pallas wrappers they take
any M, N, K: the kernel masks the ragged edges instead of the caller
padding to its tiles.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.sc import ctr_rng

_MASK32 = 0xFFFFFFFF


def _check(x, w, noise=None):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} @ w {tuple(w.shape)}")
    tensors = (x, w) if noise is None else (x, w, noise)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("sc_mac operands and noise must be float32")
    if noise is not None and noise.shape != (x.shape[0], w.shape[1]):
        raise ValueError(
            f"noise {tuple(noise.shape)} must be (M, N) = "
            f"{(x.shape[0], w.shape[1])}"
        )
    dev = x.device
    if any(t.device != dev for t in tensors):
        raise ValueError("sc_mac operands must share one device")


def sc_mac_fused(x_signed_p, w_signed_p, noise, *, nbit: int = 1024):
    """Fused moment SC matmul -> (M, N) float32 (scale-free).

    x: (M, K), w: (K, N) float32 signed probabilities; noise: (M, N)
    float32 standard normals.
    """
    _check(x_signed_p, w_signed_p, noise)
    if not x_signed_p.is_cuda:
        return sc_mac_fused_plain(x_signed_p, w_signed_p, noise, nbit=nbit)
    x, w, noise = (t.contiguous() for t in (x_signed_p, w_signed_p, noise))
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.sc_mac_fused(
            x.data_ptr(),
            w.data_ptr(),
            noise.data_ptr(),
            out.data_ptr(),
            m,
            n,
            k,
            1.0 / nbit,
            cuda_lib.stream_ptr(x.device),
        )
    cuda_lib.check(lib, code, "sc_mac_fused")
    cuda_lib.launches["sc_mac_fused"] += 1
    return out


def _seed_word(seed) -> int:
    """The (1,) int32 seed of the reference (or an int) as a 32-bit word."""
    if isinstance(seed, torch.Tensor):
        seed = int(seed.reshape(-1)[0])
    return int(seed) & _MASK32


def sc_mac_fused_prng(seed, x_signed_p, w_signed_p, *, nbit: int = 1024):
    """Kernel 5 with its noise made in the kernel: output (i, j) draws
    Threefry-2x32 words keyed ``(0, seed)`` at counters ``(0, 2·idx)``
    and ``(0, 2·idx + 1)``, ``idx = i·N + j`` (mod 2^32), through
    :func:`_box_muller`.  seed: an int or the reference's (1,) int32."""
    _check(x_signed_p, w_signed_p)
    if not x_signed_p.is_cuda:
        return sc_mac_fused_prng_plain(
            seed, x_signed_p, w_signed_p, nbit=nbit
        )
    x, w = x_signed_p.contiguous(), w_signed_p.contiguous()
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.sc_mac_fused_prng(
            x.data_ptr(),
            w.data_ptr(),
            _seed_word(seed),
            out.data_ptr(),
            m,
            n,
            k,
            1.0 / nbit,
            cuda_lib.stream_ptr(x.device),
        )
    cuda_lib.check(lib, code, "sc_mac_fused_prng")
    cuda_lib.launches["sc_mac_fused_prng"] += 1
    return out


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_lib.load("sc_mac")
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        f = ctypes.c_float
        lib.sc_mac_fused.argtypes = [p, p, p, p, i, i, i, f, p]
        lib.sc_mac_fused.restype = ctypes.c_int
        lib.sc_mac_fused_prng.argtypes = [p, p, u, p, i, i, i, f, p]
        lib.sc_mac_fused_prng.restype = ctypes.c_int
        _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def sc_mac_fused_plain(x_signed_p, w_signed_p, noise, *, nbit: int = 1024):
    """The kernel's function in torch ops (three float32 matmuls and the
    epilogue), on whatever device the inputs lie."""
    _check(x_signed_p, w_signed_p, noise)
    x, w = x_signed_p, w_signed_p
    mean = x @ w
    sum_p = x.abs() @ w.abs()
    sum_p2 = (x * x) @ (w * w)
    var = torch.clamp_min(sum_p - sum_p2, 0.0) * (1.0 / nbit)
    return mean + noise * torch.sqrt(var)


def _box_muller(bits_a, bits_b):
    """Standard normals from two 32-bit words (int64 tensors): the
    reference's ``_box_muller``."""
    u1 = (bits_a >> 8).to(torch.float32) * (1.0 / (1 << 24))
    u2 = (bits_b >> 8).to(torch.float32) * (1.0 / (1 << 24))
    u1 = torch.clamp_min(u1, 1e-12)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(2.0 * math.pi * u2)


def prng_noise(seed, m: int, n: int, device=None):
    """The (m, n) standard normals :func:`sc_mac_fused_prng` draws."""
    idx = torch.arange(m * n, dtype=torch.int64, device=device)
    ctr = (2 * idx) & _MASK32
    s = _seed_word(seed)
    a = ctr_rng.threefry2x32(0, s, 0, ctr)[0]
    b = ctr_rng.threefry2x32(0, s, 0, (ctr + 1) & _MASK32)[0]
    return _box_muller(a, b).reshape(m, n)


def sc_mac_fused_prng_plain(seed, x_signed_p, w_signed_p, *, nbit=1024):
    """:func:`sc_mac_fused_prng` in torch ops (int64-masked Threefry)."""
    _check(x_signed_p, w_signed_p)
    m, n = x_signed_p.shape[0], w_signed_p.shape[1]
    noise = prng_noise(seed, m, n, x_signed_p.device)
    return sc_mac_fused_plain(x_signed_p, w_signed_p, noise, nbit=nbit)
