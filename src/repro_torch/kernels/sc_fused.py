"""Fused bit-exact SC matmul: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``repro.kernels.sc_fused``.  Per scalar product (i, k, j) the
operands encode to fx16 bias words (``encode_fx16``), each draws
``nbit/32`` words × 16 ladder slices from the pinned Threefry stream
(``sc/ctr_rng.py``) at

    c0 = i·row_stride + k·n_orig + j  (mod 2^32),   c1 = s·nwords + w

(``row_stride = 0`` in per-row key mode, ``(k_orig·n_orig) mod 2^32``
otherwise), the two Horner ladders AND, pop-count, and ``sign·count``
sums over K into int32 totals.  Integer accumulation is associative, so
the totals are bitwise invariant to how the work is split.

:func:`sc_fused_popcount` launches ``csrc/sc_fused.cu`` for CUDA tensors
and runs :func:`sc_fused_popcount_plain` for CPU tensors.  Unlike the
Pallas wrapper it takes unpadded operands: padding is inert (fx16 of 0
gives an all-zero ladder), and the counters only depend on the caller's
``n_orig`` / ``k_orig``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.sc_mul import (
    LANE_BITS,
    NSLICES,
    horner_step,
    popcount32,
)
from repro_torch.sc import ctr_rng, encoding

_MASK32 = 0xFFFFFFFF
# elements per Threefry call in the plain version (bounds its memory)
_PLAIN_CHUNK = 1 << 20
_THREADS = 128  # outputs per block in csrc/sc_fused.cu


def encode_fx16(p, levels: int, quantize: bool):
    """|probability| tensor -> fx16 bias words (int64), the host encoding
    the kernel repeats in-kernel (``sc/encoding.py`` formulas)."""
    if quantize:
        p = encoding.quantize_grid(p, levels)
    return encoding.to_fx16(p)


def _check(keys, x, w, k_orig, n_orig, nbit):
    m, k = x.shape
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"x {tuple(x.shape)} @ w {tuple(w.shape)}")
    if keys.shape != (m, 4) or keys.dtype != torch.uint32:
        raise ValueError(f"keys must be ({m}, 4) uint32, got {keys.shape}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError("x and w must be float32 signed probabilities")
    if nbit % LANE_BITS or nbit <= 0:
        raise ValueError("the fused engine packs 32 cells per word")
    if k * nbit >= 2**31:
        raise ValueError("signed int32 accumulator needs K*nbit < 2^31")
    if k > k_orig or w.shape[1] > n_orig:
        raise ValueError("k_orig / n_orig must cover the operand shapes")


def sc_fused_popcount(
    keys,
    x_signed_p,
    w_signed_p,
    *,
    k_orig: int,
    n_orig: int,
    nbit: int,
    levels: int,
    quantize: bool = True,
    row_keys: bool = False,
):
    """Fused SC matmul -> (M, N) int32 signed pop-count totals.

    keys: (M, 4) uint32 per-row raw key words [kx0, kx1, ky0, ky1];
    x: (M, K), w: (K, N) float32 signed probabilities in [-1, 1].
    ``k_orig`` / ``n_orig`` are the widths that define the flat product
    index.  With ``row_keys=True`` the row term drops out of the index
    and every row draws from its own key's stream.
    """
    _check(keys, x_signed_p, w_signed_p, k_orig, n_orig, nbit)
    if not x_signed_p.is_cuda:
        return sc_fused_popcount_plain(
            keys,
            x_signed_p,
            w_signed_p,
            k_orig=k_orig,
            n_orig=n_orig,
            nbit=nbit,
            levels=levels,
            quantize=quantize,
            row_keys=row_keys,
        )
    dev = x_signed_p.device
    if not (keys.device == dev == w_signed_p.device):
        raise ValueError("keys, x and w must share one CUDA device")
    keys = keys.contiguous()
    x = x_signed_p.contiguous()
    w = w_signed_p.contiguous()
    m, k = x.shape
    n = w.shape[1]
    out = torch.zeros((m, n), dtype=torch.int32, device=dev)
    if m == 0 or n == 0 or k == 0:
        return out
    ksplit = _k_split(m, k, n, dev)
    row_stride = 0 if row_keys else (k_orig * n_orig) & _MASK32
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.sc_fused_popcount(
            keys.data_ptr(),
            x.data_ptr(),
            w.data_ptr(),
            out.data_ptr(),
            m,
            k,
            n,
            ksplit,
            n_orig & _MASK32,
            row_stride,
            nbit,
            levels,
            int(quantize),
            cuda_lib.stream_ptr(dev),
        )
    cuda_lib.check(lib, code, "sc_fused_popcount")
    cuda_lib.launches["sc_fused"] += 1
    return out


def _k_split(m: int, k: int, n: int, device) -> int:
    """Blocks along K so the grid holds ~16 blocks per SM: narrow outputs
    (wk/wv at N = 128) would otherwise leave most SMs idle."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = m * -(-n // _THREADS)
    want = max(1, min(k, -(-16 * sms // tiles)))
    chunk = -(-k // want)
    return -(-k // chunk)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_lib.load("sc_fused")
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        lib.sc_fused_popcount.argtypes = [p, p, p, p, i, i, i, i, u, u]
        lib.sc_fused_popcount.argtypes += [i, i, i, p]
        lib.sc_fused_popcount.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def sc_fused_popcount_plain(
    keys,
    x_signed_p,
    w_signed_p,
    *,
    k_orig: int,
    n_orig: int,
    nbit: int,
    levels: int,
    quantize: bool = True,
    row_keys: bool = False,
):
    """The kernel's function in ordinary tensor ops (int64 words masked to
    32 bits), on whatever device the inputs lie.  Same arguments and
    result as :func:`sc_fused_popcount`."""
    _check(keys, x_signed_p, w_signed_p, k_orig, n_orig, nbit)
    dev = x_signed_p.device
    m, k = x_signed_p.shape
    n = w_signed_p.shape[1]
    nwords = nbit // LANE_BITS
    row_stride = 0 if row_keys else (k_orig * n_orig) & _MASK32
    keys64 = keys.to(torch.int64)
    fxx = encode_fx16(x_signed_p.abs(), levels, quantize)
    fxw = encode_fx16(w_signed_p.abs(), levels, quantize)
    sgx = torch.sign(x_signed_p).to(torch.int64)
    sgw = torch.sign(w_signed_p).to(torch.int64)
    rows = torch.arange(m, dtype=torch.int64, device=dev)
    j = torch.arange(n, dtype=torch.int64, device=dev)
    base = rows[:, None, None] * row_stride + j[None, None, :]
    kx0, kx1, ky0, ky1 = (keys64[:, c, None, None, None] for c in range(4))
    wc = min(nwords, max(1, _PLAIN_CHUNK // max(m * n, 1)))
    kc = max(1, _PLAIN_CHUNK // (max(m * n, 1) * wc))
    out = torch.zeros((m, n), dtype=torch.int64, device=dev)
    for k0 in range(0, k, kc):
        k1 = min(k, k0 + kc)
        kk = torch.arange(k0, k1, dtype=torch.int64, device=dev)
        c0 = (base + kk[None, :, None] * n_orig) & _MASK32
        c0 = c0[..., None]  # (m, kc, n, 1)
        px = fxx[:, k0:k1, None, None]
        pw = fxw[None, k0:k1, :, None]
        counts = torch.zeros_like(c0[..., 0])
        for w0 in range(0, nwords, wc):
            widx = torch.arange(
                w0, min(nwords, w0 + wc), dtype=torch.int64, device=dev
            )
            shape = c0.shape[:-1] + (len(widx),)
            tx = torch.zeros(shape, dtype=torch.int64, device=dev)
            ty = torch.zeros_like(tx)
            for s in range(NSLICES):  # LSB -> MSB Horner ladder
                c1 = s * nwords + widx
                ux = ctr_rng.threefry2x32(kx0, kx1, c0, c1)[0]
                tx = horner_step(tx, ux, px, s)
                uy = ctr_rng.threefry2x32(ky0, ky1, c0, c1)[0]
                ty = horner_step(ty, uy, pw, s)
            counts += popcount32(tx & ty).sum(dim=-1)
        signed = sgx[:, k0:k1, None] * sgw[None, k0:k1] * counts
        out += signed.sum(dim=1)
    return out.to(torch.int32)
