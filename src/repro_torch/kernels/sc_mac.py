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

Both wrappers launch ``csrc/sc_mac.cu`` (3xTF32 on the tensor cores,
float32-accurate) for CUDA tensors and run the plain versions for CPU
tensors.  Unlike the Pallas wrappers they take any M, N, K: the kernel's
TMA loads zero-fill the ragged tiles, and :func:`tma_operands` pads K
and N to the multiples of 4 that TMA's 16-byte row strides need.  ``w``
may be row-major (K, N) or the K-major view of an (N, K) tensor (the
tied unembed's ``table.T``): the kernel reads either without a copy.
:func:`sc_mac_plan` picks the split-K of a shape; split launches finish
in :func:`sc_mac_reduce`, which adds the partial sums in split order, so
the result does not change from launch to launch.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.sc import ctr_rng

_MASK32 = 0xFFFFFFFF

#: the kernel's output tile (w columns x x rows) and K per stage
BLOCK_N, BLOCK_M, BLOCK_K = 128, 64, 32
#: SMs of an H100 SXM: the plan fills one wave of blocks on them
NUM_SMS = 132
#: most stages summed into one accumulator (K 2048 a split)
MAX_STAGES = 64


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


def sc_mac_plan(m: int, n: int, k: int) -> tuple:
    """(splits, k per split) of the kernel at x (m, k) @ w (k, n).

    A pure function of the shape.  K is cut into splits of whole 32-deep
    stages, at most ``MAX_STAGES`` each: the tensor cores' float32
    accumulation loses accuracy with the number of steps summed into one
    accumulator (at mlp_wo, 1.15e-5 of max |out| over 152 stages, 4.7e-6
    over 76).  The output has ceil(n/128) x ceil(m/64) tiles; where
    those underfill ``NUM_SMS``, tiles x splits fill at least one wave
    (or every split is one stage), and among such splits the plan takes
    the least estimated time: waves x stages per split, plus the partial
    sums' round trip at ~2^17 outputs per stage-time.  Both terms are
    fitted to the card's times of every split count at mlp_wo, wq and wk
    (``tools/sc_mac_variants.py --splits``).  Ties go to fewer splits.
    """
    nk = max(1, -(-k // BLOCK_K))
    tiles = -(-n // BLOCK_N) * -(-m // BLOCK_M)
    if tiles >= NUM_SMS:
        splits = -(-nk // MAX_STAGES)
        return splits, -(-nk // splits) * BLOCK_K
    best = None
    for per in range(min(nk, MAX_STAGES), 0, -1):  # fewest splits first
        splits = -(-nk // per)
        if tiles * splits < NUM_SMS and per > 1:
            continue
        waves = -(-(tiles * splits) // NUM_SMS)
        cost = waves * per + (splits > 1) * splits * m * n / 2**17
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    _, splits, per = best
    return splits, per * BLOCK_K


def _pad_cols(t, cols: int):
    if t.shape[1] == cols:
        return t
    return torch.nn.functional.pad(t, (0, cols - t.shape[1]))


def tma_operands(x, w):
    """(x4, w4, w_kmajor): the operands as the kernel takes them.

    x4 is x contiguous with K zero-padded to a multiple of 4 (at least
    4); w4 is (K4, N4) with zero padding, either row-major or — when w
    is a K-major view such as ``table.T`` — the K-major view of a
    contiguous (N4, K4) tensor.  Aligned operands come back without a
    copy (a row-major x or w, or ``table.T``, whose K and N are multiples
    of 4); zeros are inert in all three sums.
    """
    k, n = w.shape
    k4 = max(4, -(-k // 4) * 4)
    n4 = -(-n // 4) * 4
    x4 = _pad_cols(x.contiguous(), k4)
    kmajor = w.stride(0) == 1 and w.stride(1) >= max(k, 1) and n > 1
    if kmajor:
        wt = w.T  # (N, K) with unit stride along K
        if wt.stride(1) != 1 or wt.stride(0) % 4 or wt.data_ptr() % 16:
            wt = wt.contiguous()
        if k4 != k or n4 != n:
            wt = torch.nn.functional.pad(wt, (0, k4 - k, 0, n4 - n))
        w4 = wt.T
    else:
        w4 = w.contiguous()
        if k4 != k or n4 != n:
            w4 = torch.nn.functional.pad(w4, (0, n4 - n, 0, k4 - k))
    if x4.data_ptr() % 16:
        x4 = x4.clone()
    if w4.data_ptr() % 16:
        w4 = w4.contiguous() if not kmajor else w4.T.contiguous().T
    return x4, w4, kmajor


def _launch(name, x, w, noise, seed, nbit, on_grid):
    m, n = x.shape[0], w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    x4, w4, kmajor = tma_operands(x, w)
    k4 = x4.shape[1]
    ldw = w4.stride(1) if kmajor else w4.stride(0)
    splits, kper = sc_mac_plan(m, n, k4)
    ws = None
    if splits > 1:
        ws = torch.empty((splits, 2, m, n), dtype=torch.float32,
                         device=x.device)
    lib = _lib()
    wargs = (x4.data_ptr(), w4.data_ptr(), int(kmajor), ldw, w4.shape[1])
    common = (out.data_ptr(), ws.data_ptr() if ws is not None else None,
              splits, kper, m, n, k4)
    tail = (1.0 / nbit, cuda_lib.stream_ptr(x.device))
    with torch.cuda.device(x.device):
        if noise is None:
            code = lib.sc_mac_fused_prng(*wargs, _seed_word(seed), *common,
                                         *tail)
        else:
            code = lib.sc_mac_fused(*wargs, noise.data_ptr(), *common,
                                    int(bool(on_grid)), *tail)
    cuda_lib.check(lib, code, name)
    cuda_lib.launches[name] += 1
    if ws is not None:
        return sc_mac_reduce(ws, noise, seed=seed, nbit=nbit, out=out)
    return out


def sc_mac_fused(x_signed_p, w_signed_p, noise, *, nbit: int = 1024,
                 on_grid: bool = False):
    """Fused moment SC matmul -> (M, N) float32 (scale-free).

    x: (M, K), w: (K, N) float32 signed probabilities (w row-major or a
    K-major view); noise: (M, N) float32 standard normals.  ``on_grid``:
    the caller guarantees every operand is exact in TF32 (the operand
    grid at ``operand_bits`` <= 10), so the kernel skips the products of
    their zero low parts; the plain version ignores it.
    """
    _check(x_signed_p, w_signed_p, noise)
    if not x_signed_p.is_cuda:
        return sc_mac_fused_plain(x_signed_p, w_signed_p, noise, nbit=nbit)
    return _launch("sc_mac_fused", x_signed_p, w_signed_p,
                   noise.contiguous(), None, nbit, on_grid)


def _seed_word(seed) -> int:
    """The (1,) int32 seed of the reference (or an int) as a 32-bit word."""
    if isinstance(seed, torch.Tensor):
        seed = int(seed.reshape(-1)[0])
    return int(seed) & _MASK32


def sc_mac_fused_prng(seed, x_signed_p, w_signed_p, *, nbit: int = 1024):
    """Kernel 5 with its noise made in the kernel: output (i, j) draws
    Threefry-2x32 words keyed ``(0, seed)`` at counters ``(0, 2·idx)``
    and ``(0, 2·idx + 1)``, ``idx = i·N + j`` (mod 2^32), through
    :func:`_box_muller`.  seed: an int or the reference's (1,) int32.
    It always takes the kernel's general (9-product) route."""
    _check(x_signed_p, w_signed_p)
    if not x_signed_p.is_cuda:
        return sc_mac_fused_prng_plain(
            seed, x_signed_p, w_signed_p, nbit=nbit
        )
    return _launch("sc_mac_fused_prng", x_signed_p, w_signed_p, None, seed,
                   nbit, False)


def sc_mac_reduce(partials, noise=None, *, seed=None, nbit: int = 1024,
                  out=None):
    """The split-K pass: partials (S, 2, M, N) float32 — per split the
    sums x·w and |x|·|w| − x²·w² over its K range — added in split
    order, then the moment law with ``noise`` (M, N), or with the
    in-kernel noise of ``seed`` when noise is None.  CUDA tensors launch
    ``sc_mac_reduce_kernel``."""
    if partials.dim() != 4 or partials.shape[1] != 2:
        raise ValueError(f"partials {tuple(partials.shape)}: (S, 2, M, N)")
    splits, _, m, n = partials.shape
    if (noise is None) == (seed is None):
        raise ValueError("sc_mac_reduce takes noise or a seed")
    if not partials.is_cuda:
        return sc_mac_reduce_plain(partials, noise, seed=seed, nbit=nbit)
    partials = partials.contiguous()
    if out is None:
        out = torch.empty((m, n), dtype=torch.float32,
                          device=partials.device)
    lib = _lib()
    with torch.cuda.device(partials.device):
        code = lib.sc_mac_reduce(
            partials.data_ptr(),
            splits,
            None if noise is None else noise.contiguous().data_ptr(),
            0 if seed is None else _seed_word(seed),
            out.data_ptr(),
            m,
            n,
            1.0 / nbit,
            cuda_lib.stream_ptr(partials.device),
        )
    cuda_lib.check(lib, code, "sc_mac_reduce")
    cuda_lib.launches["sc_mac_reduce"] += 1
    return out


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_lib.load("sc_mac")
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        f = ctypes.c_float
        head = [p, p, i, i, i]  # x, w, w_kmajor, ldw, nw
        common = [p, p, i, i, i, i, i]  # out, ws, splits, kper, M, N, K
        lib.sc_mac_fused.argtypes = head + [p] + common + [i, f, p]
        lib.sc_mac_fused.restype = ctypes.c_int
        lib.sc_mac_fused_prng.argtypes = head + [u] + common + [f, p]
        lib.sc_mac_fused_prng.restype = ctypes.c_int
        lib.sc_mac_reduce.argtypes = [p, i, p, u, p, i, i, f, p]
        lib.sc_mac_reduce.restype = ctypes.c_int
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


def sc_mac_reduce_plain(partials, noise=None, *, seed=None, nbit=1024):
    """:func:`sc_mac_reduce` in torch ops (the same split order)."""
    sums = partials[0]
    for s in range(1, partials.shape[0]):
        sums = sums + partials[s]
    if noise is None:
        noise = prng_noise(seed, sums.shape[1], sums.shape[2],
                           partials.device)
    var = torch.clamp_min(sums[1], 0.0) * (1.0 / nbit)
    return sums[0] + noise * torch.sqrt(var)


def sc_mac_fused_prng_plain(seed, x_signed_p, w_signed_p, *, nbit=1024):
    """:func:`sc_mac_fused_prng` in torch ops (int64-masked Threefry)."""
    _check(x_signed_p, w_signed_p)
    m, n = x_signed_p.shape[0], w_signed_p.shape[1]
    noise = prng_noise(seed, m, n, x_signed_p.device)
    return sc_mac_fused_plain(x_signed_p, w_signed_p, noise, nbit=nbit)
