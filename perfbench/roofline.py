"""The benchmark's frozen arithmetic: published peaks of the card, the
work of a model step, and the least time of kernel 5's work (a family's
matmul parameters are counted beside its reference, ``ref/``).

Every number a per-layer metric divides by comes from here, so the same
work is read whatever implements it.  Peaks are NVIDIA's H100 SXM data
sheet, dense rates without sparsity, at the full 700 W power limit.
"""

from __future__ import annotations

#: dense TF32 tensor-core rate, the float32 cells' peak (FLOP/s)
PEAK_TF32 = 494.7e12
#: dense bf16 tensor-core rate (FLOP/s)
PEAK_BF16 = 989.4e12
#: HBM3 bandwidth (bytes/s)
PEAK_HBM = 3.35e12
#: the tensor-core peak a model step in a mix's dtype is held to
PEAK = {"float32": PEAK_TF32, "bfloat16": PEAK_BF16}


def forward_flops_per_token(cfg: dict) -> float:
    """Model FLOPs of one token through the model: 2 x the parameters
    that enter a matmul, counted by the family's reference
    (``ref/<family>_lm.py:matmul_params``).  ``cfg`` is a configuration
    file's ``sizes``."""
    from perfbench.ref.train import family

    return 2.0 * family(cfg["family"]).matmul_params(cfg)


def train_flops_per_token(cfg: dict) -> float:
    """Model FLOPs of one training token: forward and backward, 3 x the
    forward's; recomputation is not counted."""
    return 3.0 * forward_flops_per_token(cfg)


def sc_mac_flops(m: int, k: int, n: int) -> float:
    """The moment law's three float32 products x.w, |x|.|w| and x^2.w^2
    of an (m, k) @ (k, n) call; its noise is no input the law needs."""
    return 6.0 * m * k * n


def sc_mac_bytes(m: int, k: int, n: int) -> float:
    """x and w read once, the float32 output written once."""
    return 4.0 * (m * k + k * n + m * n)


def sc_mac_bound_s(m: int, k: int, n: int) -> float:
    """Least time of one kernel-5 call on the card."""
    return max(sc_mac_flops(m, k, n) / PEAK_TF32,
               sc_mac_bytes(m, k, n) / PEAK_HBM)
