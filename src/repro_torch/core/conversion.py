"""Data conversion chain (paper Eq. 4 and §III-A).

    X(binary) --LUT--> ln(X)(binary) --DTC--> tau_X (time) --MRAM--> stochastic
    --popcount--> X*Y (binary)

Port of ``repro.core.conversion``:

* **LUT logarithm**: an ``n``-bit operand indexes a 2^n-entry table of
  ``-ln(X / 2^n)`` values quantized to a fixed-point grid;
* **DTC** (digital-to-time converter): the pulse duration is quantized
  to a multiple of ``DTC_RESOLUTION_NS`` (22 ps).

An unsigned n-bit operand ``X`` maps to ``P_X = X / 2^n``.  The float32
arithmetic follows the reference's order, so the table and every pulse
are bit-equal to it.  Functions compute on the device of their tensor
input; a non-tensor input lands on ``device`` (``None``: the card, as
``repro_torch.resolve_device`` says).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.core import physics

DTC_RESOLUTION_NS = 0.022  # 22 ps (paper §V-A, ref [19])


@dataclasses.dataclass(frozen=True)
class ConversionConfig:
    n_bits: int = 10  # operand bit width (the paper evaluates 10-bit)
    dtc_resolution_ns: float = DTC_RESOLUTION_NS
    lut_fixedpoint_bits: int = 16  # fixed-point width of the stored -ln
    max_tau_ns: float = 16.0  # DTC full-scale range

    @property
    def levels(self) -> int:
        return 1 << self.n_bits


def as_tensor(x, dtype, device=None) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor: on ``device`` when given, else on the
    device of a tensor ``x``, else on the card."""
    if device is None and isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(device))


def encode_probability(x_int, cfg: ConversionConfig, device=None):
    """n-bit unsigned integer -> survival probability P = X / 2^n."""
    return as_tensor(x_int, torch.float32, device) / cfg.levels


def decode_probability(p, cfg: ConversionConfig, device=None):
    """Probability estimate -> nearest n-bit integer (the pop-count
    readout); ``torch.round`` is half-to-even like ``jnp.round``."""
    p = as_tensor(p, torch.float32, device)
    q = torch.clamp(torch.round(p * cfg.levels), 0, cfg.levels - 1)
    return q.to(torch.int32)


def build_lut(cfg: ConversionConfig, device=None) -> torch.Tensor:
    """The -ln LUT stored in hardware: entry[i] = -ln(i / 2^n), quantized.

    Entry 0 (P = 0) is the DTC full-scale pulse, which switches the bit
    (almost) deterministically: multiply-by-zero.
    """
    dev = resolve_device(device)
    i = torch.arange(cfg.levels, dtype=torch.float32, device=dev)
    p = torch.where(i == 0, 1.0, i) / cfg.levels
    tau = -torch.log(p)
    tau = torch.where(i == 0, cfg.max_tau_ns, tau)
    scale = (1 << cfg.lut_fixedpoint_bits) / cfg.max_tau_ns
    return torch.round(tau * scale) / scale


def dtc_quantize(tau_ns, cfg: ConversionConfig, device=None):
    """DTC pulses on a 22 ps grid, saturating at full scale."""
    res = cfg.dtc_resolution_ns
    tau = torch.clamp(as_tensor(tau_ns, torch.float32, device), 0.0,
                      cfg.max_tau_ns)
    return torch.round(tau / res) * res


def operand_to_tau(x_int, cfg: ConversionConfig, device=None):
    """The §III-A chain: n-bit integer -> LUT lookup -> DTC pulse."""
    x = as_tensor(x_int, torch.int64, device)
    return dtc_quantize(build_lut(cfg, x.device)[x], cfg)


def tau_to_probability(tau_ns, *, i_ua=physics.I_C_UA):
    """What the device does with the pulse (Eq. 3 at the operating
    current)."""
    return physics.p_unswitched(tau_ns, i_ua)


def ideal_product_probability(x_int, y_int, cfg: ConversionConfig,
                              device=None):
    """P_X * P_Y with no LUT / DTC quantization (float math)."""
    return (encode_probability(x_int, cfg, device)
            * encode_probability(y_int, cfg, device))


def quantized_product_probability(x_int, y_int, cfg: ConversionConfig,
                                  device=None):
    """P_usw(tau_X) * P_usw(tau_Y) with the LUT fixed point and the DTC
    grid: the deterministic (bias) part of the hardware error."""
    px = tau_to_probability(operand_to_tau(x_int, cfg, device))
    py = tau_to_probability(operand_to_tau(y_int, cfg, device))
    return px * py
