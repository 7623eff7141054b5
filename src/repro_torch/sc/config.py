"""Frozen configuration for the SC multiplication substrate.

Port of ``repro.sc.config.ScConfig`` without the Pallas-only fields
(``interpret``, the moment kernel's tiles) and without the device-realism
profile, which comes with the ``array`` backend's slice.  The one tile
size the results depend on, the moment noise's padded width, is a
constant of ``sc/backends.py``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ScConfig:
    """Configuration of one SC matmul substrate (frozen, hashable).

    Attributes:
        backend: name of a backend in the ``repro_torch.sc`` registry
            (``exact``, ``moment``, ``pallas_moment`` or ``pallas_fused``;
            ``pallas_bitexact`` reaches ``pallas_fused`` through
            :func:`~repro_torch.sc.fast_backend`).
        nbit: stochastic bits per scalar product (a multiple of 32).
        operand_bits: resolution of the LUT/DTC operand grid (paper: 10).
        quantize: apply that operand-grid quantization.
    """

    backend: str = "exact"
    nbit: int = 1024
    operand_bits: int = 10
    quantize: bool = True

    def replace(self, **kw) -> "ScConfig":
        """Functional update, e.g. ``cfg.replace(nbit=256)``."""
        return dataclasses.replace(self, **kw)
