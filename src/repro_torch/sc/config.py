"""Frozen configuration for the SC multiplication substrate.

Port of ``repro.sc.config``: ``ScConfig`` without the Pallas-only fields
(``interpret``, the moment kernel's tiles; the one tile size the results
depend on, the moment noise's padded width, is a constant of
``sc/backends.py``), plus the ambient device profile
(:func:`use_device_profile`).
"""

from __future__ import annotations

import contextlib
import dataclasses

from repro_torch.core.physics import DeviceProfile


@dataclasses.dataclass(frozen=True)
class ScConfig:
    """Configuration of one SC matmul substrate (frozen, hashable).

    Attributes:
        backend: name of a backend in the ``repro_torch.sc`` registry
            (``exact``, ``moment``, ``bitexact``, ``pallas_moment``,
            ``pallas_bitexact``, ``pallas_fused`` or ``array``).
        nbit: stochastic bits per scalar product.
        operand_bits: resolution of the LUT/DTC operand grid (paper: 10).
        quantize: apply that operand-grid quantization.
        device: device-realism profile (``core/physics.py``).  None or
            an ideal profile is bit-identical to the ideal math on every
            backend; a non-ideal one is realized by ``array`` only.
    """

    backend: str = "exact"
    nbit: int = 1024
    operand_bits: int = 10
    quantize: bool = True
    device: DeviceProfile | None = None

    def replace(self, **kw) -> "ScConfig":
        """Functional update, e.g. ``cfg.replace(nbit=256)``."""
        return dataclasses.replace(self, **kw)


# Ambient device profile: one knob for call sites that build their own
# ScConfig (``models/layers.py:dense``, and through it the serve engine,
# which enters this scope around each tick).
_PROFILE_STACK: list = []


@contextlib.contextmanager
def use_device_profile(profile: DeviceProfile | None):
    """Scope under which internally built ``ScConfig``s carry
    ``device=profile``; ``None`` is a no-op."""
    if profile is None:
        yield
        return
    _PROFILE_STACK.append(profile)
    try:
        yield
    finally:
        _PROFILE_STACK.pop()


def current_device_profile() -> DeviceProfile | None:
    """Innermost :func:`use_device_profile` scope, or None."""
    return _PROFILE_STACK[-1] if _PROFILE_STACK else None
