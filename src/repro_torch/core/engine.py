"""Bit-exact simulator of the SOT-MRAM stochastic-computing MUL engine
(paper §III-B).

Port of ``repro.core.engine``.  The hardware sequence per MUL (Fig. 5):

    1. PRESET    — every cell to "1";
    2. PULSE τ_X — each cell survives (stays "1") w.p. P_usw(τ_X);
    3. PULSE τ_Y — surviving cells survive again w.p. P_usw(τ_Y);
    4. READ      — the fraction of "1"s estimates P_X · P_Y ∝ X·Y.

Each pulse draws one ``uniform`` per cell of the whole state from
``sc/ctr_rng.py``, bit-equal to the reference's ``jax.random.uniform``
under the same key; keys split with ``ctr_rng.split`` and ``mac_rows``
chains ``fold_in(key, 1)`` per step as the reference's ``lax.scan``
does.  The survival probabilities are float32 ``exp``, which XLA and
ATen round differently by one ulp for some pulses, so a cell state can
differ from the reference's only where its uniform falls between the
two packages' probabilities.  State is ``uint8``.

The entry points take ``device=None`` (``repro_torch.resolve_device``:
the card unless the caller asks for the CPU); keys and operands move
there.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.core import conversion, physics
from repro_torch.sc import ctr_rng


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """One MRAM sub-array acting as an SC engine."""

    nbit: int = 1024  # stochastic bits per MUL (2^n for n-bit operands)
    conv: conversion.ConversionConfig = conversion.ConversionConfig()
    # a physical row holds at most this many cells (§III-D IR drop); nbit
    # cells occupy ceil(nbit / row) rows written together
    row_length: int = 256

    @property
    def rows_per_mul(self) -> int:
        return -(-self.nbit // self.row_length)


def preset(shape, device=None) -> torch.Tensor:
    """Step 1: all cells to '1' (a strong deterministic reverse pulse)."""
    return torch.ones(shape, dtype=torch.uint8, device=resolve_device(device))


def apply_pulse(key, state, tau_ns, *, i_ua=physics.I_C_UA,
                i_c_ua=physics.I_C_UA, delta=physics.DELTA):
    """One stochastic write pulse on every cell of ``state`` (on its
    device).  ``tau_ns`` broadcasts against ``state``; ``i_c_ua`` and
    ``delta`` may be per-cell tensors.  A cell at "1" survives w.p.
    P_usw; a cell at "0" stays "0" (the pulse drives toward "0" only)."""
    p_survive = physics.p_unswitched(tau_ns, i_ua, delta=delta, i_c_ua=i_c_ua)
    u = ctr_rng.uniform(key.to(state.device), state.shape)
    return state * (u < p_survive.to(state.device)).to(state.dtype)


def readout(state) -> torch.Tensor:
    """Step 4: pop-count -> probability estimate (fraction of 1s)."""
    return torch.sum(state, dim=-1, dtype=torch.float32) / state.shape[-1]


def _batch_shape(*xs) -> tuple:
    return tuple(torch.broadcast_shapes(*(x.shape for x in xs)))


def sc_multiply(key, x_int, y_int, cfg: EngineConfig, device=None):
    """Full §III MUL between unsigned n-bit operands, bit-exact.

    Returns ``(p_est, product)``: ``p_est ≈ P_X·P_Y`` and the decoded
    2n-bit product ``round(p_est · 2^{2n})`` (int32).  Operands may be
    tensors of batched MULs, each with its own ``nbit`` cells.
    """
    dev = resolve_device(device)
    x = conversion.as_tensor(x_int, torch.int64, dev)
    y = conversion.as_tensor(y_int, torch.int64, dev)
    cells = _batch_shape(x, y) + (cfg.nbit,)
    tau_x = conversion.operand_to_tau(x, cfg.conv)
    tau_y = conversion.operand_to_tau(y, cfg.conv)
    kx, ky = ctr_rng.split(ctr_rng.raw_key(key).to(dev))
    state = preset(cells, dev)
    state = apply_pulse(kx, state, tau_x[..., None])
    state = apply_pulse(ky, state, tau_y[..., None])
    p_est = readout(state)
    levels_sq = cfg.conv.levels * cfg.conv.levels
    return p_est, torch.round(p_est * levels_sq).to(torch.int32)


def _profile_cells(profile: physics.DeviceProfile, batch_shape, nbit: int,
                   device=None):
    """Realized per-cell (delta, i_c) of a batch of MULs: MUL ``q``
    occupies virtual cells ``q*nbit ..`` of the profile's frozen map, the
    spread the ``array`` backend reads."""
    n_muls = 1
    for d in batch_shape:
        n_muls *= int(d)
    delta_c, ic_c = physics.mul_cell_params(profile, n_muls, nbit, device)
    shape = tuple(batch_shape) + (nbit,)
    return delta_c.reshape(shape), ic_c.reshape(shape)


def sc_multiply_states(key, tau_x, tau_y, cfg: EngineConfig, *,
                       i_c_ua=physics.I_C_UA, profile=None, device=None):
    """Pulses already converted; returns the raw ``uint8`` cell states.

    ``profile`` (a :class:`physics.DeviceProfile`) supplies realized
    per-cell (Delta, I_c) from its frozen maps and overrides ``i_c_ua``;
    the operating current is then its nominal I_c.  Variation only:
    stuck-at and retention faults belong to the array readout.
    """
    dev = resolve_device(device)
    tau_x = conversion.as_tensor(tau_x, torch.float32, dev)
    tau_y = conversion.as_tensor(tau_y, torch.float32, dev)
    batch = _batch_shape(tau_x, tau_y)
    delta, i_ua = physics.DELTA, physics.I_C_UA
    if isinstance(i_c_ua, torch.Tensor):
        i_c_ua = i_c_ua.to(dev)
    if profile is not None:
        delta, i_c_ua = _profile_cells(profile, batch, cfg.nbit, dev)
        i_ua = profile.i_c_ua
    kx, ky = ctr_rng.split(ctr_rng.raw_key(key).to(dev))
    state = preset(batch + (cfg.nbit,), dev)
    state = apply_pulse(kx, state, tau_x[..., None], i_ua=i_ua,
                        i_c_ua=i_c_ua, delta=delta)
    return apply_pulse(ky, state, tau_y[..., None], i_ua=i_ua,
                       i_c_ua=i_c_ua, delta=delta)


def mac_rows(key, w_int, x_int, cfg: EngineConfig, device=None):
    """Paper §III-C vectored MAC: each MUL ``w_i·x_i`` in its own
    sub-array; returns the per-MUL states stacked on axis 0 (the
    pop-count strategies of ``core/popcount.py`` read them).  Step ``i``
    draws from the key chain ``k_0 = key``, ``k_{i+1} = fold_in(k_i, 1)``
    (the reference's ``lax.scan`` carry)."""
    dev = resolve_device(device)
    w = conversion.as_tensor(w_int, torch.int64, dev)
    x = conversion.as_tensor(x_int, torch.int64, dev)
    if w.shape != x.shape:
        raise ValueError(f"w {tuple(w.shape)} and x {tuple(x.shape)} differ")
    k = ctr_rng.raw_key(key).to(dev)
    states = []
    for wi, xi in zip(w, x):
        states.append(sc_multiply_states(
            k, conversion.operand_to_tau(wi, cfg.conv),
            conversion.operand_to_tau(xi, cfg.conv), cfg, device=dev))
        k = ctr_rng.fold_in(k, 1)
    return torch.stack(states)
