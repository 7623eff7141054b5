"""Hardware-variance studies (§IV-B) and the logarithm-multiplier
baseline.

Port of ``repro.core.variance``.  Two fluctuation sources of the paper:

* **σ(I_c)**: per-cell critical-current spread.  MUL accuracy stays
  flat up to 10 % (Fig. 8a): the fluctuations average out over the nbit
  cells.
* **σ(Circuits)**: timing / gain error of the conversion circuits — a
  multiplicative Gaussian on each DTC pulse for SC, and on the log and
  antilog stages of the logarithm multiplier, whose antilog
  exponentiates its input error (Fig. 8b).

The Gaussian draws are ``ctr_rng.normal`` under the reference's key
splits: equal to its ``jax.random.normal`` within ~1e-5 (``erfinv``'s
rounding).  Entry points take ``device=None`` (the card unless the
caller asks for the CPU).
"""

from __future__ import annotations

import warnings

import torch

from repro_torch import resolve_device
from repro_torch.core import conversion, engine, physics
from repro_torch.sc import ctr_rng


def _taus(x_int, y_int, conv, dev):
    return (conversion.operand_to_tau(x_int, conv, dev),
            conversion.operand_to_tau(y_int, conv, dev))


def sc_mul_with_profile(key, x_int, y_int, cfg: engine.EngineConfig,
                        profile: physics.DeviceProfile, device=None):
    """One SC MUL on a realized device: per-cell (Delta, I_c) from the
    profile's frozen maps, shared with the ``array`` backend; batched
    operands occupy consecutive MUL cell banks.  Returns p_est."""
    dev = resolve_device(device)
    tau_x, tau_y = _taus(x_int, y_int, cfg.conv, dev)
    state = engine.sc_multiply_states(key, tau_x, tau_y, cfg,
                                      profile=profile, device=dev)
    return engine.readout(state)


def sc_mul_with_ic_variance(key, x_int, y_int, cfg: engine.EngineConfig,
                            sigma_ic: float, device=None):
    """One SC MUL with per-cell I_c ~ N(I_c, (sigma_ic·I_c)²), drawn anew
    every call.  Returns p_est.

    .. deprecated:: describe the spread with
       ``physics.DeviceProfile(sigma_ic=...)`` and call
       :func:`sc_mul_with_profile`, whose per-cell draw is frozen and
       shared with the ``array`` backend.
    """
    warnings.warn(
        "sc_mul_with_ic_variance is deprecated; use sc_mul_with_profile "
        "with physics.DeviceProfile(sigma_ic=...)",
        DeprecationWarning,
        stacklevel=2,
    )
    dev = resolve_device(device)
    kx, kv = ctr_rng.split(ctr_rng.raw_key(key).to(dev))
    tau_x, tau_y = _taus(x_int, y_int, cfg.conv, dev)
    batch = tuple(torch.broadcast_shapes(tau_x.shape, tau_y.shape))
    g = ctr_rng.normal(kv, batch + (cfg.nbit,))
    ic = torch.clamp_min(physics.I_C_UA * (1.0 + sigma_ic * g), 1e-3)
    state = engine.sc_multiply_states(kx, tau_x, tau_y, cfg, i_c_ua=ic,
                                      device=dev)
    return engine.readout(state)


def sc_mul_with_circuit_variance(key, x_int, y_int, cfg: engine.EngineConfig,
                                 sigma_circ: float, device=None):
    """One SC MUL with DTC timing noise: τ -> τ·(1 + N(0, σ²)) per
    pulse.  Returns p_est."""
    dev = resolve_device(device)
    kx, kt1, kt2 = ctr_rng.split(ctr_rng.raw_key(key).to(dev), 3)
    tau_x, tau_y = _taus(x_int, y_int, cfg.conv, dev)
    tau_x = tau_x * (1.0 + sigma_circ * ctr_rng.normal(kt1, tau_x.shape))
    tau_y = tau_y * (1.0 + sigma_circ * ctr_rng.normal(kt2, tau_y.shape))
    state = engine.sc_multiply_states(
        kx, torch.clamp_min(tau_x, 0.0), torch.clamp_min(tau_y, 0.0), cfg,
        device=dev)
    return engine.readout(state)


def log_multiplier(key, x_int, y_int, conv_cfg: conversion.ConversionConfig,
                   sigma_circ: float, device=None):
    """Logarithm-multiplication baseline (ref [15]) with circuit
    variance: X·Y = antilog(ln X + ln Y), where each stage's error is
    referred to the exponent's full scale (``n·ln 2``), so the antilog
    multiplies the output by ``exp(ε·n·ln 2)`` whatever the operands.
    Returns the estimated product probability."""
    dev = resolve_device(device)
    k1, k2, k3 = ctr_rng.split(ctr_rng.raw_key(key).to(dev), 3)
    px = conversion.encode_probability(x_int, conv_cfg, dev)
    py = conversion.encode_probability(y_int, conv_cfg, dev)
    px = torch.clamp(px, 1e-9, 1.0)
    py = torch.clamp(py, 1e-9, 1.0)
    # float32 ln 2, as the reference's jnp.log(2.0)
    full_scale = conv_cfg.n_bits * torch.log(
        torch.tensor(2.0, dtype=torch.float32, device=dev))
    lx = torch.log(px) + sigma_circ * full_scale * ctr_rng.normal(k1, px.shape)
    ly = torch.log(py) + sigma_circ * full_scale * ctr_rng.normal(k2, py.shape)
    s = (lx + ly) + sigma_circ * full_scale * ctr_rng.normal(k3, px.shape)
    return torch.exp(s)


def mul_uncertainty(p_estimates, p_true) -> torch.Tensor:
    """σ of the error distribution (the paper's 'MUL uncertainty'),
    the population standard deviation as ``jnp.std``."""
    err = torch.as_tensor(p_estimates) - torch.as_tensor(p_true)
    return torch.std(err, correction=0)
