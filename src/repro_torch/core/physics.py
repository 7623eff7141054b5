"""SOT-MRAM stochastic-switching physics (paper Eq. 3) and the
device-realism profile.

Port of ``repro.core.physics``.  A bit under a write pulse of current
``I`` (relative to the critical current ``I_c``) and duration ``tau``
(ns) stays unswitched with probability

    P_usw(tau, I) = exp(-tau * exp(-Delta * (1 - I / I_c)))

(``Delta = 60.9``, ``I_c = 80 uA``).  At the paper's operating point
``I = I_c`` a survival probability ``P`` is programmed by
``tau = -ln(P)``.

:class:`DeviceProfile` is the one device knob: frozen manufacturing
spread of ``Delta`` / ``I_c`` per cell plus stuck-at and retention bit
error rates, realized as per-cell maps (:func:`cell_maps`) from the
pinned Threefry counter stream at key ``(seed, _MAP_SALT)``.  The maps
are built in numpy float64 from the port's Threefry words, the same
arithmetic as the reference's, so they are bit-equal to it.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

# Paper constants (Section II-B).
DELTA = 60.9  # thermal-stability parameter of the MTJ
I_C_UA = 80.0  # critical switching current, micro-amps

# Salt of the profile's variation/fault stream: with ``seed`` it forms
# the Threefry key.  Part of the bit-reproducibility contract (the
# reference's value): changing it re-rolls every variation map.
_MAP_SALT = 0x00DE51CE

# Lanes of the map stream (the counter's second word): 0/1 feed the
# Box-Muller pair behind the (Delta, I_c) gaussians, 2 places the
# stuck-at faults.
_LANE_BM1, _LANE_BM2, _LANE_STUCK = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Frozen description of one SOT-MRAM array's non-idealities.

    Cell ``c`` perturbs the nominal parameters with frozen spread —
    ``Delta_c = delta * (1 + sigma_delta * g1(c))``,
    ``I_c,c = i_c_ua * (1 + sigma_ic * g2(c))`` with standard gaussians
    from the counter stream at counter ``c``.  Fault rates are per-cell
    probabilities: ``ber_stuck0`` reads 0, ``ber_stuck1`` reads 1 (both
    frozen), ``ber_retention`` flips a read (redrawn every operation).
    Virtual cell ``v`` wraps to physical cell ``v % map_cells``.
    """

    delta: float = DELTA
    i_c_ua: float = I_C_UA
    sigma_delta: float = 0.0
    sigma_ic: float = 0.0
    ber_stuck0: float = 0.0
    ber_stuck1: float = 0.0
    ber_retention: float = 0.0
    seed: int = 0
    map_cells: int = 1 << 18

    def __post_init__(self):
        if self.ber_stuck0 + self.ber_stuck1 > 1.0:
            raise ValueError("ber_stuck0 + ber_stuck1 must be <= 1")
        for f in (
            "sigma_delta",
            "sigma_ic",
            "ber_stuck0",
            "ber_stuck1",
            "ber_retention",
        ):
            if getattr(self, f) < 0:
                raise ValueError(f"{f} must be >= 0")
        if self.map_cells < 1:
            raise ValueError("map_cells must be >= 1")

    @property
    def is_ideal(self) -> bool:
        """True when the profile changes nothing relative to the ideal
        math: at ``I = I_c`` the rate multiplier is exactly 1 for every
        cell when ``sigma_* = 0``, whatever the nominal values."""
        return (
            self.sigma_delta == 0.0
            and self.sigma_ic == 0.0
            and not self.has_faults
        )

    @property
    def has_faults(self) -> bool:
        return (
            self.ber_stuck0 > 0.0
            or self.ber_stuck1 > 0.0
            or self.ber_retention > 0.0
        )

    def replace(self, **kw) -> "DeviceProfile":
        return dataclasses.replace(self, **kw)

    @classmethod
    def ideal(cls) -> "DeviceProfile":
        return cls()


# Named profiles (the serve options' ``fault_profile``).  "tiny" keeps
# map_cells small so tests pay milliseconds for its maps.
DEVICE_PROFILES: dict = {
    "ideal": DeviceProfile(),
    "tiny": DeviceProfile(
        sigma_delta=0.05,
        sigma_ic=0.02,
        ber_stuck0=5e-4,
        ber_stuck1=5e-4,
        ber_retention=1e-4,
        map_cells=1 << 14,
    ),
    "calibrated": DeviceProfile(sigma_delta=0.05, sigma_ic=0.03),
    "harsh": DeviceProfile(
        sigma_delta=0.10,
        sigma_ic=0.05,
        ber_stuck0=2e-3,
        ber_stuck1=2e-3,
        ber_retention=1e-3,
    ),
}


def named_profile(name: str) -> DeviceProfile:
    try:
        return DEVICE_PROFILES[name]
    except KeyError:
        raise KeyError(
            f"unknown device profile {name!r}; available: "
            f"{', '.join(sorted(DEVICE_PROFILES))}"
        ) from None


def resolve_profile(profile) -> DeviceProfile | None:
    """None | name | DeviceProfile -> DeviceProfile | None."""
    if profile is None or isinstance(profile, DeviceProfile):
        return profile
    return named_profile(profile)


@dataclasses.dataclass(frozen=True)
class _CellMaps:
    """Realized per-cell state of one profile (host numpy arrays).

    ``rate`` is the survival-rate exponent: a pulse programmed for
    probability ``p`` survives with ``p**rate`` on this cell (exactly 1
    at ``sigma_* = 0``).  ``cum0`` / ``cum1`` are prefix counts of stuck
    cells, for an exact O(1) census over any wrapped span.
    """

    delta: np.ndarray  # float32 (map_cells,)
    i_c_ua: np.ndarray  # float32 (map_cells,)
    rate: np.ndarray  # float32 (map_cells,)
    stuck0: np.ndarray  # bool (map_cells,)
    stuck1: np.ndarray  # bool (map_cells,)
    cum0: np.ndarray  # int64 (map_cells + 1,)
    cum1: np.ndarray  # int64 (map_cells + 1,)


@functools.lru_cache(maxsize=8)
def cell_maps(profile: DeviceProfile) -> _CellMaps:
    """Build (and cache) the profile's frozen variation and fault maps
    from the counter stream at key ``(seed, _MAP_SALT)``, counter = cell
    index (on the CPU)."""
    from repro_torch.sc import ctr_rng  # sc imports this module

    n = profile.map_cells
    key2 = torch.tensor([profile.seed & 0xFFFFFFFF, _MAP_SALT])
    c0 = torch.arange(n, dtype=torch.int64)

    def lane(c1):
        w = ctr_rng.uniform_words(key2, c0, c1).numpy()
        # uint32 -> open (0, 1): never 0 (log-safe), never 1
        return (w.astype(np.float64) + 0.5) / 2.0**32

    u1, u2 = lane(_LANE_BM1), lane(_LANE_BM2)
    r = np.sqrt(-2.0 * np.log(u1))
    g_delta = r * np.cos(2.0 * np.pi * u2)
    g_ic = r * np.sin(2.0 * np.pi * u2)

    delta_c = profile.delta * (1.0 + profile.sigma_delta * g_delta)
    delta_c = np.maximum(delta_c, 1.0)
    ic_c = profile.i_c_ua * np.maximum(1.0 + profile.sigma_ic * g_ic, 0.05)
    # survival-rate exponent at I = nominal I_c: exp(0) = 1 for every
    # cell when sigma_ic = 0, whatever sigma_delta says
    rate = np.exp(-delta_c * (1.0 - profile.i_c_ua / ic_c))

    uf = lane(_LANE_STUCK)
    stuck0 = uf < profile.ber_stuck0
    stuck1 = (~stuck0) & (uf < profile.ber_stuck0 + profile.ber_stuck1)
    cum0 = np.zeros(n + 1, np.int64)
    cum1 = np.zeros(n + 1, np.int64)
    np.cumsum(stuck0, out=cum0[1:])
    np.cumsum(stuck1, out=cum1[1:])
    return _CellMaps(
        delta=delta_c.astype(np.float32),
        i_c_ua=ic_c.astype(np.float32),
        rate=rate.astype(np.float32),
        stuck0=stuck0,
        stuck1=stuck1,
        cum0=cum0,
        cum1=cum1,
    )


def cell_span(profile: DeviceProfile, n_cells: int, start: int = 0):
    """Physical cell indices (numpy int64) backing ``n_cells`` virtual
    cells from ``start``, wrapping round-robin at ``map_cells``."""
    return (start + np.arange(n_cells, dtype=np.int64)) % profile.map_cells


def stuck_counts(profile: DeviceProfile, n_cells: int, start: int = 0):
    """EXACT (stuck0, stuck1) reads among ``n_cells`` wrapped cell reads
    from virtual cell ``start``: full wraps count the map totals, the
    remainder reads the prefix sums.  O(1)."""
    if profile.is_ideal or n_cells <= 0:
        return 0, 0
    maps = cell_maps(profile)
    m = profile.map_cells
    start %= m
    wraps, rem = divmod(start + n_cells, m)

    def count(cum):
        return wraps * int(cum[-1]) - int(cum[start]) + int(cum[rem])

    return count(maps.cum0), count(maps.cum1)


def mul_cell_params(profile: DeviceProfile, n_muls: int, nbit: int,
                    device=None):
    """Per-cell (delta, i_c_ua) float32 tensors of shape (n_muls, nbit):
    MUL ``q`` occupies virtual cells ``q*nbit .. q*nbit + nbit - 1``."""
    maps = cell_maps(profile)
    idx = cell_span(profile, n_muls * nbit).reshape(n_muls, nbit)
    return (
        torch.from_numpy(maps.delta[idx]).to(device),
        torch.from_numpy(maps.i_c_ua[idx]).to(device),
    )


def _f32(v):
    return torch.as_tensor(v, dtype=torch.float32)


def p_unswitched(tau_ns, i_ua, *, delta=DELTA, i_c_ua=I_C_UA):
    """Paper Eq. 3 — probability the bit survives (remains unswitched),
    float32, broadcast over ``tau_ns`` / ``i_ua`` / per-bit ``i_c_ua``."""
    rate = torch.exp(-delta * (1.0 - _f32(i_ua) / _f32(i_c_ua)))
    return torch.exp(-_f32(tau_ns) * rate)


def tau_for_probability(p, *, i_ua=I_C_UA, delta=DELTA, i_c_ua=I_C_UA):
    """Inverse of Eq. 3 in tau: the pulse duration that yields survival
    probability ``p`` (clipped away from {0, 1}); ``-ln(p)`` at I = I_c."""
    p = torch.clamp(_f32(p), 1e-30, 1.0 - 1e-12)
    rate = torch.exp(-delta * (1.0 - _f32(i_ua) / _f32(i_c_ua)))
    return -torch.log(p) / rate
