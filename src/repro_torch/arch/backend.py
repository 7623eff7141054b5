"""The ``array`` SC backend: run sc_dot "on the hardware".

Port of ``repro.arch.backend``.  Registered lazily in the
``repro_torch.sc`` registry (importing this module registers it), so
``ScConfig(backend="array")`` works with no explicit import.  Each call
is tiled onto the active :class:`~repro_torch.arch.spec.ArraySpec`,
compiled to a pulse schedule, priced by the accountant and recorded to
every installed trace collector — once per executed call (PyTorch has
no compile step; see :mod:`repro_torch.arch.trace`).  The schedule
depends only on shapes, so :func:`schedule_call` is cached per
(m, k, n, nbit, spec, params) and pricing a repeated shape is a lookup.

Numerics reuse the registered engines per size class, with the
reference's caps:

* ≤ ``_PALLAS_CELL_CAP`` cells (nbit % 32 == 0): the packed engine
  ``pallas_bitexact`` (CUDA kernel ``csrc/sc_mul.cu``);
* ≤ ``_BITEXACT_PRODUCT_CAP`` products: the binomial ``bitexact``;
* larger: the CLT ``moment`` backend.

A non-ideal ``cfg.device`` profile replaces them with
:func:`_device_numerics`.  The active ArraySpec / CostParams are ambient
(``use_spec`` / ``use_params``).  The sharded substrate is not ported,
so every call prices one shard.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import obs
from repro_torch.arch import accounting, trace
from repro_torch.arch.schedule import compile_schedule
from repro_torch.arch.spec import DEFAULT_SPEC, ArraySpec
from repro_torch.arch.tiler import tile_matmul
from repro_torch.core import physics
from repro_torch.core.costmodel import DEFAULT_PARAMS, CostParams
from repro_torch.sc import backends as sc_backends
from repro_torch.sc import ctr_rng, encoding
from repro_torch.sc.config import ScConfig
from repro_torch.sc.registry import register_backend

# Numerics size classes (cells = products × nbit).
_PALLAS_CELL_CAP = 1 << 16  # packed engine (O(cells/8) bytes of words)
_BITEXACT_PRODUCT_CAP = 1 << 21  # binomial engine (O(products) floats)

# Device-realism size classes (non-ideal cfg.device only): calls up to
# this many cells read the realized per-cell maps; larger calls model
# the cell population through the map's rate quantiles.
_DEVICE_CELL_CAP = 1 << 20
_RATE_QUANTILES = 16
# Elements of the large branch's (M, K, N_chunk, quantiles) power tensor
# per step: columns are walked in chunks to bound its memory.
_DEVICE_CHUNK = 1 << 27

_SPEC_STACK: list[ArraySpec] = [DEFAULT_SPEC]
_PARAMS_STACK: list[CostParams] = [DEFAULT_PARAMS]


def current_spec() -> ArraySpec:
    return _SPEC_STACK[-1]


def current_params() -> CostParams:
    return _PARAMS_STACK[-1]


@contextlib.contextmanager
def use_spec(spec: ArraySpec):
    """Scope the array geometry the ``array`` backend schedules onto."""
    _SPEC_STACK.append(spec)
    try:
        yield spec
    finally:
        _SPEC_STACK.pop()


@contextlib.contextmanager
def use_params(params: CostParams):
    """Scope the cost knobs the accountant prices traces with."""
    _PARAMS_STACK.append(params)
    try:
        yield params
    finally:
        _PARAMS_STACK.pop()


@functools.lru_cache(maxsize=4096)
def _schedule(m, k, n, nbit, spec, params) -> trace.CallRecord:
    plan = tile_matmul(m, k, n, nbit, spec)
    cmds = compile_schedule(plan, params)
    report = accounting.account(cmds, spec, params)
    return trace.CallRecord(plan=plan, trace=cmds, report=report)


def schedule_call(
    m: int,
    k: int,
    n: int,
    nbit: int,
    spec: ArraySpec | None = None,
    params: CostParams | None = None,
) -> trace.CallRecord:
    """Tile + compile + price one (m, k) @ (k, n) call (cached: records
    are frozen, so one shape's record is shared)."""
    spec = spec if spec is not None else current_spec()
    params = params if params is not None else current_params()
    return _schedule(m, k, n, nbit, spec, params)


def _numerics(key, x, w, cfg: ScConfig):
    if cfg.device is not None and not cfg.device.is_ideal:
        return _device_numerics(key, x, w, cfg)
    products = x.shape[0] * x.shape[1] * w.shape[1]
    cells = products * cfg.nbit
    if cfg.nbit % 32 == 0 and cells <= _PALLAS_CELL_CAP:
        return sc_backends.pallas_bitexact(key, x, w, cfg)
    if products <= _BITEXACT_PRODUCT_CAP:
        return sc_backends.bitexact(key, x, w, cfg)
    return sc_backends.moment(key, x, w, cfg)


@functools.lru_cache(maxsize=8)
def _rate_quantiles(profile: physics.DeviceProfile) -> np.ndarray:
    """Fixed 16-point quantile summary of the profile's realized
    survival-rate map (float32)."""
    maps = physics.cell_maps(profile)
    qs = (np.arange(_RATE_QUANTILES) + 0.5) / _RATE_QUANTILES
    return np.quantile(maps.rate.astype(np.float64), qs).astype(np.float32)


def _device_numerics(key, x, w, cfg: ScConfig):
    """Stochastic estimate under a NON-ideal device profile.

    A cell of rate exponent ``r`` survives a pulse programmed for ``p``
    with probability ``p**r``.  Calls of ≤ ``_DEVICE_CELL_CAP`` cells
    read their wrapped span of the frozen maps: Bernoulli(p**r_c) per
    cell, retention flips, then stuck-at overrides, then the mean.
    Larger calls collapse the cells to the map's rate quantiles and draw
    the CLT count with the closed-form stuck / retention densities; the
    noise is ``normal(key, (M, K, N))`` read column chunk by column
    chunk at the draw's flat indices, so chunking changes no drawn
    element (only, by an ulp, the float32 order of the sums).
    """
    prof = cfg.device
    sx, px, scx = encoding.encode(x, cfg)
    sw, pw, scw = encoding.encode(w, cfg)
    m, k = x.shape
    n = w.shape[1]
    if m * k * n * cfg.nbit <= _DEVICE_CELL_CAP:
        est = _realized_cells(key, px, pw, prof, cfg.nbit)
        out = torch.sum(sx[:, :, None] * sw[None] * est, dim=1)
    else:
        out = _cell_population(key, sx, px, sw, pw, prof, cfg.nbit)
    return out * (scx * scw)


def _realized_cells(key, px, pw, prof, nbit: int):
    """(M, K, N) mean surviving bits over each product's realized cells."""
    dev = px.device
    m, k = px.shape
    n = pw.shape[1]
    maps = physics.cell_maps(prof)
    idx = physics.cell_span(prof, m * k * n * nbit).reshape(m, k, n, nbit)

    def cells(arr):  # numpy gather: uint32-free, any device
        return torch.from_numpy(arr[idx]).to(dev)

    p_prod = torch.clamp(px[:, :, None] * pw[None], 0.0, 1.0)
    pc = p_prod[..., None] ** cells(maps.rate)
    key_b, key_f = ctr_rng.split(key)
    bits = ctr_rng.uniform(key_b, pc.shape, device=dev) < pc
    if prof.ber_retention > 0.0:
        f = torch.tensor(prof.ber_retention, dtype=torch.float32)
        bits ^= ctr_rng.uniform(key_f, pc.shape, device=dev) < f.to(dev)
    if prof.ber_stuck0 > 0.0:
        bits &= ~cells(maps.stuck0)
    if prof.ber_stuck1 > 0.0:
        bits |= cells(maps.stuck1)
    return torch.mean(bits.to(torch.float32), dim=-1)


def _cell_population(key, sx, px, sw, pw, prof, nbit: int):
    """Signed (M, N) sums of the large branch's CLT estimates."""
    dev = px.device
    m, k = px.shape
    n = pw.shape[1]
    maps = physics.cell_maps(prof)
    rq = torch.from_numpy(_rate_quantiles(prof)).to(dev)
    s0 = float(maps.cum0[-1]) / prof.map_cells
    s1 = float(maps.cum1[-1]) / prof.map_cells
    f = prof.ber_retention
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    step = max(1, _DEVICE_CHUNK // (m * k * _RATE_QUANTILES))
    base = torch.arange(m * k, dtype=torch.int64, device=dev)[:, None] * n
    for j0 in range(0, n, step):
        j1 = min(n, j0 + step)
        p_prod = torch.clamp(px[:, :, None] * pw[None, :, j0:j1], 0.0, 1.0)
        # profiler ranges: the powers' and the noise's shares of a call
        with record_function("array.powers"):
            pv = torch.mean(p_prod[..., None] ** rq, dim=-1)
        p_read = (1.0 - s0 - s1) * (pv * (1.0 - f) + (1.0 - pv) * f) + s1
        cols = torch.arange(j0, j1, dtype=torch.int64, device=dev)
        with record_function("array.noise"):
            noise = ctr_rng.normal_at(key, base + cols)
        noise = noise.reshape(p_read.shape)
        var = p_read * (1.0 - p_read) / nbit
        est = p_read + noise * torch.sqrt(var)
        sign = sx[:, :, None] * sw[None, :, j0:j1]
        out[:, j0:j1] = torch.sum(sign * est, dim=1)
    return out


def _note_bit_errors(profile: physics.DeviceProfile, cells: int) -> None:
    """Export one call's fault census (``accounting.bit_error_census``)
    to the default registry as ``arch_bit_errors_total{kind,shard}``
    (one shard: the sharded substrate is not ported)."""
    reg = obs.default_registry()
    if not reg.enabled:
        return
    census = accounting.bit_error_census(profile, cells)
    c = reg.counter(
        "arch_bit_errors_total",
        "modeled bit errors injected at the array backend, by fault kind",
    )
    for kind in ("stuck0", "stuck1", "retention"):
        c.inc(census[kind], kind=kind, shard="1")


def _note_pricing(rec: trace.CallRecord) -> None:
    """Fold one priced call into the observability hooks: cycle / energy
    counters in the default registry (disabled by default) and the
    report's headline numbers onto the innermost open trace span."""
    rep = rec.effective_report
    reg = obs.default_registry()
    if reg.enabled:
        reg.counter(
            "arch_sc_dot_calls_total", "array-backend calls priced"
        ).inc()
        reg.counter(
            "arch_cycles_total", "modeled array cycles across priced calls"
        ).inc(rep.cycles)
        reg.counter(
            "arch_energy_pj_total",
            "modeled array energy (pJ) across priced calls",
        ).inc(rep.energy_pj)
    tr = obs.current_tracer()
    if tr is not None and tr.enabled:
        tr.attr(
            arch_cycles=rep.cycles,
            arch_energy_pj=round(rep.energy_pj, 3),
            arch_shards=rec.shards,
        )


@register_backend("array")
def array(key, x, w, cfg: ScConfig):
    """Array-level execution: schedule + price (when a collector
    listens), then the size-matched numerics."""
    m, k = x.shape
    n = w.shape[1]
    if trace.active():
        rec = schedule_call(m, k, n, cfg.nbit)
        trace.record(rec)
        _note_pricing(rec)
    else:
        # a call the active spec cannot hold fails even untraced
        tile_matmul(m, k, n, cfg.nbit, current_spec())
    if cfg.device is not None and not cfg.device.is_ideal:
        _note_bit_errors(cfg.device, m * k * n * cfg.nbit)
    return _numerics(key, x, w, cfg)
