"""Accounting engine: walk a command trace and price it with CostParams.

Port of ``repro.arch.accounting`` (pure Python; a copy).

Energy rules mirror :func:`repro_torch.core.costmodel.energy_scpim` exactly, so a
single-product trace prices to the same picojoules as the closed-form
model (tests pin this):

    PRESET    cells × I²R·τ_preset (over-driven)
    PULSE_X   cells × I²R·τ_pulse  +  one LUT+DTC conversion per product
    PULSE_Y   same as PULSE_X (second operand)
    READ      free (folded into the APC charge, as in the closed form)
    POPCOUNT  one APC charge per product
    MERGE     free (adder tree folded into the APC charge)

Cycles are the trace makespan. Utilization metrics report how well the
workload kept the chip busy: ``subarray_util`` is occupied subarray-cycles
over offered subarray-cycles; ``cell_occupancy`` is live cells over offered
cells in the rows the commands actually touched.
"""

from __future__ import annotations

import dataclasses

from repro_torch.arch.schedule import Command, makespan
from repro_torch.arch.spec import ArraySpec
from repro_torch.core.costmodel import CostParams, DEFAULT_PARAMS


@dataclasses.dataclass(frozen=True)
class TraceReport:
    """What one call (or an aggregate of calls) cost on the array."""

    cycles: int
    energy_pj: float
    products: int
    subarray_util: float        # occupied subarray-cycles / offered
    cell_occupancy: float       # live cells / cells in touched rows
    cycles_by_op: dict
    energy_by_op: dict

    @property
    def energy_nj(self) -> float:
        return self.energy_pj * 1e-3

    @property
    def cycles_per_product(self) -> float:
        return self.cycles / self.products if self.products else 0.0

    @property
    def energy_pj_per_product(self) -> float:
        return self.energy_pj / self.products if self.products else 0.0


def _command_energy_pj(c: Command, params: CostParams) -> float:
    if c.op == "PRESET":
        return c.cells * params.preset_energy_pj_per_cell()
    if c.op in ("PULSE_X", "PULSE_Y"):
        return (c.cells * params.pulse_energy_pj_per_cell()
                + c.products * params.conversion_energy_pj_per_operand())
    if c.op == "POPCOUNT":
        return c.products * params.apc_energy_pj
    return 0.0      # READ / MERGE folded into the APC charge (closed form)


def account(trace: tuple[Command, ...], spec: ArraySpec,
            params: CostParams = DEFAULT_PARAMS) -> TraceReport:
    """Price a compiled trace on ``spec`` hardware with ``params`` knobs."""
    total_cycles = makespan(trace)
    cycles_by_op: dict = {}
    energy_by_op: dict = {}
    energy = 0.0
    products = 0
    busy_subarray_cycles = 0
    live_cells = 0
    row_cells = 0
    for c in trace:
        cycles_by_op[c.op] = cycles_by_op.get(c.op, 0) + c.total_cycles
        e = _command_energy_pj(c, params) * c.repeat
        energy_by_op[c.op] = energy_by_op.get(c.op, 0.0) + e
        energy += e
        if c.op == "POPCOUNT":      # count each product once per wave issue
            products += c.products * c.repeat
        busy_subarray_cycles += c.subarrays * c.total_cycles
        live_cells += c.cells * c.repeat
        row_cells += c.subarrays * c.rows * spec.row_length * c.repeat
    offered = spec.subarrays * total_cycles
    return TraceReport(
        cycles=total_cycles, energy_pj=energy, products=products,
        subarray_util=busy_subarray_cycles / offered if offered else 0.0,
        cell_occupancy=live_cells / row_cells if row_cells else 0.0,
        cycles_by_op=cycles_by_op, energy_by_op=energy_by_op)


def merge_concurrent_reports(reports) -> TraceReport:
    """Aggregate reports of calls running AT THE SAME TIME on disjoint
    mesh slices (one report per shard of a sharded ``sc_dot``).

    Shards are concurrent banks, not queued calls: the makespan is the
    slowest shard (max, not sum), energy and products add, and the per-op
    cycle breakdown adds (it counts op-cycles *executed* across the
    combined hardware, like busy-cycles — so ``cycles_by_op`` may exceed
    ``cycles``, exactly as it does for parallel banks inside one trace).
    ``subarray_util`` re-normalizes busy subarray-cycles against the
    combined offer (n_shards × makespan worth of chips), so idle tails on
    fast shards count against utilization; ``cell_occupancy`` stays a
    cycle-weighted mean (it is defined over touched rows only).
    """
    reports = list(reports)
    if not reports:
        return TraceReport(0, 0.0, 0, 0.0, 0.0, {}, {})
    cycles = max(r.cycles for r in reports)
    n = len(reports)
    cbo: dict = {}
    ebo: dict = {}
    for r in reports:
        for op, c in r.cycles_by_op.items():
            cbo[op] = cbo.get(op, 0) + c
        for op, e in r.energy_by_op.items():
            ebo[op] = ebo.get(op, 0.0) + e
    busy = sum(r.subarray_util * r.cycles for r in reports)
    occ_cycles = sum(r.cycles for r in reports)
    occ = (sum(r.cell_occupancy * r.cycles for r in reports) / occ_cycles
           if occ_cycles else 0.0)
    return TraceReport(
        cycles=cycles,
        energy_pj=sum(r.energy_pj for r in reports),
        products=sum(r.products for r in reports),
        subarray_util=busy / (n * cycles) if cycles else 0.0,
        cell_occupancy=occ,
        cycles_by_op=cbo, energy_by_op=ebo)


def merge_reports(reports) -> TraceReport:
    """Aggregate per-call reports into one (calls serialize on the chip:
    cycles add; utilizations combine cycle-weighted)."""
    reports = list(reports)
    if not reports:
        return TraceReport(0, 0.0, 0, 0.0, 0.0, {}, {})
    cycles = sum(r.cycles for r in reports)
    cbo: dict = {}
    ebo: dict = {}
    for r in reports:
        for op, c in r.cycles_by_op.items():
            cbo[op] = cbo.get(op, 0) + c
        for op, e in r.energy_by_op.items():
            ebo[op] = ebo.get(op, 0.0) + e
    wsum = lambda attr: (sum(getattr(r, attr) * r.cycles for r in reports)
                         / cycles if cycles else 0.0)
    return TraceReport(
        cycles=cycles,
        energy_pj=sum(r.energy_pj for r in reports),
        products=sum(r.products for r in reports),
        subarray_util=wsum("subarray_util"),
        cell_occupancy=wsum("cell_occupancy"),
        cycles_by_op=cbo, energy_by_op=ebo)


def report_dict(r: TraceReport) -> dict:
    """JSON-ready view (benchmark artifacts, serve trace dumps)."""
    return {
        "cycles": r.cycles,
        "energy_pj": round(r.energy_pj, 3),
        "products": r.products,
        "cycles_per_product": round(r.cycles_per_product, 4),
        "energy_pj_per_product": round(r.energy_pj_per_product, 4),
        "subarray_util": round(r.subarray_util, 4),
        "cell_occupancy": round(r.cell_occupancy, 4),
        "cycles_by_op": dict(r.cycles_by_op),
        "energy_by_op": {k: round(v, 3) for k, v in r.energy_by_op.items()},
    }


# ---------------------------------------------------------------------------
# Device-fault census (ROADMAP item 4): price a call's injected bit errors
# ---------------------------------------------------------------------------

def bit_error_census(profile, cells: int, start: int = 0) -> dict:
    """Error budget of ``cells`` cell reads under a device profile.

    Stuck-at counts are EXACT — the profile's fault map is frozen, so the
    census is a prefix-sum lookup over the wrapped cell span, not a
    sample (``core/physics.py:stuck_counts``).  Retention flips redraw
    per read, so their entry is the rounded expectation — deterministic
    given (profile, cells), which is what lets CI gate
    ``arch_bit_errors_total`` exactly.
    """
    from repro_torch.core import physics
    s0, s1 = physics.stuck_counts(profile, cells, start)
    return {
        "cells": cells,
        "stuck0": s0,
        "stuck1": s1,
        "retention": int(round(profile.ber_retention * cells)),
    }


def subarray_error_masks(profile, spec: ArraySpec) -> list[dict]:
    """Per-subarray stuck-fault masks for one wave over ``spec``.

    Subarray ``s`` owns physical cells ``[s*cps, (s+1)*cps)`` of the
    profile's map (wrapping when the chip is larger than ``map_cells``);
    each entry reports that subarray's stuck-cell population — the mask
    the scheduler would program around on a mapped part, and the
    per-shard breakdown behind ``arch_bit_errors_total``.
    """
    cps = spec.cells_per_subarray
    return [
        {"subarray": s, **{k: v for k, v in
                           bit_error_census(profile, cps, s * cps).items()
                           if k != "retention"}}
        for s in range(spec.subarrays)
    ]
