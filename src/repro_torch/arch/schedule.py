"""Pulse-schedule compiler: lower a TilePlan to a command trace.

Port of ``repro.arch.schedule`` (pure Python; a copy).

One wave of the engine executes the §III-D sequence on every active
subarray simultaneously (multi-row activation; banks fully parallel):

    PRESET    strong reverse pulse, all occupied rows at once
    PULSE_X   stochastic write pulse for the X operands (one DTC launch
              per product, durations differ per row, one cycle budget)
    PULSE_Y   second pulse — in-place AND with the surviving X bits
    READ      sense + latch every occupied row (per-bank SAs)
    POPCOUNT  per-row APC counts, one cycle, parallel
    MERGE     log-depth adder tree folding one product's per-row counts
              (absent when a product fits a single row)

Waves serialize — that is the bank/subarray conflict accounting: a call
bigger than one wave reuses the same cells and pays the full sequence
again. Identical full waves are folded into a single command row with a
``repeat`` count, so a trace is O(1) in matmul size while still being an
exact record of what the hardware would issue.
"""

from __future__ import annotations

import dataclasses

from repro_torch.arch.tiler import TilePlan
from repro_torch.core.costmodel import CostParams, DEFAULT_PARAMS

#: Command opcodes in issue order within a wave.
OPS = ("PRESET", "PULSE_X", "PULSE_Y", "READ", "POPCOUNT", "MERGE")


@dataclasses.dataclass(frozen=True)
class Command:
    """One (possibly folded) trace row.

    ``cycles`` is the duration of a single issue; ``repeat`` folds identical
    issues from consecutive steady-state waves. ``subarrays``/``rows`` count
    the parallel footprint of one issue; ``cells``/``products`` are the live
    stochastic bits / scalar MULs one issue covers (energy accounting).
    """

    op: str
    cycles: int
    repeat: int
    subarrays: int
    rows: int            # occupied rows per active subarray
    cells: int           # live cells across the chip for one issue
    products: int        # scalar MULs covered by one issue

    @property
    def total_cycles(self) -> int:
        return self.cycles * self.repeat


def _wave_commands(plan: TilePlan, params: CostParams, subarrays: int,
                   products: int, repeat: int) -> list[Command]:
    """The §III-D sequence for one wave shape, folded ``repeat`` times."""
    if products == 0 or repeat == 0:
        return []
    rows = -(-products // subarrays) * plan.rows_per_product
    cells = products * plan.nbit
    mk = lambda op, cyc: Command(op=op, cycles=cyc, repeat=repeat,
                                 subarrays=subarrays, rows=rows, cells=cells,
                                 products=products)
    cmds = [
        mk("PRESET", params.preset_cycles),
        mk("PULSE_X", params.pulse_cycles),
        mk("PULSE_Y", params.pulse_cycles),
        mk("READ", params.sa_read_cycles),
        mk("POPCOUNT", 1),           # per-row APCs fire together, one cycle
    ]
    merge = params.merge_cycles(plan.rows_per_product)
    if merge:
        cmds.append(mk("MERGE", merge))
    return cmds


def compile_schedule(plan: TilePlan,
                     params: CostParams = DEFAULT_PARAMS) -> tuple[Command, ...]:
    """Lower ``plan`` to its command trace (full waves folded, then tail)."""
    if plan.spec.row_length != params.row_length:
        raise ValueError(
            f"ArraySpec.row_length={plan.spec.row_length} disagrees with "
            f"CostParams.row_length={params.row_length}; the trace would "
            "price rows the tiler never allocated")
    trace = _wave_commands(plan, params, plan.spec.subarrays,
                           plan.products_per_wave, plan.full_waves)
    trace += _wave_commands(plan, params, max(plan.tail_subarrays, 1),
                            plan.tail_products, 1 if plan.tail_products else 0)
    return tuple(trace)


def makespan(trace: tuple[Command, ...]) -> int:
    """Total cycles of the trace (commands within a call serialize; all
    spatial parallelism is already inside each command)."""
    return sum(c.total_cycles for c in trace)


def format_trace(trace: tuple[Command, ...], limit: int = 16) -> str:
    """Human-readable trace table (the format README documents)."""
    head = (f"{'op':<9s} {'cyc':>4s} {'rep':>6s} {'subarr':>6s} "
            f"{'rows':>5s} {'cells':>10s} {'products':>9s}")
    lines = [head, "-" * len(head)]
    for c in trace[:limit]:
        lines.append(f"{c.op:<9s} {c.cycles:>4d} {c.repeat:>6d} "
                     f"{c.subarrays:>6d} {c.rows:>5d} {c.cells:>10d} "
                     f"{c.products:>9d}")
    if len(trace) > limit:
        lines.append(f"... ({len(trace) - limit} more commands)")
    lines.append(f"makespan = {makespan(trace)} cycles")
    return "\n".join(lines)
