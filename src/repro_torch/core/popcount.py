"""Pop-count strategies (§III-C): APC and PIM-based CSA+FA, with cycle models.

Port of ``repro.core.popcount`` (functional pop-counts on tensors; the
cycle models are plain Python, copied as they are).

The MUL outcome lives as stochastic bits in the MRAM array; converting back to
binary is a pop-count. The paper offers two hardware strategies:

* **APC** (approximate parallel counter, ref [16]) — a fully-parallel counter
  tree synthesized next to the sense amplifiers. One clock cycle, large area.
  We model it *functionally exact* (the paper's "approximate" refers to the
  counter's internal approximation for area; accuracy impact is folded into
  the SC noise floor) and charge its area in the cost model.

* **PIM CSA+FA** (two-step, Fig. 6) — for a MAC of many MULs:
    step 1: row-wise carry-save addition (CSA) compresses the per-MUL bit
            rows in lock-step bitwise ops — 3 rows → 2 rows per pass,
            log_{3/2}(rows) passes, each pass a constant number of in-memory
            bitwise cycles;
    step 2: a final column-wise ripple full-adder (FA) resolves the two
            surviving carry-save rows into a binary sum — costs
            O(result-width) cycles but is incurred ONCE per MAC, so its
            latency amortizes over the MULs (Fig. 6's "converges to CSA").

Both strategies return identical sums (CSA+FA is exact); they differ in the
cycle/area accounting, which costmodel.py consumes.
"""

from __future__ import annotations

import math

import torch

# ---------------------------------------------------------------------------
# Functional pop-counts (what the hardware computes)
# ---------------------------------------------------------------------------


def apc_popcount(states) -> torch.Tensor:
    """APC: parallel counter over the last axis. One cycle in hardware."""
    return torch.sum(states.to(torch.int32), dim=-1, dtype=torch.int32)


def csa_compress(rows):
    """One CSA pass: groups of 3 rows -> (sum, carry) pair of rows.

    ``rows``: (R, nbit) uint8/int array of bit-rows. Returns the compressed
    row stack; odd remainders are passed through. Models the in-memory
    lock-step bitwise ops (XOR/AND/shift are the PIM-native instructions).
    """
    r = rows.shape[0]
    groups = r // 3
    out = []
    for g in range(groups):
        a, b, c = rows[3 * g], rows[3 * g + 1], rows[3 * g + 2]
        s = a ^ b ^ c                      # sum bits, weight 1
        carry = (a & b) | (b & c) | (a & c)  # carry bits, weight 2
        out.append(s)
        out.append(carry)                  # carried row is weight-2; tracked below
    for rem in range(3 * groups, r):
        out.append(rows[rem])
    return torch.stack(out) if out else rows


def csa_fa_popcount(states) -> torch.Tensor:
    """Exact two-step pop-count over a MAC: states (M, nbit) -> scalar sum.

    The hardware compresses rows with CSA then resolves with a final FA.
    Functionally that equals the exact sum of all bits across all MULs, which
    is what we return (the approximation error of SC lives in the bits
    themselves, not in this adder). Kept separate from apc_popcount so tests
    can assert both strategies agree bit-for-bit.
    """
    return torch.sum(states.to(torch.int32), dim=(-2, -1), dtype=torch.int32)


# ---------------------------------------------------------------------------
# Cycle models (what the hardware *costs*) — consumed by costmodel.py
# ---------------------------------------------------------------------------

# In-memory bitwise ops per CSA pass: XOR(2 ops: a^b, ^c) + MAJ(3 AND + 2 OR).
# Each lock-step bulk bitwise op = 1 memory cycle (Pinatubo/DRISA style).
CSA_CYCLES_PER_PASS = 7
# Ripple FA resolve: ~1 cycle per result bit plus carry propagation.
FA_CYCLES_PER_BIT = 2
# Cross-point row length (IR-drop limit §III-D) used to split nbit into rows.
ROW_LENGTH = 256


def apc_cycles(n_mul: int = 1) -> int:
    """APC is fully parallel: 1 cycle per MUL readout."""
    return n_mul


def csa_passes(n_rows: int) -> int:
    """CSA passes to compress n rows to 2 (3->2 per pass on the whole stack)."""
    passes = 0
    r = n_rows
    while r > 2:
        r = r - (r // 3)          # 3k rows -> 2k rows (+ remainder)
        passes += 1
    return passes


def rows_per_mul(nbit: int, row_length: int = ROW_LENGTH) -> int:
    return max(1, -(-nbit // row_length))


def csa_fold_cycles(rows: int) -> int:
    """Cycles to fold one MUL's ``rows`` bit-rows into the bank's running
    carry-save pair: lock-step 3:2 passes on (rows + 2) rows -> 2 rows.

    This is the steady-state per-MUL cost the paper's Fig. 6 converges to
    (the MAC keeps one carry-save pair; each finished MUL folds in)."""
    return csa_passes(rows + 2) * CSA_CYCLES_PER_PASS


def csa_fa_cycles(n_mul: int, nbit: int, result_bits: int | None = None,
                  row_length: int = ROW_LENGTH) -> int:
    """Total cycles for the two-step pop-count of a MAC of ``n_mul`` MULs
    (paper Fig. 6): step 1 row-wise CSA folds every MUL's rows into one
    carry-save pair (constant lock-step cost per MUL — independent of the
    row WIDTH, bulk bitwise ops touch all nbit columns at once); step 2 one
    column-wise FA resolve, paid ONCE per MAC."""
    if result_bits is None:
        result_bits = max(1, math.ceil(math.log2(max(2, n_mul * nbit))))
    compress = n_mul * csa_fold_cycles(rows_per_mul(nbit, row_length))
    resolve = FA_CYCLES_PER_BIT * result_bits
    return compress + resolve


def csa_fa_cycles_per_mul(n_mul: int, nbit: int,
                          row_length: int = ROW_LENGTH) -> float:
    """Amortized per-MUL pop-count cycles. Converges (Fig. 6) to the
    constant CSA fold cost as the FA resolve amortizes away."""
    return csa_fa_cycles(n_mul, nbit, row_length=row_length) / max(n_mul, 1)
