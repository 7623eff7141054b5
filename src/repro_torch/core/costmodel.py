"""Analytical cycle / energy / area model (paper §V, Figs. 9-11).

Port of ``repro.core.costmodel`` (pure Python; a copy, without the
reference's backward-compatible module-level aliases of the default
knob values).

The paper evaluates four designs on 10-bit × 10-bit MUL (2^10 stochastic bits):

  * SC+PIM (APC)  — this work, pop-count via one-cycle APC
  * SC+PIM (CSA)  — this work, pop-count via in-memory CSA+FA, amortized
                    over a 100-MUL MAC
  * SC            — conventional stochastic computing with the
                    state-of-the-art SNG [21] + APC pop-count
  * PIM           — MUL from in-memory bitwise Boolean ops only (DRISA [6])

Like the paper (which has no silicon), this is an *analytical* model built
from published component anchors, with the remaining free constants
calibrated so the published headline ratios emerge:

  anchors: DRISA 143 cycles @ 8-bit MUL, quadratic shift-add scaling;
           DTC: 22 ps resolution, 75×25 µm² [19]; APC one cycle [16];
           SNG = 95 % of conventional-SC area [21]; SC energy 88 % buffering;
  headlines reproduced: ≈4× cycles vs SC, ≈18× vs PIM (10-bit),
           ≈58 % energy saving vs SC, ≈10× area saving vs SC.

Every constant is a field of the frozen :class:`CostParams` dataclass, so a
parameter sweep is ``CostParams(row_length=512)`` — hashable and usable as
a dict key; every model function takes ``params=DEFAULT_PARAMS``.
The array-level simulator (:mod:`repro_torch.arch`) consumes the same
``CostParams`` to price its command traces, so the closed-form figures here
and the per-workload traces there can never drift apart.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import popcount


@dataclasses.dataclass(frozen=True)
class CostParams:
    """Every §V model knob, frozen and hashable (sweep via ``replace``)."""

    # --------------------------- cycle-model knobs --------------------------
    row_length: int = 256             # cross-point row cells (IR-drop, §III-D)
    sa_read_cycles: int = 2           # sense + latch, parallel across banks
    bank_merge_per_level: int = 1     # adder-tree merge of per-bank APC counts
    preset_cycles: int = 1            # strong reverse pulse, all rows parallel
    pulse_cycles: int = 1             # one stochastic write pulse (row-parallel)
    sng_bits_per_cycle: int = 128     # LFSR bank width of the SNG [21]
    sng_shuffle_factor: float = 2.0   # decorrelation shuffle (both streams) [21]
    drisa_8bit_cycles: int = 143      # DRISA anchor [6] — the PIM baseline

    # --------------------------- energy-model knobs (pJ) --------------------
    r_hml_ohm: float = 250.0          # heavy-metal-layer write-path resistance
    i_c_a: float = 80e-6              # critical current
    pulse_tau_ns: float = 0.5         # mean stochastic pulse duration (P≈0.5)
    preset_tau_ns: float = 3.0        # preset pulse duration
    preset_i_factor: float = 1.25     # preset over-drive
    dtc_energy_pj: float = 0.2        # per conversion [19]
    lut_read_pj: float = 0.1          # per lookup
    apc_energy_pj: float = 0.5        # per pop-count
    csa_op_pj: float = 0.05           # per in-memory bulk bitwise op
    sram_buffer_pj_per_bit: float = 0.0108   # conventional-SC buffering
    sng_gen_pj_per_bit: float = 0.0012       # SNG generation energy [21]
    pim_op_pj: float = 0.10           # DRISA bulk bitwise op energy

    # --------------------------- area-model knobs (µm²) ---------------------
    dtc_area_um2: float = 75.0 * 25.0          # [19]
    apc_area_um2: float = 2100.0      # synthesized 45 nm FreePDK, from [16]
    and_buffer_area_um2: float = 700.0         # SC AND array + latches
    sng_area_fraction: float = 0.95   # SNG share of conventional SC area [21]
    mram_cell_area_um2: float = 0.10  # LUT storage cell
    pim_logic_area_um2: float = 1500.0         # DRISA-style subarray logic

    def replace(self, **kw) -> "CostParams":
        return dataclasses.replace(self, **kw)

    # ------------------------- derived per-event costs ----------------------
    def write_energy_pj(self, tau_ns: float, i_factor: float = 1.0) -> float:
        """Joule heating per cell: I²·R·τ, in pJ."""
        i = self.i_c_a * i_factor
        return (i * i) * self.r_hml_ohm * (tau_ns * 1e-9) * 1e12

    def preset_energy_pj_per_cell(self) -> float:
        return self.write_energy_pj(self.preset_tau_ns, self.preset_i_factor)

    def pulse_energy_pj_per_cell(self) -> float:
        return self.write_energy_pj(self.pulse_tau_ns)

    def conversion_energy_pj_per_operand(self) -> float:
        """One LUT lookup + one DTC launch (§III-A chain, per operand)."""
        return self.dtc_energy_pj + self.lut_read_pj

    def rows_per_mul(self, n_bits: int) -> int:
        """Sub-array rows one 2^n-bit MUL occupies (IR-drop row limit)."""
        return -(-(1 << n_bits) // self.row_length)

    def merge_cycles(self, rows: int) -> int:
        """Log-depth adder tree merging per-row APC counts into one sum."""
        if rows <= 1:
            return 0
        return self.bank_merge_per_level * math.ceil(math.log2(rows))


DEFAULT_PARAMS = CostParams()

@dataclasses.dataclass(frozen=True)
class MulCost:
    cycles: float
    energy_pj: float
    area_um2: float
    breakdown: dict


def _rows(n_bits: int, params: CostParams = DEFAULT_PARAMS) -> int:
    return params.rows_per_mul(n_bits)


# ---------------------------------------------------------------------------
# Cycles (Fig. 9)
# ---------------------------------------------------------------------------


def cycles_scpim_apc(n_bits: int = 10,
                     params: CostParams = DEFAULT_PARAMS) -> float:
    """This work, APC pop-count. LUT+DTC conversion is pipelined (§III-D).

    The 2^n stochastic bits live in ``rows`` sub-array rows written AND
    sensed in parallel (each bank has its own SAs — the multi-row activation
    of §III-D); per-bank APC counts merge through a log-depth adder tree.
    This is what makes Fig. 9b ~flat in operand bit length."""
    rows = _rows(n_bits, params)
    return (params.preset_cycles + 2 * params.pulse_cycles
            + params.sa_read_cycles + popcount.apc_cycles(1)
            + params.merge_cycles(rows))


def cycles_scpim_csa(n_bits: int = 10, n_mac: int = 100,
                     params: CostParams = DEFAULT_PARAMS) -> float:
    """This work, CSA+FA pop-count amortized over an n_mac MAC (Fig. 6):
    constant lock-step fold per MUL + one FA resolve per MAC."""
    nbit = 1 << n_bits
    per_mul_popcount = popcount.csa_fa_cycles_per_mul(
        n_mac, nbit, row_length=params.row_length)
    return (params.preset_cycles + 2 * params.pulse_cycles
            + per_mul_popcount)


def cycles_sc(n_bits: int = 10, params: CostParams = DEFAULT_PARAMS) -> float:
    """Conventional SC: SNG-generated bitstreams + APC.

    Two 2^n-bit streams from the shared SNG bank, plus the decorrelation
    shuffle the paper notes pseudo-random streams need; AND is fused into the
    stream, APC closes.
    """
    nbit = 1 << n_bits
    gen = 2 * nbit / params.sng_bits_per_cycle
    shuffle = params.sng_shuffle_factor * nbit / params.sng_bits_per_cycle
    return gen + shuffle + popcount.apc_cycles(1)


def cycles_pim(n_bits: int = 10, params: CostParams = DEFAULT_PARAMS) -> float:
    """Bitwise-Boolean in-memory MUL (DRISA): quadratic shift-add scaling
    from the published 8-bit / 143-cycle anchor."""
    return math.ceil(params.drisa_8bit_cycles * (n_bits / 8) ** 2)


# ---------------------------------------------------------------------------
# Energy (Fig. 10)
# ---------------------------------------------------------------------------


def _write_energy_pj(tau_ns: float, i_factor: float = 1.0,
                     params: CostParams = DEFAULT_PARAMS) -> float:
    """Joule heating per cell: I²·R·τ, in pJ."""
    return params.write_energy_pj(tau_ns, i_factor)


def energy_scpim(n_bits: int = 10, popcount_kind: str = "apc",
                 n_mac: int = 100,
                 params: CostParams = DEFAULT_PARAMS) -> tuple[float, dict]:
    nbit = 1 << n_bits
    init = nbit * params.preset_energy_pj_per_cell()
    pulses = 2 * nbit * params.pulse_energy_pj_per_cell()
    convert = 2 * params.conversion_energy_pj_per_operand()
    if popcount_kind == "apc":
        pc = params.apc_energy_pj
    else:
        ops = popcount.csa_fa_cycles_per_mul(n_mac, nbit,
                                             row_length=params.row_length)
        pc = ops * params.csa_op_pj
    bd = {"init": init, "sc_pulses": pulses, "conversion": convert, "popcount": pc}
    return sum(bd.values()), bd


def energy_sc(n_bits: int = 10,
              params: CostParams = DEFAULT_PARAMS) -> tuple[float, dict]:
    nbit = 1 << n_bits
    gen = 2 * nbit * params.sng_gen_pj_per_bit
    buffering = 2 * nbit * params.sram_buffer_pj_per_bit   # 88 %-class share
    pc = params.apc_energy_pj
    bd = {"sng_generation": gen, "buffering": buffering, "popcount": pc}
    return sum(bd.values()), bd


def energy_pim(n_bits: int = 10,
               params: CostParams = DEFAULT_PARAMS) -> tuple[float, dict]:
    ops = cycles_pim(n_bits, params)
    bd = {"bitwise_ops": ops * params.pim_op_pj}
    return sum(bd.values()), bd


# ---------------------------------------------------------------------------
# Area (Fig. 11)
# ---------------------------------------------------------------------------


def area_scpim(n_bits: int = 10, popcount_kind: str = "apc",
               params: CostParams = DEFAULT_PARAMS) -> tuple[float, dict]:
    lut_bits = (1 << n_bits) * 16               # 2^n entries × 16-bit fixed point
    lut = lut_bits * params.mram_cell_area_um2
    bd = {"dtc": params.dtc_area_um2, "lut": lut}
    if popcount_kind == "apc":
        bd["apc"] = params.apc_area_um2
    else:
        bd["csa_fa_logic"] = 0.15 * params.apc_area_um2  # FA column + control
    return sum(bd.values()), bd


def area_sc(n_bits: int = 10,
            params: CostParams = DEFAULT_PARAMS) -> tuple[float, dict]:
    non_sng = params.apc_area_um2 + params.and_buffer_area_um2
    sng = non_sng * params.sng_area_fraction / (1.0 - params.sng_area_fraction)
    bd = {"sng": sng, "apc": params.apc_area_um2,
          "and_buffers": params.and_buffer_area_um2}
    return sum(bd.values()), bd


def area_pim(n_bits: int = 10,
             params: CostParams = DEFAULT_PARAMS) -> tuple[float, dict]:
    return params.pim_logic_area_um2, {"subarray_logic": params.pim_logic_area_um2}


# ---------------------------------------------------------------------------
# Summary table (what benchmarks/fig9..11 print)
# ---------------------------------------------------------------------------


def full_comparison(n_bits: int = 10, n_mac: int = 100,
                    params: CostParams = DEFAULT_PARAMS) -> dict[str, MulCost]:
    e_apc, bd_e_apc = energy_scpim(n_bits, "apc", params=params)
    e_csa, bd_e_csa = energy_scpim(n_bits, "csa", n_mac, params=params)
    e_sc, bd_e_sc = energy_sc(n_bits, params)
    e_pim, bd_e_pim = energy_pim(n_bits, params)
    a_apc, bd_a_apc = area_scpim(n_bits, "apc", params)
    a_csa, bd_a_csa = area_scpim(n_bits, "csa", params)
    a_sc, bd_a_sc = area_sc(n_bits, params)
    a_pim, bd_a_pim = area_pim(n_bits, params)
    return {
        "SC+PIM (APC)": MulCost(cycles_scpim_apc(n_bits, params), e_apc, a_apc,
                                {"energy": bd_e_apc, "area": bd_a_apc}),
        "SC+PIM (CSA)": MulCost(cycles_scpim_csa(n_bits, n_mac, params), e_csa,
                                a_csa, {"energy": bd_e_csa, "area": bd_a_csa}),
        "SC": MulCost(cycles_sc(n_bits, params), e_sc, a_sc,
                      {"energy": bd_e_sc, "area": bd_a_sc}),
        "PIM": MulCost(cycles_pim(n_bits, params), e_pim, a_pim,
                       {"energy": bd_e_pim, "area": bd_a_pim}),
    }


def headline_ratios(n_bits: int = 10,
                    params: CostParams = DEFAULT_PARAMS) -> dict[str, float]:
    """The paper's headline comparisons at its own anchor points.

    ``speedup_vs_pim`` follows the paper's framing: their 10-bit SC-MUL
    against the PUBLISHED DRISA number ("143 cycles to calculate an 8-bit
    multiplication") — 143 / ~8 = ~18x. The same-bit-width (10-bit) ratio is
    also reported for honesty; it is LARGER (DRISA scales quadratically)."""
    ours = cycles_scpim_apc(n_bits, params)
    e_ours, _ = energy_scpim(n_bits, "apc", params=params)
    e_sc, _ = energy_sc(n_bits, params)
    a_ours, _ = area_scpim(n_bits, "apc", params)
    a_sc, _ = area_sc(n_bits, params)
    return {
        "speedup_vs_sc": cycles_sc(n_bits, params) / ours,
        "speedup_vs_pim": cycles_pim(8, params) / ours,   # the paper's anchor
        "speedup_vs_pim_same_bits": cycles_pim(n_bits, params) / ours,
        "energy_saving_vs_sc": 1.0 - e_ours / e_sc,
        "area_ratio_sc_over_ours": a_sc / a_ours,
    }
