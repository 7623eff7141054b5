"""The physical array hierarchy: chip → bank → subarray → 256-cell rows.

Port of ``repro.arch.spec`` (pure Python; a copy).

The paper's engine is not one MUL cell but an *architecture* (§III-D, §V):
cross-point rows capped at 256 cells by IR drop, grouped into subarrays
that share a row decoder and a bank of sense amplifiers + one APC, grouped
into banks that operate fully in parallel and merge their pop-counts
through a log-depth adder tree. ``ArraySpec`` is the frozen description of
that hierarchy; the tiler (:mod:`repro_torch.arch.tiler`) maps ``sc_dot`` calls
onto it and the scheduler (:mod:`repro_torch.arch.schedule`) serializes whatever
doesn't fit.

The same row-parallelism rules as the closed-form model
(:mod:`repro_torch.core.costmodel`) apply: every row of a subarray can be preset
/ pulsed / sensed in ONE command (multi-row activation), different
subarrays never conflict, and a single product's rows always land in one
subarray so its merge tree stays local.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """Chip geometry. Frozen + hashable (usable as a dict key).

    Defaults give a modest 8-bank chip: 8 × 16 subarrays × 64 rows × 256
    cells = 2 M cells — 2048 concurrent 10-bit MULs per wave.
    """

    banks: int = 8
    subarrays_per_bank: int = 16
    rows_per_subarray: int = 64
    row_length: int = 256            # IR-drop row limit (§III-D)

    def __post_init__(self):
        for field in ("banks", "subarrays_per_bank", "rows_per_subarray",
                      "row_length"):
            v = getattr(self, field)
            if not isinstance(v, int) or v <= 0:
                raise ValueError(f"ArraySpec.{field} must be a positive int, "
                                 f"got {v!r}")

    # ------------------------------ totals ---------------------------------
    @property
    def subarrays(self) -> int:
        return self.banks * self.subarrays_per_bank

    @property
    def rows(self) -> int:
        return self.subarrays * self.rows_per_subarray

    @property
    def cells(self) -> int:
        return self.rows * self.row_length

    @property
    def cells_per_subarray(self) -> int:
        return self.rows_per_subarray * self.row_length

    # --------------------------- per-MUL mapping ----------------------------
    def rows_per_product(self, nbit: int) -> int:
        """Rows one nbit-cell MUL occupies (its private cell bank)."""
        if nbit <= 0:
            raise ValueError(f"nbit must be positive, got {nbit}")
        return -(-nbit // self.row_length)

    def products_per_subarray(self, nbit: int) -> int:
        """Concurrent MULs one subarray hosts in a single wave."""
        rpp = self.rows_per_product(nbit)
        if rpp > self.rows_per_subarray:
            raise ValueError(
                f"one {nbit}-bit product needs {rpp} rows but a subarray has "
                f"only {self.rows_per_subarray}; enlarge rows_per_subarray or "
                "lower nbit (cross-subarray products are not modeled)")
        return self.rows_per_subarray // rpp

    def products_per_wave(self, nbit: int) -> int:
        """Concurrent MULs across the whole chip in one wave."""
        return self.products_per_subarray(nbit) * self.subarrays

    def replace(self, **kw) -> "ArraySpec":
        return dataclasses.replace(self, **kw)


DEFAULT_SPEC = ArraySpec()
