"""Tiler: decompose an ``sc_dot(x, w)`` call onto the array hierarchy.

Port of ``repro.arch.tiler`` (pure Python; a copy).

An (M, K) @ (K, N) SC matmul is M·K·N independent scalar MULs, each
claiming its own bank of ``nbit`` cells (= ``rows_per_product`` rows in ONE
subarray, so the product's APC merge tree stays subarray-local). The tiler
packs those products into **waves**: one wave fills every subarray of the
chip with as many products as fit; successive waves reuse the same cells
(that reuse is the bank/subarray conflict the scheduler charges for).

Because every full wave is identical (same command sequence, same active
cell count), the plan stores {geometry, full-wave count, tail wave} rather
than a per-product list — O(1) memory however large the matmul, which is
what lets the serve engine price production shapes. ``iter_tiles`` expands
the plan into per-(wave, subarray) tiles for tests and small-shape
inspection.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

from repro_torch.arch.spec import ArraySpec, DEFAULT_SPEC


@dataclasses.dataclass(frozen=True)
class Tile:
    """One subarray's share of one wave: ``products`` MULs side by side."""

    wave: int
    bank: int
    subarray: int          # index within the bank
    products: int
    rows: int              # rows occupied (products × rows_per_product)
    cells: int             # active cells (products × nbit; rows may be partial)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The full mapping of one matmul call onto an ArraySpec."""

    m: int
    k: int
    n: int
    nbit: int
    spec: ArraySpec
    products: int                # m·k·n scalar MULs
    rows_per_product: int
    products_per_subarray: int   # wave capacity of one subarray
    waves: int                   # total waves (ceil)
    full_waves: int              # waves with every subarray at capacity
    tail_products: int           # products in the final partial wave (0 if none)

    @property
    def products_per_wave(self) -> int:
        return self.products_per_subarray * self.spec.subarrays

    @property
    def tail_subarrays(self) -> int:
        """Subarrays active in the tail wave."""
        if self.tail_products == 0:
            return 0
        return -(-self.tail_products // self.products_per_subarray)

    @property
    def cells_touched(self) -> int:
        """Total cell-writes of the call (products × nbit, preset excluded)."""
        return self.products * self.nbit


def tile_matmul(m: int, k: int, n: int, nbit: int,
                spec: ArraySpec = DEFAULT_SPEC) -> TilePlan:
    """Plan the wave decomposition of an (m, k) @ (k, n) call at ``nbit``."""
    for name, v in (("m", m), ("k", k), ("n", n)):
        if v <= 0:
            raise ValueError(f"matmul dim {name} must be positive, got {v}")
    products = m * k * n
    pps = spec.products_per_subarray(nbit)   # validates nbit vs subarray size
    per_wave = pps * spec.subarrays
    waves = -(-products // per_wave)
    full_waves = products // per_wave
    tail = products - full_waves * per_wave
    return TilePlan(m=m, k=k, n=n, nbit=nbit, spec=spec, products=products,
                    rows_per_product=spec.rows_per_product(nbit),
                    products_per_subarray=pps, waves=waves,
                    full_waves=full_waves, tail_products=tail)


def iter_tiles(plan: TilePlan, max_tiles: int = 100_000) -> Iterator[Tile]:
    """Expand the plan into explicit per-(wave, subarray) tiles.

    Intended for tests / small shapes — raises rather than silently
    truncating if the expansion would exceed ``max_tiles``.
    """
    total = (plan.full_waves * plan.spec.subarrays) + plan.tail_subarrays
    if total > max_tiles:
        raise ValueError(f"plan expands to {total} tiles > max_tiles="
                         f"{max_tiles}; use the aggregate plan fields instead")
    spb = plan.spec.subarrays_per_bank
    for wave in range(plan.waves):
        if wave < plan.full_waves:
            remaining = plan.products_per_wave
        else:
            remaining = plan.tail_products
        for s in range(plan.spec.subarrays):
            take = min(plan.products_per_subarray, remaining)
            if take <= 0:
                break
            remaining -= take
            yield Tile(wave=wave, bank=s // spb, subarray=s % spb,
                       products=take, rows=take * plan.rows_per_product,
                       cells=take * plan.nbit)


def plan_summary(plan: TilePlan) -> dict:
    """Machine-readable one-liner for traces / JSON benchmarks."""
    return {
        "shape": [plan.m, plan.k, plan.n],
        "nbit": plan.nbit,
        "products": plan.products,
        "rows_per_product": plan.rows_per_product,
        "products_per_subarray": plan.products_per_subarray,
        "waves": plan.waves,
        "tail_products": plan.tail_products,
        "spec": dataclasses.asdict(plan.spec),
    }


def occupancy(plan: TilePlan) -> float:
    """Mean fraction of chip cells doing useful work across the call's waves
    (1.0 = every wave fills every subarray row cell with live stochastic
    bits; < 1 from tail waves and from nbit not filling whole rows)."""
    used = plan.products * plan.nbit
    offered = plan.waves * plan.spec.cells
    return used / offered if offered else 0.0
