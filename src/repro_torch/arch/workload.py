"""Static workload extraction: a ModelConfig's SC-routed matmuls.

Port of ``repro.arch.workload`` for the ported attention families
(dense, moe, vlm): ``dense_workload(cfg, tokens)`` enumerates every
matmul a forward pass routes through ``layers.dense`` /
``expert_dense`` with its per-layer multiplicity (MoE experts as the
dense equivalent of the ``top_k`` visits a token makes, plus the shared
expert), and ``price_workload`` prices the whole pass on the array
without running any numerics.  The SSM / hybrid / frontend sites come
with the rest of the model zoo (ROADMAP queue 1 item 7), the sharded
pricing with the sharded substrate (item 10).
"""

from __future__ import annotations

import dataclasses

from repro_torch.arch.accounting import TraceReport, merge_reports
from repro_torch.arch.backend import schedule_call
from repro_torch.arch.spec import ArraySpec
from repro_torch.core.costmodel import CostParams
from repro_torch.models import lm


@dataclasses.dataclass(frozen=True)
class MatmulSite:
    """One dense() site: (tokens, k) @ (k, n), executed ``count`` times."""

    label: str
    m: int
    k: int
    n: int
    count: int

    @property
    def products(self) -> int:
        return self.m * self.k * self.n * self.count


def dense_workload(cfg, tokens: int) -> list[MatmulSite]:
    """All dense() matmuls of one forward pass over ``tokens`` tokens
    (the reference's site order and labels)."""
    lm.require_ported(cfg)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    count = cfg.n_layers
    wi_cols = 2 * cfg.d_ff if cfg.mlp_variant == "swiglu" else cfg.d_ff
    shapes = [
        ("attn.wq", d, h * hd, count),
        ("attn.wk", d, kvh * hd, count),
        ("attn.wv", d, kvh * hd, count),
        ("attn.wo", h * hd, d, count),
    ]
    if cfg.family == "moe":
        visits = cfg.top_k + (1 if cfg.shared_expert else 0)
        shapes += [
            ("moe.router", d, cfg.n_experts, count),
            ("moe.wi", d, wi_cols, count * visits),
            ("moe.wo", cfg.d_ff, d, count * visits),
        ]
    else:
        shapes += [
            ("mlp.wi", d, wi_cols, count),
            ("mlp.wo", cfg.d_ff, d, count),
        ]
    shapes.append(("unembed", d, cfg.vocab, 1))
    return [MatmulSite(lbl, tokens, k, n, c) for lbl, k, n, c in shapes]


def price_workload(
    sites,
    nbit: int,
    spec: ArraySpec | None = None,
    params: CostParams | None = None,
):
    """Schedule every site on the array and price the whole pass.

    Returns ``(per_site, total)``: ``per_site`` lists ``(site,
    TraceReport)`` with the site's ``count`` folded in, ``total`` merges
    them all.
    """
    per_site: list[tuple[MatmulSite, TraceReport]] = []
    for s in sites:
        one = schedule_call(s.m, s.k, s.n, nbit, spec, params).report
        per_site.append((s, merge_reports([one] * s.count)))
    total = merge_reports(r for _, r in per_site)
    return per_site, total
