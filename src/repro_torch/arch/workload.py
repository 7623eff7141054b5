"""Static workload extraction: a ModelConfig's SC-routed matmuls.

Port of ``repro.arch.workload``: ``dense_workload(cfg, tokens)``
enumerates every matmul a forward pass routes through ``layers.dense`` /
``expert_dense`` with its per-layer multiplicity (MoE experts as the
dense equivalent of the ``top_k`` visits a token makes, plus the shared
expert; the Mamba2 projections per backbone layer; zamba2's shared
attention and MLP per invocation; the embeddings frontend's projection
once), and ``price_workload`` prices the whole pass on the array
without running any numerics; ``price_workload_sharded`` prices it
executed on a ``data x model`` mesh (each site as one shard's slice,
the shards merged as concurrent banks), as ``sc.sc_dot_sharded`` runs
it.  The attention score / value products and the SSM scan are not
``dense`` calls and are absent.
"""

from __future__ import annotations

import dataclasses

from repro_torch.arch.accounting import (
    TraceReport,
    merge_concurrent_reports,
    merge_reports,
)
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
    (the reference's site order and labels; the layer counts come from
    the ``lm`` assembly)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    wi_cols = 2 * cfg.d_ff if cfg.mlp_variant == "swiglu" else cfg.d_ff

    def attn(count, prefix=""):
        return [
            (prefix + "attn.wq", d, h * hd, count),
            (prefix + "attn.wk", d, kvh * hd, count),
            (prefix + "attn.wv", d, kvh * hd, count),
            (prefix + "attn.wo", h * hd, d, count),
        ]

    def mlp(count, prefix=""):
        return [
            (prefix + "mlp.wi", d, wi_cols, count),
            (prefix + "mlp.wo", cfg.d_ff, d, count),
        ]

    if cfg.family in lm.STATE_FAMILIES:
        di, n = cfg.d_inner, lm.n_backbone_layers(cfg)
        shapes = [
            ("ssm.wz", d, di, n),
            ("ssm.wx", d, di, n),
            ("ssm.wB", d, cfg.ssm_state, n),
            ("ssm.wC", d, cfg.ssm_state, n),
            ("ssm.wdt", d, cfg.ssm_heads, n),
            ("ssm.out", di, d, n),
        ]
        if cfg.family == "hybrid":
            shared = lm.n_shared_invocations(cfg)
            shapes += attn(shared, "shared.") + mlp(shared, "shared.")
    else:
        count = cfg.n_layers
        shapes = attn(count)
        if cfg.family == "moe":
            visits = cfg.top_k + (1 if cfg.shared_expert else 0)
            shapes += [
                ("moe.router", d, cfg.n_experts, count),
                ("moe.wi", d, wi_cols, count * visits),
                ("moe.wo", cfg.d_ff, d, count * visits),
            ]
        else:
            shapes += mlp(count)
    if cfg.frontend == "embeddings":
        shapes.append(("frontend.proj", d, d, 1))
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


def shard_site(site: MatmulSite, data: int = 1, model: int = 1) -> MatmulSite:
    """One mesh slice's share of ``site`` under the SC sharding rules:
    rows (m) split over the ``data`` span, contraction (k) over ``model``
    (ceil-division — indivisible dims cost the padded shard)."""
    def ceil(a, b):
        return -(-a // b)

    return dataclasses.replace(site, m=ceil(site.m, max(data, 1)),
                               k=ceil(site.k, max(model, 1)))


def price_workload_sharded(
    sites,
    nbit: int,
    *,
    data: int = 1,
    model: int = 1,
    spec: ArraySpec | None = None,
    params: CostParams | None = None,
):
    """Price a workload executed mesh-sharded: ``data x model`` chips,
    each running one shard of every matmul concurrently.

    Each site is priced as its per-shard slice (:func:`shard_site`), the
    shard reports merge as CONCURRENT banks (makespan = slowest shard,
    energy and products add; the SUM merge itself is free, like MERGE in
    the single-chip trace), and sites serialize as usual.  With ``data
    == model == 1`` this is exactly :func:`price_workload`.  Returns
    ``(per_site, total)`` shaped like :func:`price_workload`.
    """
    n_shards = max(data, 1) * max(model, 1)
    per_site: list[tuple[MatmulSite, TraceReport]] = []
    for s in sites:
        piece = shard_site(s, data, model)
        one = schedule_call(piece.m, piece.k, piece.n, nbit, spec,
                            params).report
        sharded = merge_concurrent_reports([one] * n_shards)
        per_site.append((s, merge_reports([sharded] * s.count)))
    total = merge_reports(r for _, r in per_site)
    return per_site, total
