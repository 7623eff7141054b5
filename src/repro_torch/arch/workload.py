"""Static workload extraction: a ModelConfig's SC-routed matmuls.

Port of ``repro.arch.workload``: ``dense_workload(cfg, tokens)``
enumerates every matmul a forward pass routes through ``layers.dense`` /
``expert_dense`` with its per-layer multiplicity (MoE experts as the
dense equivalent of the ``top_k`` visits a token makes, plus the shared
expert; the Mamba2 projections per backbone layer; zamba2's shared
attention and MLP per invocation; the embeddings frontend's projection
once), and ``price_workload`` prices the whole pass on the array
without running any numerics.  The attention score / value products and
the SSM scan are not ``dense`` calls and are absent.  The sharded
pricing comes with the sharded substrate (ROADMAP queue 1 item 10).
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
