"""Trace collection: record what the ``array`` backend ran, per call.

Port of ``repro.arch.trace``.  The reference records at JAX trace time,
so under ``jit`` each compiled shape contributes ONE record however many
times it later runs.  PyTorch runs eagerly, so here every EXECUTED
``array`` call records (as the reference does outside ``jit``): a serve
engine's bill covers the ticks it ran, where the jitted reference's
covers the shapes it compiled.  Each record's plan, trace and report
equal the reference's for the same shape.

Two ways to listen:

    with arch.collect() as records:          # scoped (benchmarks, tests)
        y = sc.sc_dot(key, x, w, cfg)

    collector = arch.TraceCollector()        # long-lived (serve engine)
    collector.install()
    ...
    collector.uninstall()

Multiple listeners may be active; every record goes to all of them.
"""

from __future__ import annotations

import contextlib
import dataclasses

from repro_torch.arch import accounting
from repro_torch.arch.schedule import Command
from repro_torch.arch.spec import ArraySpec
from repro_torch.arch.tiler import TilePlan, plan_summary


@dataclasses.dataclass(frozen=True)
class CallRecord:
    """One ``sc_dot`` call on the array: plan + trace + price.

    ``shards`` is the mesh-shard multiplicity of the call (set inside
    ``sc.sc_dot_sharded``, whose records are one shard's slice);
    ``effective_report`` merges that many concurrent slices.
    """

    plan: TilePlan
    trace: tuple[Command, ...]
    report: accounting.TraceReport
    shards: int = 1

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.plan.m, self.plan.k, self.plan.n)

    @property
    def effective_report(self) -> accounting.TraceReport:
        if self.shards == 1:
            return self.report
        return accounting.merge_concurrent_reports(
            [self.report] * self.shards
        )

    def as_dict(self) -> dict:
        return {
            "plan": plan_summary(self.plan),
            "shards": self.shards,
            "report": accounting.report_dict(self.report),
        }


class TraceCollector:
    """Accumulates CallRecords from every array-backend call in scope.

    Serving engines also stamp per-request token counts
    (:meth:`note_request`) so :meth:`cost_per_request` can prorate the
    aggregate cost across a mixed batch.
    """

    def __init__(self):
        self.records: list[CallRecord] = []
        self.request_tokens: dict = {}  # request id -> context tokens

    def note_request(self, rid, tokens: int) -> None:
        """Stamp a finished request's total token count (prompt +
        generated).  Re-stamping the same id overwrites."""
        self.request_tokens[rid] = int(tokens)

    def cost_per_request(self) -> dict:
        """Prorate the aggregate cost over the stamped requests:
        ``{rid: {"tokens", "share", "cycles", "energy_pj"}}``, each
        request charged in proportion to its token count (the reference's
        attribution, kept so the two bills compare)."""
        total = sum(self.request_tokens.values())
        if not total:
            return {}
        agg = self.aggregate()
        out = {}
        for rid, tokens in sorted(self.request_tokens.items()):
            share = tokens / total
            out[rid] = {
                "tokens": tokens,
                "share": round(share, 6),
                "cycles": round(agg.cycles * share, 1),
                "energy_pj": round(agg.energy_pj * share, 3),
            }
        return out

    def install(self) -> "TraceCollector":
        if self not in _LISTENERS:
            _LISTENERS.append(self)
        return self

    def uninstall(self) -> None:
        if self in _LISTENERS:
            _LISTENERS.remove(self)

    def clear(self) -> None:
        self.records.clear()
        self.request_tokens.clear()

    def aggregate(self) -> accounting.TraceReport:
        """Serial merge over the recorded calls (each first merged across
        its concurrent shards)."""
        return accounting.merge_reports(
            r.effective_report for r in self.records
        )


_LISTENERS: list[TraceCollector] = []


def record(rec: CallRecord) -> None:
    for listener in _LISTENERS:
        listener.records.append(rec)


def active() -> bool:
    """True when at least one collector is listening (the backend skips
    pricing entirely when nobody is)."""
    return bool(_LISTENERS)


@contextlib.contextmanager
def collect():
    """Scoped collection: yields the live list of CallRecords."""
    c = TraceCollector().install()
    try:
        yield c.records
    finally:
        c.uninstall()


def scaled(
    report: accounting.TraceReport, repeats: int
) -> accounting.TraceReport:
    """Price a record replayed ``repeats`` times."""
    if repeats < 0:
        raise ValueError(f"repeats must be >= 0, got {repeats}")
    return accounting.merge_reports([report] * repeats)


def summarize(records, spec: ArraySpec | None = None) -> dict:
    """JSON-ready roll-up of a record list (benchmarks / serve dumps)."""
    records = list(records)
    agg = accounting.merge_reports(r.effective_report for r in records)
    out = {"calls": len(records), "aggregate": accounting.report_dict(agg)}
    if spec is not None:
        out["spec"] = dataclasses.asdict(spec)
    return out
