"""Structured trace spans: name + wall ns + duration + attrs + parent.

The port's copy of ``repro.obs.trace``.  A :class:`Tracer` records
:class:`Span` rows into memory; serving engines open a span per tick and
emit zero-duration events per request lifecycle step (submit → admit →
prefill chunks → decode ticks → evict/resume → finish), and dispatch
instrumentation annotates the innermost open span via
:meth:`Tracer.attr`.  Export is JSONL (one span per line, stable field
names) and the rows convert losslessly to a Chrome ``trace_event`` file
(:func:`to_chrome`) viewable in ``chrome://tracing`` / Perfetto.

Timestamps are ``time.perf_counter_ns()`` — monotonic wall ns, so
durations are exact and ordering holds within one process; spans carry
the recording thread id as ``tid``.  Host spans do not wait for the
device: a span around asynchronous CUDA work measures the enqueue unless
the code inside synchronises.

The module-global tracer slot (:func:`install_tracer` /
:func:`current_tracer`) lets code that cannot be handed a tracer (backend
dispatch) still reach the active one; when none is installed the lookup
is one global read.  :data:`NULL_TRACER` is an always-off tracer engines
default to, so instrumentation sites need no None checks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time


@dataclasses.dataclass
class Span:
    """One recorded span.  ``dur_ns == 0`` marks an instant event."""

    name: str
    t0_ns: int
    dur_ns: int
    attrs: dict
    span_id: int
    parent_id: int | None
    tid: int

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "t0_ns": self.t0_ns,
            "dur_ns": self.dur_ns,
            "attrs": self.attrs,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "tid": self.tid,
        }


class Tracer:
    """Records spans; enabled unless constructed otherwise.

    Thread-safe: the span list is lock-guarded and the open-span stack
    (parentage + ``attr`` targeting) is thread-local.
    """

    def __init__(self, enabled: bool = True, clock=time.perf_counter_ns):
        self.enabled = enabled
        self.spans: list[Span] = []
        self._clock = clock
        self._lock = threading.Lock()
        self._local = threading.local()
        self._next_id = 1

    # ------------------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _alloc(self) -> int:
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            return sid

    def _record(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Timed span around a block; yields the open Span (attrs are
        mutable until exit).  Nesting sets ``parent_id``."""
        if not self.enabled:
            yield _NULL_SPAN
            return
        stack = self._stack()
        parent = stack[-1].span_id if stack else None
        s = Span(
            name=name,
            t0_ns=self._clock(),
            dur_ns=0,
            attrs=dict(attrs),
            span_id=self._alloc(),
            parent_id=parent,
            tid=threading.get_ident(),
        )
        stack.append(s)
        try:
            yield s
        finally:
            s.dur_ns = self._clock() - s.t0_ns
            stack.pop()
            self._record(s)

    def event(self, name: str, **attrs) -> None:
        """Zero-duration instant event (request lifecycle steps)."""
        if not self.enabled:
            return
        stack = self._stack()
        parent = stack[-1].span_id if stack else None
        self._record(
            Span(
                name=name,
                t0_ns=self._clock(),
                dur_ns=0,
                attrs=dict(attrs),
                span_id=self._alloc(),
                parent_id=parent,
                tid=threading.get_ident(),
            )
        )

    def attr(self, **attrs) -> None:
        """Fold attrs into the innermost OPEN span (no-op when none is
        open)."""
        if not self.enabled:
            return
        stack = self._stack()
        if stack:
            stack[-1].attrs.update(attrs)

    # ------------------------------------------------------------------
    def counts(self) -> dict:
        """Span count per name (the lifecycle accounting tests use)."""
        out: dict = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0) + 1
        return out

    def write_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            for s in self.spans:
                f.write(json.dumps(s.as_dict(), sort_keys=True) + "\n")
        return path


class _NullSpan:
    """Stand-in yielded by a disabled tracer's ``span()``."""

    attrs: dict = {}

    def __setattr__(self, k, v):  # swallow attr writes
        pass


_NULL_SPAN = _NullSpan()

#: Always-off tracer — engines default to it so call sites skip None
#: checks; every method is a cheap early return.
NULL_TRACER = Tracer(enabled=False)


# ---------------------------------------------------------------------------
# Module-global tracer slot
# ---------------------------------------------------------------------------

_ACTIVE: Tracer | None = None


def install_tracer(tracer: Tracer) -> Tracer:
    """Make ``tracer`` the process-global tracer (one at a time)."""
    global _ACTIVE
    _ACTIVE = tracer
    return tracer


def uninstall_tracer(tracer: Tracer | None = None) -> None:
    """Clear the global slot (pass the tracer to make it conditional —
    an uninstall racing a newer install then leaves the newer one)."""
    global _ACTIVE
    if tracer is None or _ACTIVE is tracer:
        _ACTIVE = None


def current_tracer() -> Tracer | None:
    return _ACTIVE


# ---------------------------------------------------------------------------
# Exports
# ---------------------------------------------------------------------------


def read_jsonl(path: str) -> list[dict]:
    """Rows of a span JSONL file (skipping blank lines)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def to_chrome(rows, process_name: str = "repro_torch") -> dict:
    """Convert span rows (dicts or Spans) to a Chrome trace_event dict.

    Timed spans become complete (``ph: "X"``) events, instant events
    ``ph: "i"``; timestamps shift to start at 0 and convert to µs (the
    trace_event unit).
    """
    rows = [r.as_dict() if isinstance(r, Span) else r for r in rows]
    t0 = min((r["t0_ns"] for r in rows), default=0)
    events = [
        {
            "ph": "M",
            "pid": 1,
            "tid": 0,
            "name": "process_name",
            "args": {"name": process_name},
        }
    ]
    for r in rows:
        ev = {
            "pid": 1,
            "tid": r.get("tid", 0),
            "name": r["name"],
            "ts": (r["t0_ns"] - t0) / 1e3,
            "args": dict(r.get("attrs") or {}),
        }
        if r.get("parent_id") is not None:
            ev["args"]["parent_id"] = r["parent_id"]
        if r.get("dur_ns", 0) > 0:
            ev.update(ph="X", dur=r["dur_ns"] / 1e3)
        else:
            ev.update(ph="i", s="t")
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}
