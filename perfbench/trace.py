"""Reading a traced sub-window: ``torch.profiler`` on the card, the
port's spans (``repro_torch.obs``) and its kernel launch counts.

:func:`record` runs a callable under all three and returns a
:class:`Window`, which the per-layer readers (``metrics/*.py``) read.
The profiler records the card's activity alone (CUPTI: device
operations and the host's CUDA runtime calls): recording every host
operator as well slowed a training step by 11-38 % on the card, which
would have read as device idle time.  Device time is the union of the
intervals in which an operation ran on the card (kernels, copies,
sets), so operations that overlap are counted once.  The window's
length is the host clock's, between synchronizations.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import torch


@dataclasses.dataclass
class Window:
    """One traced sub-window.

    ``ops``: (name, start_us, end_us) of every device operation;
    ``host``: the same of every CUDA runtime call the host made;
    ``seconds``: its length on the host clock; ``spans``: the port's
    ``obs`` spans recorded in it; ``launches``: the port's kernel
    launches by kernel name; ``info``: what the window loop ran in it
    (steps, tokens, ...)."""

    ops: list
    host: list
    seconds: float
    spans: list
    launches: dict
    info: dict

    def busy_s(self) -> float:
        """Seconds in which an operation ran on the device."""
        return union_us([(a, b) for _, a, b in self.ops]) / 1e6

    def device_s(self, match: str) -> float:
        """Summed device seconds of the operations whose names hold
        ``match``."""
        return sum(b - a for n, a, b in self.ops if match in n) / 1e6


def union_us(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def record(fn, info: dict) -> Window:
    """Run ``fn()`` once under the profiler, a new installed and enabled
    ``obs.Tracer`` and reset launch counters, synchronized before and
    after."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.kernels import cuda_lib

    tracer = obs.Tracer()
    tracer.enabled = True
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        obs.install_tracer(tracer)
        cuda_lib.reset_launches()
        try:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            obs.uninstall_tracer(tracer)
            tracer.enabled = False
    launches = dict(cuda_lib.launches)
    ops, host = [], []
    for ev in prof.events():
        t = ev.time_range
        row = (ev.name, float(t.start), float(t.end))
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if not ev.is_user_annotation:
                ops.append(row)
        else:
            host.append(row)
    if not ops:
        raise RuntimeError("the profiler recorded no device operation")
    return Window(ops, host, seconds, list(tracer.spans), launches, info)


def top_ops(w: Window, n: int = 10) -> list:
    """The ``n`` device operations with the most summed time:
    ``[[name, seconds], ...]``."""
    total: collections.Counter = collections.Counter()
    for name, a, b in w.ops:
        total[name] += (b - a) / 1e6
    return [[name, s] for name, s in total.most_common(n)]


def idle_gaps(w: Window, n: int = 10) -> list:
    """The ``n`` longest stretches between the window's first and last
    device operation in which none ran, each named by the CUDA runtime
    call the host was in at its middle (a synchronization or copy), or
    ``host`` where it was in none (Python and operator overhead):
    ``[[name, seconds], ...]``."""
    gaps, end = [], None
    for _, a, b in sorted(w.ops, key=lambda o: o[1]):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:n]:
        mid = (a + b) / 2
        around = [h for h in w.host if h[1] <= mid <= h[2]]
        name = min(around, key=lambda h: h[2] - h[1])[0] if around \
            else "host"
        out.append([name, (b - a) / 1e6])
    return out
