"""Fault-tolerance supervisor: checkpoint/restart and stragglers.

Port of the training half of ``repro.ft.supervisor``, which holds no
JAX: :class:`WorkerFailure`, :class:`FaultInjector`,
:class:`StragglerMonitor` and :class:`Supervisor`.  The process is
single: failures are raised as :class:`WorkerFailure` (tests inject them
at chosen steps), and recovery is restore + replay.  Determinism makes
recovery exact: the data pipeline is a pure function of the step
counter, and the SC noise of a step a pure function of its key.

Straggler mitigation: per-step wall-times feed an EMA; a step exceeding
``threshold × EMA`` is recorded and reported to ``on_straggler``.

The serve-fleet half (``HealthMonitor``, ``ChaosMonkey``,
``FleetSupervisor``, with the engines' drain / restore) is not ported
yet (ROADMAP queue 1 item 9).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

from repro_torch import checkpoint


class WorkerFailure(RuntimeError):
    """Injected/observed worker crash (lost node, preemption, OOM-kill)."""


@dataclasses.dataclass
class FaultInjector:
    """Deterministic failure schedule for tests: fail at given steps."""

    fail_at_steps: tuple = ()
    fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise WorkerFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 3.0
    ema_decay: float = 0.8
    ema: float | None = None
    events: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, duration_s: float) -> bool:
        is_straggler = (
            self.ema is not None and duration_s > self.threshold * self.ema
        )
        if is_straggler:
            self.events.append((step, duration_s, self.ema))
        self.ema = (
            duration_s
            if self.ema is None
            else self.ema_decay * self.ema + (1 - self.ema_decay) * duration_s
        )
        return is_straggler


@dataclasses.dataclass
class Supervisor:
    """Drives a step function with checkpoint/restart fault recovery."""

    ckpt_dir: str
    ckpt_every: int = 10
    max_restarts: int = 5
    heartbeat_timeout_s: float = 600.0
    injector: FaultInjector | None = None
    stragglers: StragglerMonitor = dataclasses.field(
        default_factory=StragglerMonitor
    )
    on_straggler: Callable | None = None
    restarts: int = 0
    last_heartbeat: float = dataclasses.field(default_factory=time.monotonic)

    def heartbeat(self):
        self.last_heartbeat = time.monotonic()

    def heartbeat_stale(self) -> bool:
        elapsed = time.monotonic() - self.last_heartbeat
        return elapsed > self.heartbeat_timeout_s

    def run(self, state, step_fn, n_steps: int, *, make_batch,
            start_step: int = 0):
        """Run ``n_steps`` of ``step_fn(state, batch)`` with recovery.

        ``make_batch(step)`` supplies the (deterministic) batch.  Returns
        ``(state, history)``; history records losses (in the order the
        steps ran, replays included) and ``(resumed_step,
        checkpoint_step)`` recovery events.
        """
        history = {"loss": [], "recoveries": [], "straggler_steps": []}
        step = start_step
        while step < n_steps:
            try:
                t0 = time.monotonic()
                if self.injector is not None:
                    self.injector.check(step)
                state, metrics = step_fn(state, make_batch(step))
                dt = time.monotonic() - t0
                self.heartbeat()
                if self.stragglers.observe(step, dt):
                    history["straggler_steps"].append(step)
                    if self.on_straggler is not None:
                        self.on_straggler(step, dt)
                history["loss"].append(float(metrics["loss"]))
                step += 1
                if step % self.ckpt_every == 0:
                    checkpoint.save(
                        self.ckpt_dir, step, state, extra={"data_step": step}
                    )
            except WorkerFailure as e:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={self.max_restarts}"
                    ) from e
                restored = checkpoint.latest_step(self.ckpt_dir)
                if restored is None:
                    # no checkpoint yet -> restart from scratch
                    history["recoveries"].append((step, 0))
                    step = start_step
                    continue
                state, extra, _ = checkpoint.restore(self.ckpt_dir, state)
                step = extra["data_step"]
                history["recoveries"].append((step, restored))
        return state, history
