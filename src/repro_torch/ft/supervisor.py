"""Fault-tolerance supervisor: checkpoint/restart, stragglers, and the
serve fleet's health-driven failover.

Port of ``repro.ft.supervisor``.  Training: :class:`WorkerFailure`,
:class:`FaultInjector`, :class:`StragglerMonitor` and
:class:`Supervisor`.  The process is single: failures are raised as
:class:`WorkerFailure` (tests inject them at chosen steps), and recovery
is restore + replay.  Determinism makes recovery exact: the data
pipeline is a pure function of the step counter, and the SC noise of a
step a pure function of its key.  Per-step wall-times feed an EMA; a
step exceeding ``threshold × EMA`` is recorded and reported to
``on_straggler``.

Serving: :func:`engine_health` reads one engine's ``repro_torch.obs``
registry into an :class:`EngineHealth` snapshot, and
:class:`HealthMonitor` turns a stream of snapshots into degraded /
healthy verdicts.  :class:`FleetSupervisor` serves a fleet of paged
engines (in one process, on one device), polls each shard's registry
(windowed, so a readmitted shard can prove itself healthy) and
heartbeat, and on degradation DRAINS the shard
(``PagedServingEngine.drain``) and resumes its requests on healthy
shards (``restore``: warm with their K/V blocks, or cold).  The
per-(request key, position) rng contract makes either resume
token-identical to an unfaulted run; :class:`ChaosMonkey` injects
deterministic degradations so tests and ``launch/serve.py --chaos`` can
assert exactly that.
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


@dataclasses.dataclass(frozen=True)
class EngineHealth:
    """One serving engine's health, read from its metrics registry."""

    ticks: int = 0
    errors: int = 0
    error_rate: float = 0.0  # errors per tick (0 when no ticks)
    queue_depth: int = 0
    active_requests: int = 0
    finished: int = 0
    evictions: int = 0


def engine_health(registry) -> EngineHealth:
    """Snapshot a serving engine's registry: ``serve_errors_total``,
    ``serve_ticks_total`` (labeled by kind), ``serve_queue_depth``,
    ``serve_active_requests``, ...  Series the engine never touched read
    as zero, so a fresh engine is healthy."""

    def num(name, **labels):
        v = registry.value(name, **labels)
        return 0 if v is None else v

    ticks = int(
        sum(num("serve_ticks_total", kind=k)
            for k in ("prefill", "decode", "spec"))
    )
    errors = int(num("serve_errors_total"))
    return EngineHealth(
        ticks=ticks,
        errors=errors,
        error_rate=errors / ticks if ticks else float(errors > 0),
        queue_depth=int(num("serve_queue_depth")),
        active_requests=int(num("serve_active_requests")),
        finished=int(num("serve_requests_finished_total")),
        evictions=int(num("serve_evictions_total")),
    )


@dataclasses.dataclass
class HealthMonitor:
    """Degraded-shard detector over :class:`EngineHealth` snapshots.

    A shard is DEGRADED when its error rate exceeds ``max_error_rate``,
    or its queue depth exceeds ``max_queue_depth`` for ``patience``
    consecutive observations.  ``observe`` returns the verdict and
    appends degraded events to ``events``.

    ``window=True`` judges each observation on the DELTA since the
    previous one instead of lifetime totals: counters are monotonic, so
    a shard that errored once would otherwise read degraded forever and
    a readmitted shard could never prove itself healthy again.
    """

    max_error_rate: float = 0.0
    max_queue_depth: int = 64
    patience: int = 2
    window: bool = False
    events: list = dataclasses.field(default_factory=list)
    _backlog_streak: int = 0
    _prev: EngineHealth | None = None

    def observe(self, health: EngineHealth) -> bool:
        if self.window:
            prev = self._prev if self._prev is not None else EngineHealth()
            self._prev = health
            dt = health.ticks - prev.ticks
            de = health.errors - prev.errors
            health = dataclasses.replace(
                health,
                ticks=dt,
                errors=de,
                error_rate=de / dt if dt else float(de > 0),
            )
        degraded = False
        if health.error_rate > self.max_error_rate:
            degraded = True
            self.events.append(("error_rate", health))
        if health.queue_depth > self.max_queue_depth:
            self._backlog_streak += 1
            if self._backlog_streak >= self.patience:
                degraded = True
                self.events.append(("queue_backlog", health))
        else:
            self._backlog_streak = 0
        return degraded

    def observe_registry(self, registry) -> bool:
        """Snapshot + observe in one call (one poll of one engine)."""
        return self.observe(engine_health(registry))


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
    # a Placement per leaf of a sharded state (sharding.fsdp.
    # state_placements): checkpoints gather it and restores cut it
    shardings: object = None
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
                        self.ckpt_dir, step, state, extra={"data_step": step},
                        shardings=self.shardings,
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
                if self.shardings is None:
                    state, extra, _ = checkpoint.restore(self.ckpt_dir, state)
                else:
                    state, extra, _ = checkpoint.restore_resharded(
                        self.ckpt_dir, state, self.shardings)
                step = extra["data_step"]
                history["recoveries"].append((step, restored))
        return state, history


# ---------------------------------------------------------------------------
# Serve-fleet supervision: drain a degraded shard, resume elsewhere
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ChaosMonkey:
    """Deterministic chaos schedule for serve fleets: at fleet tick
    ``at_tick``, degrade shard ``shard`` by adding ``errors`` to its
    engine's ``serve_errors_total`` — the telemetry a crash loop would
    emit, so the drain under test is the production path."""

    at_tick: int = 4
    shard: int = 1
    errors: int = 3
    fired: bool = False

    def maybe_fire(self, tick: int, engines: list) -> bool:
        if self.fired or tick < self.at_tick or self.shard >= len(engines):
            return False
        self.fired = True
        engines[self.shard]._m_errors.inc(self.errors)
        return True


class FleetSupervisor:
    """Serves one request stream across a fleet of paged engines with
    health-driven shard failover.

    ``engine_factory(shard) -> PagedServingEngine`` builds each shard;
    all shards must share the engine seed, so per-request keys (and
    therefore tokens) do not depend on the shard.  ``submit``
    round-robins over healthy shards; ``step`` ticks every healthy
    shard, fires the optional :class:`ChaosMonkey`, then polls health.

    A shard is degraded when its windowed :class:`HealthMonitor` trips
    on the engine's own registry or its heartbeat goes stale.  Degrading
    drains every request of the shard and resumes them round-robin on
    the healthy shards.  The drained shard sits out ``cooldown`` polls,
    then READMITS, judged on post-readmission deltas.  Only healthy
    shards are polled, so a shard never drains twice for one incident.
    A shard whose tick raises is left to the poll: the engine has
    counted the error, and the poll drains it; ``failures`` keeps each
    such ``(shard, fleet tick, exception)``.

    Fleet telemetry (``ft_*`` series, labeled by shard) lands in
    ``metrics``.
    """

    def __init__(
        self,
        engine_factory,
        shards: int = 2,
        metrics=None,
        monitor_factory=None,
        heartbeat_timeout_s: float = 600.0,
        cooldown: int = 4,
        chaos: ChaosMonkey | None = None,
    ):
        from repro_torch import obs

        if shards < 2:
            raise ValueError("a failover fleet needs >= 2 shards")
        self.shards = shards
        self.engines = [engine_factory(s) for s in range(shards)]
        mk = monitor_factory or (lambda s: HealthMonitor(window=True))
        self.monitors = [mk(s) for s in range(shards)]
        self.healthy = [True] * shards
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.last_heartbeat = [time.monotonic()] * shards
        self.cooldown = cooldown
        self._cooldowns = [0] * shards
        self.chaos = chaos
        self.ticks = 0
        self._rr = 0
        self.drains = 0
        self.resumed = 0
        self.readmissions = 0
        self.failures: list = []
        m = metrics if metrics is not None else obs.MetricsRegistry()
        self.metrics = m
        self._m_degraded = m.counter(
            "ft_shard_degraded_total",
            "degraded verdicts acted on, labeled shard",
        )
        self._m_drains = m.counter(
            "ft_shard_drains_total", "shards drained, labeled shard"
        )
        self._m_resumed = m.counter(
            "ft_requests_resumed_total",
            "drained requests resumed, labeled by TARGET shard",
        )
        self._m_readmit = m.counter(
            "ft_shard_readmissions_total",
            "drained shards readmitted after cooldown, labeled shard",
        )
        for s in range(shards):
            # every shard's series exists at 0, incident or not
            for c in (
                self._m_degraded,
                self._m_drains,
                self._m_resumed,
                self._m_readmit,
            ):
                c.inc(0, shard=str(s))

    # ------------------------------------------------------------------
    def submit(self, req) -> int:
        """Round-robin the request onto a healthy shard; returns it."""
        order = [s for s in range(self.shards) if self.healthy[s]]
        if not order:
            raise RuntimeError("no healthy shards to submit to")
        shard = order[self._rr % len(order)]
        self._rr += 1
        self.engines[shard].submit(req)
        return shard

    def heartbeat(self, shard: int) -> None:
        self.last_heartbeat[shard] = time.monotonic()

    def heartbeat_stale(self, shard: int) -> bool:
        elapsed = time.monotonic() - self.last_heartbeat[shard]
        return elapsed > self.heartbeat_timeout_s

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One fleet tick: tick healthy shards, fire chaos, poll health."""
        progressed = False
        for s in range(self.shards):
            if not self.healthy[s]:
                continue
            try:
                progressed = bool(self.engines[s].step()) or progressed
                self.heartbeat(s)
            except Exception as e:
                # the engine counted serve_errors_total; the poll below
                # turns that into a drain
                self.failures.append((s, self.ticks, e))
        self.ticks += 1
        if self.chaos is not None:
            self.chaos.maybe_fire(self.ticks, self.engines)
        self.poll()
        return progressed

    def poll(self) -> None:
        """Health pass: degrade-and-drain tripped shards, readmit cooled
        ones.  Only healthy shards are judged."""
        for s in range(self.shards):
            if not self.healthy[s]:
                self._cooldowns[s] -= 1
                if self._cooldowns[s] <= 0:
                    self.healthy[s] = True
                    self.readmissions += 1
                    self._m_readmit.inc(shard=str(s))
                continue
            tripped = self.monitors[s].observe_registry(
                self.engines[s].metrics
            )
            if tripped or self.heartbeat_stale(s):
                self.degrade(s)

    def degrade(self, shard: int) -> list:
        """Drain ``shard`` and resume its requests on healthy shards.
        An already-degraded shard is skipped."""
        if not self.healthy[shard]:
            return []
        self._m_degraded.inc(shard=str(shard))
        self.healthy[shard] = False
        self._cooldowns[shard] = self.cooldown
        ckpts = self.engines[shard].drain()
        self.drains += 1
        self._m_drains.inc(shard=str(shard))
        targets = [s for s in range(self.shards) if self.healthy[s]]
        if not targets:
            raise RuntimeError(
                f"shard {shard} degraded with no healthy shard left to "
                "resume its requests on"
            )
        for i, ckpt in enumerate(ckpts):
            t = targets[i % len(targets)]
            self.engines[t].restore(ckpt)
            self.resumed += 1
            self._m_resumed.inc(shard=str(t))
        return ckpts

    # ------------------------------------------------------------------
    @property
    def finished(self) -> list:
        out = []
        for e in self.engines:
            out.extend(e.finished)
        return out

    def has_work(self) -> bool:
        return any(e.scheduler.has_work() for e in self.engines)

    def run_until_drained(self, max_ticks: int = 10_000) -> list:
        ticks = 0
        while self.has_work() and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.finished

    def close(self) -> None:
        for e in self.engines:
            e.close()
