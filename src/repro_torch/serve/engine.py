"""Batched serving engines.

Port of ``repro.serve.engine``.  Two engines share this module and the
lifecycle of :class:`_ArchTracedEngine` (the per-tick device-profile
scope, the arch trace collector, ``serve_errors_total`` on a raise, the
telemetry and ``health_snapshot``):

* :class:`ServingEngine` — the fixed-slot engine, what
  ``build_engine(params, cfg)`` builds by default.  It owns a K/V row of
  ``max_len`` positions per slot.  A request admits with a batch-1
  ``lm.prefill`` spliced into a free slot's row; every tick then runs one
  ``lm.decode_step`` over ALL slots, idle ones included, and samples
  each slot with its request's own temperature.  On a stochastic
  substrate every call draws from one engine-level key chain
  (``_next_key``): one key per admission prefill, per sampled admission,
  per decode tick, and per tick in which a slot samples, in the
  reference's order, so each SC call draws the reference's bits.  On a
  device mesh (``mesh=``) each rank runs the same engine and every SC
  call splits over the ranks (``sc.sc_dot_sharded``).
* :class:`PagedServingEngine` — continuous batching over a block-pool
  paged KV cache with chunked prefill, eviction-on-OOM, and per-request
  rng.  ``step()`` is a thin loop over ``scheduler.Scheduler``: plan →
  one ``lm.decode_paged`` call → sample the rows whose pending context
  emptied.  Prefix caching (``PagedServeConfig.prefix_cache``) shares
  full KV blocks and forces content-chain keys; speculative decoding
  (``speculative``) drafts ``spec_k`` tokens a greedy row and verifies
  them in one width-(k+1) step.  ``drain`` / ``restore`` move requests
  between engines (``ft.FleetSupervisor``'s failover), warm with their
  K/V blocks where the geometry allows.  Every family serves through a
  per-family cache plan (``kv_cache.CachePlan``): the SSM and hybrid
  families carry recurrent state rows per slot, so they refuse prefix
  caching and speculation, and checkpoint cold.

Both engines keep their caches on their device and update them in
place.  On a non-ideal device (``ServeOptions.fault_profile``) each tick
runs under ``sc.use_device_profile(engine.device_profile)``.  With
``collect_arch_trace=True`` and ``cfg.sc_backend == "array"`` the engine
keeps an arch trace collector installed: every ``array`` call the ticks
EXECUTE records its pulse-schedule cost, and ``arch_report()`` returns
the aggregate (the jitted reference records once per COMPILED shape).
``close()`` (or a raise mid-tick) detaches the collector.

Construct engines through ``serve.api.build_engine``; direct
construction works but warns.  Every family serves on token prompts
(an embeddings-frontend model, musicgen-large, through its embedding
table).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import warnings

import torch

from repro_torch import obs, sc
from repro_torch.models import attention, lm
from repro_torch.sc import ctr_rng

# Depth of serve.api.build_engine construction scopes on this thread:
# direct engine construction sees depth 0 and warns.
_API_DEPTH = 0


@contextlib.contextmanager
def _api_construction():
    global _API_DEPTH
    _API_DEPTH += 1
    try:
        yield
    finally:
        _API_DEPTH -= 1


def _warn_direct(name: str) -> None:
    if _API_DEPTH == 0:
        warnings.warn(
            f"constructing {name} directly is deprecated; use "
            "repro_torch.serve.build_engine(params, cfg, ServeOptions(...)) "
            "— it picks the engine, applies fused attention / device fault "
            "profiles, and validates option combinations",
            DeprecationWarning,
            stacklevel=3,
        )


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list  # token ids
    max_new_tokens: int = 16
    temperature: float = 0.0
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    # Per-request raw (2,) uint32 key.  The paged engine folds it from
    # the engine seed + rid at submission unless the caller set one;
    # every stochastic draw for this request (SC bits, sampling) derives
    # from it, making results independent of batch composition.
    key: object = None


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs of the fixed-slot engine."""

    slots: int = 4
    max_len: int = 256
    eos_id: int = 2
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class PagedServeConfig:
    """Knobs of the paged continuous-batching engine.

    ``num_blocks = 0`` sizes the pool for every slot at full ``max_len``
    plus the null block; ``prefill_chunk`` caps how many prompt tokens
    one tick feeds per row.  ``prefix_cache`` turns on block sharing
    (and content-chain keys); ``rng_mode`` is ``"request"`` or
    ``"content"``; ``speculative`` drafts ``spec_k`` tokens a greedy
    decode row with ``draft_backend`` ("" = ``sc.draft_backend`` of the
    model's backend).
    """

    slots: int = 4
    max_len: int = 256
    eos_id: int = 2
    seed: int = 0
    block_size: int = 16
    num_blocks: int = 0
    prefill_chunk: int = 8
    prefix_cache: bool = False
    rng_mode: str = "request"  # "request" | "content"
    speculative: bool = False
    spec_k: int = 4
    draft_backend: str = ""


def _uniform01(keys, n: int):
    """(b, n) float32 uniforms in [tiny, 1) from each row's raw key:
    Threefry words at counters (0, 0..n-1), top 23 bits as mantissa."""
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    k = keys.to(torch.int64)
    bits = ctr_rng.threefry2x32(k[:, 0, None], k[:, 1, None], 0, idx)[0]
    u = (bits >> 9).to(torch.float32) * (1.0 / (1 << 23))
    return torch.clamp_min(u, torch.finfo(torch.float32).tiny)


def _sample_rows(keys, logits, temperatures):
    """All rows' sampling draws in one call: greedy (``argmax``, first
    maximum) at t <= 0, Gumbel-max with uniforms from each row's own
    sampling key otherwise.  The reference samples with
    ``jax.random.categorical``; the two agree in distribution only."""
    greedy = torch.argmax(logits, dim=-1)
    if not bool((temperatures > 0.0).any()):
        return greedy
    safe_t = torch.clamp_min(temperatures, 1e-6)
    gumbel = -torch.log(-torch.log(_uniform01(keys, logits.shape[-1])))
    sampled = torch.argmax(logits / safe_t[:, None] + gumbel, dim=-1)
    return torch.where(temperatures > 0.0, sampled, greedy)


class _ArchTracedEngine:
    """The lifecycle both engines share.

    ``close()`` is idempotent: the first call detaches the arch trace
    collector, every later call (or ``__del__`` after it) is a no-op;
    records stay readable.  ``step()`` runs its tick under
    :meth:`_tick_scope`: the device profile's scope, and on a raise
    ``serve_errors_total`` + 1 and ``close()`` before the error
    propagates, so a dead engine stops recording.
    """

    # Non-ideal device realized while this engine ticks (set by
    # serve.api.build_engine from options.fault_profile; None = ideal).
    device_profile = None

    def _init_arch(self, collect_arch_trace: bool, cfg) -> None:
        self._arch_closed = False
        self.arch_collector = None
        if collect_arch_trace and cfg.sc_backend == "array":
            from repro_torch import arch

            self.arch_collector = arch.TraceCollector().install()

    def _init_obs(self, metrics, tracer) -> None:
        """Engine-local telemetry: each engine owns an always-on metrics
        registry (``self.metrics``) unless the caller supplies one, so
        concurrent engines never mix series; the tracer defaults to the
        always-off ``NULL_TRACER``."""
        if metrics is None:
            metrics = obs.MetricsRegistry()
        self.metrics = metrics
        self.tracer = tracer if tracer is not None else obs.NULL_TRACER
        self._m_ticks = self.metrics.counter(
            "serve_ticks_total",
            "engine ticks, labeled kind=prefill|decode|spec",
        )
        self._m_errors = self.metrics.counter(
            "serve_errors_total", "engine ticks that raised"
        )

    def arch_report(self):
        """Aggregate arch cost of every ``array`` call executed so far
        (None when collection is off or nothing was recorded).  The
        collector hears every array-backend call in the process while
        installed, not only this engine's."""
        collector = getattr(self, "arch_collector", None)
        if collector is None or not collector.records:
            return None
        return collector.aggregate()

    def arch_request_costs(self):
        """Per-request cost attribution (None without a trace or without
        finished requests): the aggregate prorated by each request's
        token count — ``TraceCollector.cost_per_request``."""
        collector = getattr(self, "arch_collector", None)
        if collector is None or not collector.request_tokens:
            return None
        return collector.cost_per_request()

    def _note_finished(self, req) -> None:
        if self.arch_collector is not None:
            self.arch_collector.note_request(
                req.rid, len(req.prompt) + len(req.generated)
            )

    def close(self):
        """Detach the arch trace collector (records stay readable).
        Idempotent: only the first call touches the listener list."""
        if getattr(self, "_arch_closed", True):
            return
        self._arch_closed = True
        if self.arch_collector is not None:
            self.arch_collector.uninstall()

    def __del__(self):
        # a dropped engine must not leave its collector listening
        self.close()

    @contextlib.contextmanager
    def _tick_scope(self):
        try:
            with sc.use_device_profile(self.device_profile):
                yield
        except Exception:
            self._m_errors.inc()
            self.close()
            raise

    def _tensor(self, rows, dtype=torch.int32):
        """Host rows as a tensor on the engine's device."""
        return torch.tensor(rows, dtype=dtype).to(self.device)

    def health_snapshot(self) -> dict:
        """Queue-depth / error-rate view of ``self.metrics``: the gauges
        ``ft.supervisor.HealthMonitor`` reads."""
        from repro_torch.ft import supervisor

        return dataclasses.asdict(supervisor.engine_health(self.metrics))


class ServingEngine(_ArchTracedEngine):
    """The fixed-slot engine (see the module doc).

    ``device`` holds the cache and runs every call; ``params`` must
    already lie there.  ``queue``, ``active`` (slot -> Request or None)
    and ``finished`` are plain lists; ``lengths`` and ``last_token`` are
    host lists of ints, one per slot, moved to the device once per
    call.

    With a ``mesh`` (``launch.mesh.make_local_mesh``; ``shard_rules``
    from ``sharding.sc_shard_rules``) on a stochastic substrate, every
    prefill and decode step runs under ``sc.use_mesh``: each one-key SC
    call splits over the mesh's ranks (``sc.sc_dot_sharded``), while the
    parameters, the cache and the scheduler stay whole on every rank,
    which runs the same requests and ends with the same tokens.  The
    slots must be a multiple of the rules' batch span.
    """

    def __init__(
        self,
        params,
        cfg,
        scfg: ServeConfig,
        *,
        device,
        collect_arch_trace: bool = False,
        mesh=None,
        shard_rules=None,
        metrics=None,
        tracer=None,
    ):
        _warn_direct("ServingEngine")
        self.params = params
        self.cfg = cfg
        self.scfg = scfg
        self.device = torch.device(device)
        self.mesh = mesh
        self.shard_rules = shard_rules
        self._stochastic_substrate = cfg.sc_backend != "exact"
        if mesh is not None and self._stochastic_substrate:
            batch_axes = (shard_rules or sc.DEFAULT_RULES).batch
            sizes = dict(mesh.shape)
            dp = math.prod(sizes.get(a, 1) for a in batch_axes)
            if dp > 1 and scfg.slots % dp != 0:
                raise ValueError(
                    f"slots={scfg.slots} must be a multiple of the rules' "
                    f"batch span {dp} on this mesh so slots map onto "
                    f"mesh shards"
                )
        self.cache = lm.init_cache(
            cfg, scfg.slots, scfg.max_len, device=self.device
        )
        self.lengths = [0] * scfg.slots
        self.last_token = [0] * scfg.slots
        self.active: list = [None] * scfg.slots
        self.queue: list = []
        self.finished: list = []
        self._rng = ctr_rng.prng_key(scfg.seed)
        self._init_arch(collect_arch_trace, cfg)
        self._init_obs(metrics, tracer)
        m = self.metrics
        self._m_submitted = m.counter(
            "serve_requests_submitted_total", "requests entering the queue"
        )
        self._m_finished = m.counter(
            "serve_requests_finished_total", "requests completed"
        )
        self._m_generated = m.counter(
            "serve_tokens_generated_total", "tokens sampled across requests"
        )
        self._g_queue = m.gauge("serve_queue_depth", "requests waiting")
        self._g_active = m.gauge(
            "serve_active_requests", "requests holding a slot"
        )

    def _substrate_scope(self):
        """The mesh scope entered around prefill and decode, so that
        ``dense`` routes every one-key SC call through
        ``sc.sc_dot_sharded``."""
        if self.mesh is not None and self._stochastic_substrate:
            return sc.use_mesh(self.mesh, self.shard_rules)
        return contextlib.nullcontext()

    def _next_key(self):
        """The next key of the engine's chain, on the device."""
        self._rng, k = ctr_rng.split(self._rng)
        return k.to(self.device)

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)
        self._m_submitted.inc()
        self._g_queue.set(len(self.queue))
        self.tracer.event(
            "request.submit", rid=req.rid, prompt_tokens=len(req.prompt)
        )

    def _splice_slot(self, slot: int, cache1, length: int, last_tok: int):
        """Write a batch-1 prefill cache into batch row ``slot``, cast to
        the cache's dtype: every leaf (the K/V rows, or the SSM conv
        tails and states and the shared K/V) from its first index on, as
        the reference's ``dynamic_update_slice`` writes it (a prompt
        shorter than the conv tail writes only its own rows)."""

        def put(full, one):
            if isinstance(full, dict):
                for name in full:
                    put(full[name], one[name])
                return
            rows = tuple(slice(0, n) for n in one.shape[2:])
            full[(slice(None), slot) + rows] = one[:, 0].to(full.dtype)

        put(self.cache, cache1)
        self.lengths[slot] = length
        self.last_token[slot] = last_tok

    def _admit(self):
        for slot in range(self.scfg.slots):
            if self.active[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            rng = self._next_key() if self._stochastic_substrate else None
            with self._substrate_scope():
                logits, cache1, _ = lm.prefill(
                    self.params,
                    self._tensor([req.prompt]),
                    self.cfg,
                    self.scfg.max_len,
                    rng=rng,
                )
            tok = self._sample_slots(logits, [req.temperature])[0]
            req.generated.append(tok)
            self.active[slot] = req
            self._splice_slot(slot, cache1, len(req.prompt), tok)
            self._m_generated.inc()
            self._g_queue.set(len(self.queue))
            self._g_active.set(sum(r is not None for r in self.active))
            self.tracer.event(
                "request.admit", rid=req.rid, slot=slot, resumed=False
            )

    def _sample_slots(self, logits, temperatures) -> list:
        """Per-slot sampling (an admission samples as a batch of one):
        each slot uses its request's own
        temperature.  Greedy slots (t <= 0) take the argmax whatever the
        rng, so a greedy request decodes identically whatever its
        neighbours sample.  A tick in which any slot samples takes one
        key of the chain and splits it over the slots (the reference
        draws ``jax.random.categorical`` under that key; the two agree
        in distribution only)."""
        if not any(t > 0.0 for t in temperatures):
            return torch.argmax(logits, dim=-1).tolist()
        keys = ctr_rng.split(self._next_key(), len(temperatures))
        temps = self._tensor(temperatures, torch.float32)
        return _sample_rows(keys, logits, temps).tolist()

    # ------------------------------------------------------------------
    def step(self):
        """One tick: admit, one decode step over every slot, per-slot
        sampling, harvest.  Returns False when idle."""
        with self._tick_scope():
            return self._tick()

    def _tick(self):
        self._admit()
        if not any(r is not None for r in self.active):
            return False
        self._m_ticks.inc(kind="decode")
        rng = self._next_key() if self._stochastic_substrate else None
        with self._substrate_scope():
            logits, self.cache = lm.decode_step(
                self.params,
                self.cache,
                self._tensor(self.last_token),
                self._tensor(self.lengths),
                self.cfg,
                rng=rng,
            )
        for slot, req in enumerate(self.active):
            self.lengths[slot] += req is not None
        temps = [0.0 if r is None else r.temperature for r in self.active]
        # idle slots keep their sampled token as next input, as the
        # reference does: it is one row of every SC call of the next tick
        self.last_token = self._sample_slots(logits, temps)
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            tok = self.last_token[slot]
            req.generated.append(tok)
            self._m_generated.inc()
            hit_eos = tok == self.scfg.eos_id
            hit_max = len(req.generated) >= req.max_new_tokens
            hit_cap = self.lengths[slot] >= self.scfg.max_len - 1
            if hit_eos or hit_max or hit_cap:
                req.done = True
                self._note_finished(req)
                self.finished.append(req)
                self.active[slot] = None
                self.lengths[slot] = 0
                self._m_finished.inc()
                self._g_active.set(sum(r is not None for r in self.active))
                self.tracer.event(
                    "request.finish",
                    rid=req.rid,
                    generated=len(req.generated),
                )
        return True

    def run_until_drained(self, max_ticks: int = 10_000):
        ticks = 0
        while (self.queue or any(self.active)) and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.finished


class PagedServingEngine(_ArchTracedEngine):
    """Continuous batching over a paged KV cache (see the module doc).

    ``device`` holds the page pools and runs every step; ``params`` must
    already lie there.
    """

    def __init__(
        self,
        params,
        cfg,
        scfg: PagedServeConfig,
        *,
        device,
        collect_arch_trace: bool = False,
        metrics=None,
        tracer=None,
    ):
        from repro_torch.serve import kv_cache as kvc
        from repro_torch.serve import scheduler as sched

        _warn_direct("PagedServingEngine")
        self.cache_plan = kvc.CachePlan.for_config(cfg)
        if self.cache_plan.has_state:
            if scfg.prefix_cache:
                raise ValueError(
                    "prefix_cache=True needs reconstructible context, but "
                    f"family={cfg.family!r} carries recurrent SSM state — "
                    "adopted KV blocks cannot rebuild a row's state"
                )
            if scfg.speculative:
                raise ValueError(
                    "speculative=True cannot rewind recurrent state, but "
                    f"family={cfg.family!r} carries SSM state — the verify "
                    "pass would advance it past rejected draft tokens"
                )
        self.params = params
        self.cfg = cfg
        self.scfg = scfg
        if scfg.rng_mode not in ("request", "content"):
            raise ValueError(
                f"rng_mode must be 'request' or 'content', got "
                f"{scfg.rng_mode!r}"
            )
        self.device = torch.device(device)
        self._init_obs(metrics, tracer)
        num_blocks = scfg.num_blocks or kvc.default_num_blocks(
            scfg.slots, scfg.max_len, scfg.block_size
        )
        pcfg = kvc.PagedCacheConfig(
            num_blocks=num_blocks,
            block_size=scfg.block_size,
            max_len=scfg.max_len,
        )
        if num_blocks < 1 + pcfg.blocks_per_seq:
            raise ValueError(
                f"num_blocks={num_blocks} cannot hold even one max_len="
                f"{scfg.max_len} sequence (+1 null block) at block_size="
                f"{scfg.block_size}; need >= {1 + pcfg.blocks_per_seq}"
            )
        self.kv = kvc.PagedKVCache(
            pcfg,
            metrics=self.metrics,
            enable_prefix_cache=scfg.prefix_cache,
        )
        self.pages = lm.init_paged_cache(
            cfg, num_blocks, scfg.block_size, slots=scfg.slots,
            device=self.device,
        )
        self.scheduler = sched.Scheduler(
            scfg,
            self.kv,
            base_key=ctr_rng.prng_key(scfg.seed),
            on_finish=self._note_finished,
            metrics=self.metrics,
            tracer=self.tracer,
        )
        self._init_arch(collect_arch_trace, cfg)
        # fused_sc attention draws per-token stochastic logits even when
        # the dense substrate is exact, so it needs per-request keys too
        self._stochastic_substrate = (
            cfg.sc_backend != "exact" or cfg.paged_attn == "fused_sc"
        )
        if scfg.speculative:
            self._init_spec(cfg, scfg)
        self.ticks = 0
        self._seen_decode_tick = False
        # Per-tick decode wall times (ms per live token, width-1 ticks
        # only).  The first decode tick pays one-time set-up (kernel
        # build and load) and is counted separately.
        self._decode_hist = self.metrics.histogram(
            "serve_decode_ms_per_token",
            "decode wall ms per live token (width-1 ticks, first tick "
            "dropped)",
        )
        self._m_first_ticks = self.metrics.counter(
            "serve_decode_jit_ticks_total",
            "decode ticks excluded from the latency series (first tick)",
        )

    def _init_spec(self, cfg, scfg) -> None:
        """The draft config and the acceptance telemetry.  The draft runs
        the same weights on the cheap backend with plain ``unfused``
        attention: its K/V writes are placeholders the verify pass
        overwrites, its logits only guess tokens."""
        if scfg.spec_k < 1:
            raise ValueError(
                f"speculative=True needs spec_k >= 1, got {scfg.spec_k}"
            )
        dname = scfg.draft_backend or sc.draft_backend(cfg.sc_backend)
        sc.get_backend(dname)  # fail fast on unknown names
        self.draft_cfg = cfg.replace(sc_backend=dname, paged_attn="unfused")
        self._spec_hist = self.metrics.histogram(
            "spec_accepted_tokens",
            "draft tokens accepted per speculative row-tick (0..k)",
            buckets=tuple(float(i) for i in range(scfg.spec_k + 1)),
        )
        self._m_spec_drafted = self.metrics.counter(
            "serve_spec_drafted_tokens_total",
            "tokens drafted by the cheap backend",
        )
        self._m_spec_accepted = self.metrics.counter(
            "serve_spec_accepted_tokens_total",
            "drafted tokens the verifier accepted",
        )
        # one entry per speculative row-tick, for replaying the counters
        self.spec_log: list = []

    # -- queue/active views -------------------------------------------
    @property
    def queue(self):
        return list(self.scheduler.waiting)

    @property
    def active(self):
        return list(self.scheduler.rows)

    @property
    def finished(self):
        return self.scheduler.finished

    @property
    def evictions(self) -> int:
        return self.scheduler.evictions

    def submit(self, req: Request):
        self.scheduler.submit(req)

    # ------------------------------------------------------------------
    def step(self):
        """One tick: scheduler plan → one chunked step → sample the rows
        that consumed their pending context.  Returns False when idle.
        A raise mid-tick detaches the arch collector."""
        with self._tick_scope():
            return self._tick()

    def _tick(self):
        plan = self.scheduler.plan()
        if plan is None:
            return False
        if not any(plan.n_valid):
            raise RuntimeError(
                "scheduler produced a no-progress tick (every row "
                "deferred) — the block pool is mis-sized"
            )
        if plan.copies:
            src = [s for s, _ in plan.copies]
            dst = [d for _, d in plan.copies]
            attention.paged_copy_blocks(self.pages, src, dst)
        spec = bool(plan.spec_rows)
        kind = "spec" if spec else "decode" if plan.sc == 1 else "prefill"
        live = sum(1 for nv in plan.n_valid if nv)
        self._m_ticks.inc(kind=kind)
        with self.tracer.span(
            "engine.tick",
            tick=self.ticks,
            kind=kind,
            live=live,
            width=plan.sc,
        ):
            if spec:
                self._run_spec_plan(plan)
            else:
                self._run_plan(plan, live)
        self.ticks += 1
        return True

    def _run_plan(self, plan, live: int):
        tokens = self._tensor(plan.tokens)
        lengths = self._tensor(plan.lengths)
        n_valid = self._tensor(plan.n_valid)
        tables = self._tensor(plan.tables)
        rng = None
        if self._stochastic_substrate:
            rng = torch.stack(plan.keys).to(self.device)
        t0 = time.perf_counter()
        logits, self.pages = lm.decode_paged(
            self.params,
            self.pages,
            tables,
            tokens,
            lengths,
            n_valid,
            self.cfg,
            rng=rng,
        )
        if plan.sc == 1:
            # decode tick: wait for the device so the wall time covers
            # the step, then normalize per live row
            if logits.is_cuda:
                torch.cuda.synchronize(self.device)
            ms = (time.perf_counter() - t0) * 1e3 / max(live, 1)
            if self._seen_decode_tick:
                self._decode_hist.observe(ms)
            else:
                self._seen_decode_tick = True
                self._m_first_ticks.inc()
            self.tracer.attr(decode_ms_per_token=round(ms, 4))
        self._sample(plan, logits)

    def _sample(self, plan, logits) -> None:
        """Sample every row of ``plan.sample_rows`` from its ``logits``
        row: one batched call and one host sync; non-sampling slots get
        dummy keys and are discarded."""
        if not plan.sample_rows:
            return
        keys = [self.scheduler._dummy_key] * len(plan.tokens)
        temps = [0.0] * len(plan.tokens)
        for slot, seq in plan.sample_rows:
            keys[slot] = self.scheduler.sample_key(seq)
            temps[slot] = seq.req.temperature
        toks = _sample_rows(
            torch.stack(keys).to(self.device),
            logits,
            self._tensor(temps, torch.float32),
        ).tolist()
        for slot, seq in plan.sample_rows:
            self.scheduler.on_token(slot, seq, toks[slot])

    def _run_spec_plan(self, plan) -> None:
        """One speculative tick: ``spec_k`` width-1 draft steps, ONE
        width-(k+1) verify step, then the accepted run committed per row.

        The draft runs the same weights on ``draft_cfg`` and writes its
        K/V into the real pools, IN PLACE.  That is safe because of
        where it writes: a drafting row's positions ``fed .. fed+k-1``,
        all inside the span the scheduler reserved and passed through
        the copy-on-write barrier (so no block there is shared), and the
        verify step rewrites ``fed .. fed+k`` (its scatter runs before
        its attention reads) before anything but the row's own later
        draft steps reads them.  The one block there that can be
        hash-registered is the row's own, registered by this tick's plan
        (refcount 1): it holds verify K/V before the next plan can let
        another row adopt it.  Rows that do not draft have ``n_valid`` 0
        in the draft steps, so their writes land in the null block.

        The verify step is the real model feeding ``[t, d_1 .. d_k]``
        with ``all_logits``, under the same per-position key grid as
        plain decode, so its greedy tokens are the plain tokens and the
        pools end as ``a + 1`` plain decode ticks leave them (positions
        past the accepted run hold stale K/V that the length mask hides
        and the next feed overwrites).  Rows that do not speculate ride
        the verify step with their one token and sample from its
        position-0 logits.
        """
        k = self.scheduler.spec_k
        b = len(plan.tokens)
        lengths = self._tensor(plan.lengths)
        tables = self._tensor(plan.tables)
        spec_slots = {slot for slot, _ in plan.spec_rows}
        content = self.scheduler.content_mode
        # the draft needs keys when either model is stochastic (an exact
        # verifier may draft with a stochastic backend)
        stoch = self._stochastic_substrate
        stoch = stoch or self.draft_cfg.sc_backend != "exact"
        dummy = self.scheduler._dummy_key
        base_rng = chain = vkeys = None
        if stoch and not content:
            base_rng = torch.stack(plan.keys).to(self.device)  # (b, 2)
        if stoch and content:
            chain = [plan.keys[r][0] for r in range(b)]  # (2,) per row
            vkeys = [[chain[r]] for r in range(b)]
        draft_nv = self._tensor([int(r in spec_slots) for r in range(b)])
        cur = [int(plan.tokens[r][0]) for r in range(b)]
        drafts: list = [[] for _ in range(b)]
        for i in range(k):
            rng = base_rng
            if chain is not None:
                # host keys, moved to the device once per step
                rng = torch.stack(chain)[:, None, :].to(self.device)
            dlogits, self.pages = lm.decode_paged(
                self.params,
                self.pages,
                tables,
                self._tensor([[c] for c in cur]),
                lengths + i,
                draft_nv,
                self.draft_cfg,
                rng=rng,
            )
            nxt = torch.argmax(dlogits, dim=-1).tolist()  # one sync
            for r in spec_slots:
                drafts[r].append(nxt[r])
                cur[r] = nxt[r]
                if chain is not None:
                    chain[r] = ctr_rng.fold_in(chain[r], nxt[r])
            if vkeys is not None:
                for r in range(b):
                    vkeys[r].append(chain[r] if r in spec_slots else dummy)
        vtok, vnv = [], []
        for r in range(b):
            first = int(plan.tokens[r][0])
            if r in spec_slots:
                vtok.append([first] + drafts[r])
                vnv.append(k + 1)
            else:
                vtok.append([first] + [0] * k)
                vnv.append(plan.n_valid[r])
        rng = base_rng
        if vkeys is not None:
            rng = torch.stack([torch.stack(v) for v in vkeys])
            rng = rng.to(self.device)  # (b, k + 1, 2)
        vlogits, self.pages = lm.decode_paged(
            self.params,
            self.pages,
            tables,
            self._tensor(vtok),
            lengths,
            self._tensor(vnv),
            self.cfg,
            rng=rng,
            all_logits=True,
        )
        greedy = torch.argmax(vlogits, dim=-1).tolist()  # (b, k+1), sync
        for slot, seq in plan.spec_rows:
            vrow = greedy[slot]
            a = 0
            while a < k and drafts[slot][a] == vrow[a]:
                a += 1
            committed = self.scheduler.on_tokens(slot, seq, vrow[: a + 1])
            self._spec_hist.observe(float(a))
            self._m_spec_drafted.inc(k)
            self._m_spec_accepted.inc(a)
            self.spec_log.append(
                dict(
                    tick=self.ticks,
                    rid=seq.req.rid,
                    k=k,
                    drafted=list(drafts[slot]),
                    verified=vrow,
                    accepted=a,
                    committed=committed,
                )
            )
        self._sample(plan, vlogits[:, 0])

    # ------------------------------------------------------------------
    # Drain / resume (ft.FleetSupervisor's shard-failover contract)
    # ------------------------------------------------------------------
    def drain(self) -> list:
        """Checkpoint and release EVERY request this engine holds
        (admitted rows, then the waiting queue), one checkpoint dict per
        request.

        A checkpoint carries the request's identity (rid, prompt,
        generated so far, raw key, sampling knobs), its scheduler
        position (``fed``, ``pending``, ``prefilling``), the pool's
        ``block_size`` and, for an admitted row of an attention family,
        the K/V of its filled blocks as CPU tensors, so a healthy engine
        can resume it WARM through :meth:`restore` without re-prefilling.
        Waiting requests checkpoint cold, and so do the state-carrying
        families (ssm, hybrid): their recurrent state is not rebuilt from
        pages, so the resume recomputes from tokens, which the
        per-(request key, position) rng contract makes token-identical.
        After ``drain()`` the engine is empty."""
        sched = self.scheduler
        ckpts = []
        for slot in range(self.scfg.slots):
            seq = sched.rows[slot]
            if seq is None:
                continue
            ckpts.append(self._checkpoint_seq(seq, warm=True))
            self.kv.release(seq.req.rid)
            sched.rows[slot] = None
            if seq in sched.admit_stack:
                sched.admit_stack.remove(seq)
            self.tracer.event(
                "request.drain",
                rid=seq.req.rid,
                fed=seq.fed,
                warm=ckpts[-1]["kv"] is not None,
            )
        for seq in list(sched.waiting):
            if seq.fed:  # a warm resume never admitted here
                self.kv.release(seq.req.rid)
                seq.reset_for_recompute()
            ckpts.append(self._checkpoint_seq(seq, warm=False))
            self.tracer.event(
                "request.drain", rid=seq.req.rid, fed=0, warm=False
            )
        sched.waiting.clear()
        sched._update_gauges()
        return ckpts

    def _checkpoint_seq(self, seq, warm: bool) -> dict:
        from repro_torch.serve.kv_cache import blocks_for

        req = seq.req
        key = None if req.key is None else req.key.detach().cpu().clone()
        ckpt = dict(
            rid=req.rid,
            prompt=list(req.prompt),
            generated=list(req.generated),
            max_new_tokens=req.max_new_tokens,
            temperature=req.temperature,
            key=key,
            fed=seq.fed,
            pending=list(seq.pending),
            prefilling=seq.prefilling,
            block_size=self.scfg.block_size,
            kv=None,
        )
        if warm and seq.fed and not self.cache_plan.has_state:
            nblk = blocks_for(seq.fed, self.scfg.block_size)
            ids = self._tensor(self.kv.tables[req.rid][:nblk], torch.int64)
            ckpt["kv"] = {
                name: self.pages[name][:, ids].cpu() for name in ("k", "v")
            }
        return ckpt

    def restore(self, ckpt: dict) -> bool:
        """Resume one drained request on THIS engine.  With a K/V payload
        (and the same block size, and room in the pool) the resume is
        WARM: fresh blocks are allocated, the payload is written into
        them on this engine's device, and the request re-enters the
        admission queue at its head, at its drained position.  Otherwise
        it resumes cold: a plain re-submit carrying the tokens generated
        so far, as after an eviction.  Returns True for a warm resume."""
        req = Request(
            rid=ckpt["rid"],
            prompt=list(ckpt["prompt"]),
            max_new_tokens=ckpt["max_new_tokens"],
            temperature=ckpt["temperature"],
        )
        req.generated = list(ckpt["generated"])
        if ckpt["key"] is not None:
            req.key = torch.as_tensor(ckpt["key"]).clone()
        if ckpt["kv"] is not None and self._restore_warm(req, ckpt):
            self.tracer.event(
                "request.resume", rid=req.rid, fed=ckpt["fed"], warm=True
            )
            return True
        self.submit(req)
        self.tracer.event("request.resume", rid=req.rid, fed=0, warm=False)
        return False

    def _restore_warm(self, req, ckpt: dict) -> bool:
        from repro_torch.serve import scheduler as sched_mod
        from repro_torch.serve.kv_cache import blocks_for

        fed = ckpt["fed"]
        if (
            ckpt["block_size"] != self.scfg.block_size
            or self.cache_plan.has_state
            or fed == 0
            or fed > self.scfg.max_len
            or self.kv.tables.get(req.rid)
            or not self.kv.has_room(req.rid, fed)
            or not self.kv.ensure(req.rid, fed)
        ):
            return False
        nblk = blocks_for(fed, self.scfg.block_size)
        ids = self._tensor(self.kv.tables[req.rid][:nblk], torch.int64)
        for name in ("k", "v"):
            pool = self.pages[name]
            pool[:, ids] = ckpt["kv"][name].to(self.device, pool.dtype)
        seq = sched_mod.Sequence(
            req=req,
            key=req.key,
            fed=fed,
            pending=list(ckpt["pending"]),
            prefilling=ckpt["prefilling"],
        )
        self.scheduler.adopt(seq)
        return True

    def decode_latency_ms(self):
        """p50/p95 decode wall ms per token from the
        ``serve_decode_ms_per_token`` histogram (None with fewer than two
        recorded ticks)."""
        h = self._decode_hist
        if h.count() < 2:
            return None
        return {
            "decode_p50_ms": round(h.percentile(50), 3),
            "decode_p95_ms": round(h.percentile(95), 3),
        }

    def run_until_drained(self, max_ticks: int = 10_000):
        ticks = 0
        while self.scheduler.has_work() and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.scheduler.finished
