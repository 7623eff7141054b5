"""The paged continuous-batching serving engine.

Port of ``repro.serve.engine.PagedServingEngine``: continuous batching
over a block-pool paged KV cache with chunked prefill, eviction-on-OOM,
and per-request rng.  ``step()`` is a thin loop over
``scheduler.Scheduler``: plan → one ``lm.decode_paged`` call → sample the
rows whose pending context emptied.  The page pools live on the engine's
device and ``decode_paged`` updates them in place.

On a non-ideal device (``ServeOptions.fault_profile``) each tick runs
under ``sc.use_device_profile(engine.device_profile)``, so every
``ScConfig`` the model builds carries the profile.  With
``collect_arch_trace=True`` and ``cfg.sc_backend == "array"`` the engine
keeps an arch trace collector installed: every ``array`` call the ticks
EXECUTE records its pulse-schedule cost, and ``arch_report()`` returns
the aggregate cycles / energy / utilization.  This differs from the
jitted reference, whose collector records once per COMPILED shape: the
port bills the work it ran (each record's plan and price equal the
reference's for that shape).  ``close()`` (or a raise mid-tick)
detaches the collector.

What the port does not have yet raises at construction (see
``serve/api.py``): prefix caching and speculative decoding (ROADMAP
queue 1 item 5), the fixed-slot engine and drain/restore (item 9), and
families other than dense (item 7).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch import obs, sc
from repro_torch.models import attention, lm
from repro_torch.sc import ctr_rng


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list  # token ids
    max_new_tokens: int = 16
    temperature: float = 0.0
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    # Per-request raw (2,) uint32 key.  The engine folds it from the
    # engine seed + rid at submission unless the caller set one; every
    # stochastic draw for this request (SC bits, sampling) derives from
    # it, making results independent of batch composition.
    key: object = None


@dataclasses.dataclass(frozen=True)
class PagedServeConfig:
    """Knobs of the paged continuous-batching engine.

    ``num_blocks = 0`` sizes the pool for every slot at full ``max_len``
    plus the null block; ``prefill_chunk`` caps how many prompt tokens
    one tick feeds per row.
    """

    slots: int = 4
    max_len: int = 256
    eos_id: int = 2
    seed: int = 0
    block_size: int = 16
    num_blocks: int = 0
    prefill_chunk: int = 8


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


class PagedServingEngine:
    """Continuous batching over a paged KV cache (see the module doc).

    ``device`` holds the page pools and runs every step; ``params`` must
    already lie there.  Telemetry: each engine owns an always-on metrics
    registry (``self.metrics``) unless the caller supplies one; the
    tracer defaults to the always-off ``NULL_TRACER``.
    """

    # Non-ideal device realized while this engine ticks (set by
    # serve.api.build_engine from options.fault_profile; None = ideal).
    device_profile = None

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

        self.params = params
        self.cfg = cfg
        self.scfg = scfg
        self.device = torch.device(device)
        if metrics is None:
            metrics = obs.MetricsRegistry()
        self.metrics = metrics
        self.tracer = tracer if tracer is not None else obs.NULL_TRACER
        self._m_ticks = self.metrics.counter(
            "serve_ticks_total", "engine ticks, labeled kind=prefill|decode"
        )
        self._m_errors = self.metrics.counter(
            "serve_errors_total", "engine ticks that raised"
        )
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
        self.kv = kvc.PagedKVCache(pcfg, metrics=self.metrics)
        self.pages = lm.init_paged_cache(
            cfg, num_blocks, scfg.block_size, device=self.device
        )
        self.scheduler = sched.Scheduler(
            scfg,
            self.kv,
            base_key=ctr_rng.prng_key(scfg.seed),
            on_finish=self._on_finish,
            metrics=self.metrics,
            tracer=self.tracer,
        )
        self._arch_closed = False
        self.arch_collector = None
        if collect_arch_trace and cfg.sc_backend == "array":
            from repro_torch import arch

            self.arch_collector = arch.TraceCollector().install()
        # fused_sc attention draws per-token stochastic logits even when
        # the dense substrate is exact, so it needs per-request keys too
        self._stochastic_substrate = (
            cfg.sc_backend != "exact" or cfg.paged_attn == "fused_sc"
        )
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

    def _on_finish(self, req: Request):
        if self.arch_collector is not None:
            self.arch_collector.note_request(
                req.rid, len(req.prompt) + len(req.generated)
            )

    # -- arch trace ----------------------------------------------------
    def arch_report(self):
        """Aggregate arch cost of every ``array`` call executed so far
        (None when collection is off or nothing was recorded).  The
        collector hears every array-backend call in the process while
        installed, not only this engine's."""
        collector = self.arch_collector
        if collector is None or not collector.records:
            return None
        return collector.aggregate()

    def arch_request_costs(self):
        """Per-request cost attribution (None without a trace or without
        finished requests): the aggregate prorated by each request's
        token count — ``TraceCollector.cost_per_request``."""
        collector = self.arch_collector
        if collector is None or not collector.request_tokens:
            return None
        return collector.cost_per_request()

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

    # ------------------------------------------------------------------
    def step(self):
        """One tick: scheduler plan → one chunked step → sample the rows
        that consumed their pending context.  Returns False when idle.
        A raise mid-tick detaches the arch collector."""
        try:
            with sc.use_device_profile(self.device_profile):
                return self._tick()
        except Exception:
            self._m_errors.inc()
            self.close()
            raise

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
        kind = "decode" if plan.sc == 1 else "prefill"
        live = sum(1 for nv in plan.n_valid if nv)
        self._m_ticks.inc(kind=kind)
        with self.tracer.span(
            "engine.tick",
            tick=self.ticks,
            kind=kind,
            live=live,
            width=plan.sc,
        ):
            self._run_plan(plan, live)
        self.ticks += 1
        return True

    def _tensor(self, rows, dtype=torch.int32):
        return torch.tensor(rows, dtype=dtype).to(self.device)

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
        if plan.sample_rows:
            # One batched sampling call + one host sync per tick;
            # non-sampling slots get dummy keys and are discarded.
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
