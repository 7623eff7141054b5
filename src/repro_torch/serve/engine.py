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

Prefix caching (``PagedServeConfig.prefix_cache``) shares full KV
blocks across requests through ``kv_cache.PagedKVCache`` and forces
content-chain keys (``rng_mode="content"``), so an adopted block holds
the K/V the adopter would have written.  Speculative decoding
(``speculative``) drafts ``spec_k`` tokens per greedy decode row with a
cheap backend and verifies them in one width-(k+1) step
(:meth:`PagedServingEngine._run_spec_plan`); its tokens are the plain
greedy tokens.

What the port does not have yet raises at construction (see
``serve/api.py``): the fixed-slot engine and drain/restore (ROADMAP
queue 1 item 9), and families other than dense (item 7).
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
        if scfg.rng_mode not in ("request", "content"):
            raise ValueError(
                f"rng_mode must be 'request' or 'content', got "
                f"{scfg.rng_mode!r}"
            )
        self.device = torch.device(device)
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
