"""Continuous-batching scheduler: admission, chunked prefill, eviction,
prefix-cache adoption and speculative-decode planning.

Port of ``repro.serve.scheduler``.  One scheduler tick produces one
:class:`TickPlan` — the padded arrays a single
``models/lm.py:decode_paged`` call consumes.  Every batch row is in
exactly one phase per tick:

* **prefill** — the row feeds the next ``prefill_chunk`` tokens of its
  pending context (prompt, or prompt + generated after an eviction);
* **decode** — the row feeds its one last sampled token;
* **idle** — no request mapped (or deferred this tick): ``n_valid = 0``,
  K/V writes go to the null block, logits ignored.

Requests admit from a FIFO queue the moment a row and enough pool blocks
free up.  With prefix caching on, admission first ADOPTS the longest
cached block chain matching the request's context
(``PagedKVCache.adopt_prefix``): adopted tokens skip prefill.  When the
pool cannot cover a row's next chunk, the most recently admitted *other*
row is evicted (LIFO victim, recompute policy): its block references
drop (blocks a neighbour shares stay put) and it re-queues at the FRONT
with ``pending = prompt + generated``.  Every feed passes the
copy-on-write barrier (``PagedKVCache.make_writable``) first; its page
copies ride the plan for the engine to apply before the step.

RNG contract, two modes:

* ``rng_mode="request"``: each request's key is folded ONCE at
  submission (``fold_in(base_key, rid)`` unless the request carries its
  own), and every stochastic draw downstream — SC bits per token and the
  sampling draw per generated token — derives from (that key, absolute
  position).
* ``rng_mode="content"`` (forced by ``prefix_cache``): the SC key of
  context token t is a chain over token content,
  ``C_t = fold_in(C_{t-1}, token_t)`` from
  ``fold_in(base_key, _CONTENT_SALT)``, so requests sharing a prefix
  draw the same SC bits there and a cached block is reusable across
  them.  Sampling keys stay per request (``sample_key``).

Keys are raw ``(2,)`` ``uint32`` tensors on the host.

Speculative decoding: on a pure-decode tick, greedy post-prefill rows
with pool headroom through ``fed + 1 + spec_k`` are marked
``spec_rows``; the engine drafts ``spec_k`` tokens and verifies them in
one width-(k+1) step, and ``on_tokens`` commits the accepted run.  The
scheduler only plans it (block reservation and the write barrier over
the drafted span).
"""

from __future__ import annotations

import dataclasses
from collections import deque

import torch

from repro_torch import obs
from repro_torch.sc import ctr_rng
from repro_torch.serve.kv_cache import PagedKVCache

_SAMPLE_SALT = 0x5EED  # separates sampling folds from SC-bit folds
_CONTENT_SALT = 0xC047  # seeds the content-chain keys (rng_mode=content)


@dataclasses.dataclass
class Sequence:
    """One admitted request's scheduling state."""

    req: object  # serve.engine.Request
    key: object  # raw (2,) uint32 per-request key
    fed: int = 0  # context tokens already in the cache
    pending: list = dataclasses.field(default_factory=list)
    # True while the row is feeding context; pure observability state
    prefilling: bool = True
    # Content-chain SC keys, one per context position (content mode
    # only; extended lazily).  ckeys[t] is a function of tokens[0..t] and
    # the engine seed alone, so it survives eviction/resume unchanged.
    ckeys: list = dataclasses.field(default_factory=list)

    @property
    def context_len(self) -> int:
        return len(self.req.prompt) + len(self.req.generated)

    def context_tokens(self) -> list:
        return list(self.req.prompt) + list(self.req.generated)

    def reset_for_recompute(self) -> None:
        """Eviction: drop cache state, keep tokens; re-prefill everything.
        ``ckeys`` survives: content keys depend on tokens alone."""
        self.fed = 0
        self.pending = self.context_tokens()
        self.prefilling = True


@dataclasses.dataclass
class TickPlan:
    """Arrays for one ``decode_paged`` call, plus host bookkeeping."""

    sc: int  # chunk width of this tick (1 = decode)
    tokens: list  # (b, sc) int
    lengths: list  # (b,) pre-feed fill
    n_valid: list  # (b,) real tokens per row
    tables: list  # (b, nb) block-table rows
    keys: list  # (b,) raw per-request keys, or (sc, 2) content keys
    sample_rows: list  # [(slot, Sequence)] rows to sample after
    # copy-on-write page copies [(src, dst)] the engine applies BEFORE
    # the step (a write this tick lands in a block that was shared)
    copies: list = dataclasses.field(default_factory=list)
    # [(slot, Sequence)] rows the engine drafts and verifies this tick
    # (their pool span through fed + spec_k is reserved and writable)
    spec_rows: list = dataclasses.field(default_factory=list)


class Scheduler:
    """Owns the waiting queue, the row grid, and the block allocator.

    ``metrics`` (a ``repro_torch.obs`` registry) and ``tracer`` are the
    observability hooks: the request-lifecycle counters and the
    ``request.*`` / ``prefill.chunk`` trace events.
    """

    def __init__(
        self,
        scfg,
        kv: PagedKVCache,
        base_key,
        on_finish=None,
        metrics=None,
        tracer=None,
    ):
        self.scfg = scfg
        self.kv = kv
        self.base_key = base_key
        self.on_finish = on_finish  # called with each finished Request
        self.waiting: deque = deque()
        self.rows: list = [None] * scfg.slots  # slot -> Sequence | None
        self.admit_stack: list = []  # admission order (LIFO)
        self.finished: list = []
        self.evictions = 0
        self._dummy_key = ctr_rng.prng_key(0)
        # content-chain mode: forced by prefix caching (shared KV blocks
        # need content-derived SC bits), or asked for on its own
        self.content_mode = bool(
            scfg.prefix_cache or scfg.rng_mode == "content"
        )
        self._content_base = ctr_rng.fold_in(base_key, _CONTENT_SALT)
        self.speculative = bool(scfg.speculative)
        self.spec_k = int(scfg.spec_k)
        m = metrics
        if m is None:
            m = obs.MetricsRegistry(enabled=False)
        self.tracer = tracer if tracer is not None else obs.NULL_TRACER
        self._m_submitted = m.counter(
            "serve_requests_submitted_total", "requests entering the queue"
        )
        self._m_admitted = m.counter(
            "serve_requests_admitted_total",
            "admissions onto a batch row (re-admissions after eviction "
            "count again)",
        )
        self._m_finished = m.counter(
            "serve_requests_finished_total", "requests completed"
        )
        self._m_evicted = m.counter(
            "serve_evictions_total", "LIFO recompute evictions"
        )
        self._m_prefill_tok = m.counter(
            "serve_prefill_tokens_total",
            "context tokens fed through prefill chunks (resumes re-count; "
            "prefix-cache hits never reach here)",
        )
        self._m_generated = m.counter(
            "serve_tokens_generated_total", "tokens sampled across requests"
        )
        self._g_queue = m.gauge("serve_queue_depth", "requests waiting")
        self._g_active = m.gauge(
            "serve_active_requests", "requests holding a batch row"
        )

    def _update_gauges(self) -> None:
        self._g_queue.set(len(self.waiting))
        self._g_active.set(self.active_count)

    # ------------------------------------------------------------------
    def submit(self, req) -> None:
        key = getattr(req, "key", None)
        if key is None:
            key = ctr_rng.fold_in(self.base_key, req.rid)
            req.key = key
        pending = list(req.prompt) + list(req.generated)
        self.waiting.append(Sequence(req=req, key=key, pending=pending))
        self._m_submitted.inc()
        self._update_gauges()
        self.tracer.event(
            "request.submit", rid=req.rid, prompt_tokens=len(req.prompt)
        )

    def has_work(self) -> bool:
        return bool(self.waiting) or any(r is not None for r in self.rows)

    @property
    def active_count(self) -> int:
        return sum(r is not None for r in self.rows)

    # ------------------------------------------------------------------
    def _evict_victim(self, keep: Sequence) -> int | None:
        """Free the most recently admitted row other than ``keep``;
        returns the evicted slot, or None when ``keep`` is the only
        admitted row."""
        for victim in reversed(self.admit_stack):
            if victim is keep:
                continue
            slot = self.rows.index(victim)
            self.kv.release(victim.req.rid)
            self.rows[slot] = None
            self.admit_stack.remove(victim)
            victim.reset_for_recompute()
            self.waiting.appendleft(victim)
            self.evictions += 1
            self._m_evicted.inc()
            self._update_gauges()
            self.tracer.event(
                "request.evict",
                rid=victim.req.rid,
                generated=len(victim.req.generated),
            )
            return slot
        return None

    def _admit(self) -> None:
        for slot in range(self.scfg.slots):
            if self.rows[slot] is not None or not self.waiting:
                continue
            seq = self.waiting[0]
            cached = self.kv.adopt_prefix(seq.req.rid, seq.context_tokens())
            if cached:
                seq.fed = cached
                seq.pending = seq.context_tokens()[cached:]
            first = min(len(seq.pending), self.scfg.prefill_chunk)
            if not self.kv.has_room(seq.req.rid, seq.fed + first):
                if cached:  # roll the adoption back: hits return to the LRU
                    self.kv.release(seq.req.rid)
                    seq.reset_for_recompute()
                break  # FIFO: don't starve the head
            self.waiting.popleft()
            self.kv.ensure(seq.req.rid, seq.fed + first)
            self.rows[slot] = seq
            self.admit_stack.append(seq)
            self._m_admitted.inc()
            self._update_gauges()
            self.tracer.event(
                "request.admit",
                rid=seq.req.rid,
                slot=slot,
                resumed=bool(seq.req.generated),
                cached_tokens=cached,
            )

    # ------------------------------------------------------------------
    def _extend_ckeys(self, seq: Sequence, upto: int) -> None:
        """Grow ``seq.ckeys`` to cover positions [0, upto): the content
        chain ``C_t = fold_in(C_{t-1}, token_t)`` over prompt +
        generated."""
        ctx = seq.context_tokens()
        while len(seq.ckeys) < upto:
            t = len(seq.ckeys)
            prev = seq.ckeys[t - 1] if t else self._content_base
            seq.ckeys.append(ctr_rng.fold_in(prev, int(ctx[t])))

    def _row_keys(self, seq, n: int, sc: int):
        """One ``TickPlan.keys`` row: the raw request key (request mode)
        or the (sc, 2) content keys of the fed span (content mode),
        dummy-padded; dummies key null-block writes only."""
        if not self.content_mode:
            return self._dummy_key if seq is None else seq.key
        if seq is None or n == 0:
            return torch.stack([self._dummy_key] * sc)
        self._extend_ckeys(seq, seq.fed + n)
        ks = seq.ckeys[seq.fed : seq.fed + n]
        return torch.stack(ks + [self._dummy_key] * (sc - n))

    # ------------------------------------------------------------------
    def plan(self) -> TickPlan | None:
        """Build the next tick, mutating row state optimistically (the
        engine always executes the returned plan).  None = nothing to do.

        Pass A reserves pool blocks (and copy-on-write copies) for every
        row's intended feed, evicting LIFO victims on OOM — and
        cancelling a victim's feed granted earlier in this same tick.
        On a pure-decode tick, greedy post-prefill rows that can reserve
        and make writable their span through ``fed + 1 + spec_k`` then
        become speculative rows (opportunistically: a row that cannot
        falls back to plain decode and never evicts for it).  Pass B
        builds the padded arrays for the feeds that survived.  A row
        always feeds ``min(len(pending), prefill_chunk)`` tokens, so its
        chunk boundaries never depend on its batch neighbours; the tick
        width is the chunk width when any row feeds more than one token,
        else 1 (pure decode).
        """
        self._admit()
        if not any(r is not None for r in self.rows):
            return None
        planned: dict = {}  # slot -> granted feed length
        copies: list = []
        for slot in range(self.scfg.slots):
            seq = self.rows[slot]
            if seq is None:  # may have been evicted above
                continue
            want = min(len(seq.pending), self.scfg.prefill_chunk)
            while want:
                if self.kv.ensure(seq.req.rid, seq.fed + want):
                    # copy-on-write barrier over the write span
                    cw = self.kv.make_writable(
                        seq.req.rid, seq.fed, seq.fed + want
                    )
                    if cw is not None:
                        copies.extend(cw)
                        break
                victim_slot = self._evict_victim(keep=seq)
                if victim_slot is None:
                    want = 0  # defer: sole row, pool full
                    break
                planned.pop(victim_slot, None)
            planned[slot] = want
        sc = 1
        if any(n > 1 for n in planned.values()):
            sc = self.scfg.prefill_chunk
        spec_slots = self._plan_spec(planned, copies) if sc == 1 else set()
        tokens, lengths, n_valid, tables, keys = [], [], [], [], []
        sample_rows, spec_rows = [], []
        for slot in range(self.scfg.slots):
            seq = self.rows[slot]
            n = planned.get(slot, 0)
            if seq is None:
                tokens.append([0] * sc)
                lengths.append(0)
                n_valid.append(0)
                tables.append(self.kv.null_row())
                keys.append(self._row_keys(None, 0, sc))
                continue
            feed = seq.pending[:n]
            seq.pending = seq.pending[n:]
            tokens.append(list(feed) + [0] * (sc - n))
            lengths.append(seq.fed)
            n_valid.append(n)
            keys.append(self._row_keys(seq, n, sc))
            seq.fed += n
            tables.append(self.kv.table_row(seq.req.rid))
            if n and seq.prefilling:
                self._m_prefill_tok.inc(n)
                self.tracer.event(
                    "prefill.chunk", rid=seq.req.rid, tokens=n, fed=seq.fed
                )
                if not seq.pending:
                    seq.prefilling = False
            if n:
                ctx = seq.context_tokens()
                self.kv.note_filled(seq.req.rid, ctx, seq.fed)
            if n and not seq.pending:
                rows = spec_rows if slot in spec_slots else sample_rows
                rows.append((slot, seq))
        return TickPlan(
            sc=sc,
            tokens=tokens,
            lengths=lengths,
            n_valid=n_valid,
            tables=tables,
            keys=keys,
            sample_rows=sample_rows,
            copies=copies,
            spec_rows=spec_rows,
        )

    def _plan_spec(self, planned: dict, copies: list) -> set:
        """Slots that speculate this (pure-decode) tick: greedy decode
        rows whose verify span ``[fed, fed + 1 + spec_k)`` fits
        ``max_len``, can be reserved, and passes the write barrier over
        the drafted positions (its copies join ``copies``)."""
        spec_slots: set = set()
        if not self.speculative or self.spec_k <= 0:
            return spec_slots
        for slot in range(self.scfg.slots):
            seq = self.rows[slot]
            if (
                seq is None
                or planned.get(slot, 0) != 1
                or seq.prefilling
                or seq.req.temperature > 0.0
            ):
                continue
            end = seq.fed + 1 + self.spec_k  # verify writes fed..fed+k
            if end > self.scfg.max_len:
                continue
            if not self.kv.ensure(seq.req.rid, end):
                continue
            cw = self.kv.make_writable(seq.req.rid, seq.fed + 1, end)
            if cw is None:
                continue
            copies.extend(cw)
            spec_slots.add(slot)
        return spec_slots

    # ------------------------------------------------------------------
    def sample_key(self, seq: Sequence):
        """Key for the sampling draw at ``seq``'s current position — a
        function of (request key, position) only."""
        salted = ctr_rng.fold_in(seq.key, _SAMPLE_SALT)
        return ctr_rng.fold_in(salted, seq.fed)

    def on_token(self, slot: int, seq: Sequence, token: int) -> None:
        """Record a sampled token and finish or continue the row."""
        self.on_tokens(slot, seq, [token])

    def on_tokens(self, slot: int, seq: Sequence, toks: list) -> int:
        """Commit a run of tokens for one row (one token = plain decode;
        more = a speculative accept run whose first len-1 tokens already
        have verify-grade KV in the cache).  Finish conditions are
        checked per token: an EOS mid-run truncates the commit.  Returns
        how many tokens were committed."""
        for i, token in enumerate(toks):
            if i > 0:
                # the previous token's KV was written by the verify pass
                # at position fed: advance past it
                seq.fed += 1
            seq.req.generated.append(token)
            self._m_generated.inc()
            hit_eos = token == self.scfg.eos_id
            hit_max = len(seq.req.generated) >= seq.req.max_new_tokens
            hit_cap = seq.fed >= self.scfg.max_len - 1
            if hit_eos or hit_max or hit_cap:
                self._finish(slot, seq)
                return i + 1
        seq.pending = [toks[-1]]
        return len(toks)

    def _finish(self, slot: int, seq: Sequence) -> None:
        seq.req.done = True
        self.kv.release(seq.req.rid)
        self.rows[slot] = None
        if seq in self.admit_stack:
            self.admit_stack.remove(seq)
        self.finished.append(seq.req)
        self._m_finished.inc()
        self._update_gauges()
        self.tracer.event(
            "request.finish",
            rid=seq.req.rid,
            generated=len(seq.req.generated),
        )
        if self.on_finish is not None:
            self.on_finish(seq.req)
