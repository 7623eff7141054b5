"""Block-pool paged KV cache: fixed-size token blocks + per-sequence
block tables + a freelist allocator + block-level prefix caching.

The port's copy of ``repro.serve.kv_cache`` (pure Python host-side
bookkeeping; the port imports nothing of the JAX package).  KV memory is
a pool of ``num_blocks`` blocks of ``block_size`` tokens per layer,
sequences map positions through a block table (position t lives in
``pages[table[t // bs], t % bs]``), and blocks alloc/free through a
freelist — a finished request's blocks recycle into waiting requests
mid-batch.

Block 0 is reserved as the NULL block: chunk padding and idle batch rows
scatter their K/V there (``models/attention.py:paged_scatter``), so no
live sequence ever maps it and the allocator never hands it out.

Prefix caching (``enable_prefix_cache=True``, the engine's
``prefix_cache``) shares blocks across sequences.  Every FULL block a
sequence fills is content-addressed by a chain hash over its token
prefix (``_chain_hash``: the parent block's hash plus this block's
tokens, so equal hashes mean equal prefixes from position 0).  Blocks
are refcounted and ``release`` decrefs: a block another sequence still
maps never returns to the freelist.  A ref-0 block whose hash is
registered parks on an LRU list instead; allocation takes freelist
blocks first, then evicts the least recently used cached block.  So the
pool partitions at all times into

    freelist ∪ cached (ref 0, hash-registered) ∪ referenced (ref >= 1)

(``check_invariants``).  Shared or registered blocks are immutable: a
write into one goes through :meth:`PagedKVCache.make_writable`, which
copies it out (copy-on-write) and hands the engine the page copies.
With the cache off every refcount stays 1 and ``adopt_prefix`` /
``note_filled`` / ``make_writable`` change nothing.

The device-side pool tensors live in ``models/lm.py:init_paged_cache``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from collections import OrderedDict

NULL_BLOCK = 0


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    """Geometry of the paged pool.

    ``num_blocks`` COUNTS the reserved null block, so the allocatable
    capacity is ``(num_blocks - 1) * block_size`` tokens.  ``max_len``
    bounds any single sequence (its block table has
    ``ceil(max_len / block_size)`` entries).
    """

    num_blocks: int
    block_size: int
    max_len: int

    def __post_init__(self):
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {self.block_size}")
        if self.num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is the reserved null "
                f"block), got {self.num_blocks}"
            )

    @property
    def blocks_per_seq(self) -> int:
        return -(-self.max_len // self.block_size)

    @property
    def capacity_tokens(self) -> int:
        return (self.num_blocks - 1) * self.block_size


def blocks_for(tokens: int, block_size: int) -> int:
    """How many blocks a sequence of ``tokens`` tokens occupies."""
    return -(-tokens // block_size)


def _chain_hash(parent: str | None, block_tokens) -> str:
    """Content address of one FULL block: hash of (parent hash, tokens)."""
    h = hashlib.sha1()
    if parent is not None:
        h.update(parent.encode())
    h.update(b"|")
    h.update(",".join(str(int(t)) for t in block_tokens).encode())
    return h.hexdigest()


class BlockPool:
    """Freelist over block ids 1..num_blocks-1 (0 is the null block)."""

    def __init__(self, num_blocks: int):
        # LIFO freelist: recently freed blocks are re-used first (their
        # stale contents are fully overwritten before any masked read).
        self._free = list(range(num_blocks - 1, 0, -1))
        self._num_blocks = num_blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def alloc(self, n: int = 1) -> list[int] | None:
        """Pop ``n`` blocks, or None (and no change) if fewer are free."""
        if n > len(self._free):
            return None
        got = self._free[-n:][::-1]
        del self._free[-n:]
        return got

    def free(self, blocks) -> None:
        for b in blocks:
            if not (0 < b < self._num_blocks):
                raise ValueError(f"freeing invalid block id {b}")
            if b in self._free:
                raise ValueError(f"double free of block {b}")
        self._free.extend(blocks)


class PagedKVCache:
    """Host-side paged-cache bookkeeping: pool + per-sequence block tables.

    Device tensors (the per-layer page pools) are owned by the engine —
    this class tracks which blocks belong to which sequence and hands out
    padded block-table rows for the step.

    With a ``metrics`` registry (``repro_torch.obs``), every alloc/free
    updates the block-pool series: ``serve_kv_blocks_allocated_total`` /
    ``serve_kv_blocks_freed_total`` counters plus ``serve_kv_blocks_free``
    and ``serve_kv_block_occupancy`` gauges, and the prefix-sharing
    series ``serve_prefix_cache_*`` / ``serve_kv_cached_blocks``.
    """

    def __init__(
        self,
        cfg: PagedCacheConfig,
        metrics=None,
        enable_prefix_cache: bool = False,
    ):
        self.cfg = cfg
        self.pool = BlockPool(cfg.num_blocks)
        self.tables: dict[int, list[int]] = {}  # seq id -> block ids
        self.prefix_cache = enable_prefix_cache
        # refcount + content-address state (always maintained; only
        # adopt_prefix creates sharing, so with the cache off every ref
        # is 1)
        self.refcounts: dict[int, int] = {}  # block id -> ref
        self.block_hash: dict[int, str] = {}  # block id -> chain hash
        self.hash_to_block: dict[str, int] = {}  # chain hash -> block id
        # ref-0 blocks holding reusable content, oldest first (LRU order)
        self.cached: OrderedDict[int, str] = OrderedDict()
        self._chains: dict[int, list[str]] = {}  # seq id -> block hashes
        self._m_alloc = self._m_freed = None
        if metrics is not None:
            self._m_alloc = metrics.counter(
                "serve_kv_blocks_allocated_total",
                "KV pool blocks handed to sequences",
            )
            self._m_freed = metrics.counter(
                "serve_kv_blocks_freed_total",
                "KV pool blocks returned by finished/evicted sequences",
            )
            self._g_free = metrics.gauge(
                "serve_kv_blocks_free", "allocatable KV blocks currently free"
            )
            self._g_occ = metrics.gauge(
                "serve_kv_block_occupancy",
                "fraction of allocatable KV blocks mapped by sequences",
            )
            self._m_hit_tok = metrics.counter(
                "serve_prefix_cache_hit_tokens_total",
                "context tokens served from cached prefix blocks",
            )
            self._m_lookups = metrics.counter(
                "serve_prefix_cache_lookups_total",
                "prefix-cache lookups at admission",
            )
            self._m_pc_evict = metrics.counter(
                "serve_prefix_cache_evictions_total",
                "cached blocks evicted from the LRU list to satisfy allocs",
            )
            self._m_cow = metrics.counter(
                "serve_prefix_cache_cow_total",
                "copy-on-write block copies (write into a shared or "
                "registered block)",
            )
            self._g_cached = metrics.gauge(
                "serve_kv_cached_blocks",
                "ref-0 blocks parked on the prefix-cache LRU list",
            )
            self._update_gauges()

    def _update_gauges(self) -> None:
        if self._m_alloc is not None:
            self._g_free.set(self.pool.free_blocks)
            self._g_occ.set(round(self.utilization(), 6))
            self._g_cached.set(len(self.cached))

    # ------------------------------------------------------------------
    # Allocation: freelist first, then LRU eviction of cached blocks
    # ------------------------------------------------------------------
    @property
    def allocatable_blocks(self) -> int:
        """Blocks an alloc can obtain: free plus cached-but-unreferenced."""
        return self.pool.free_blocks + len(self.cached)

    @property
    def free_tokens(self) -> int:
        return self.allocatable_blocks * self.cfg.block_size

    def _unregister(self, bid: int) -> None:
        h = self.block_hash.pop(bid, None)
        if h is not None and self.hash_to_block.get(h) == bid:
            del self.hash_to_block[h]

    def _alloc(self, n: int) -> list[int] | None:
        """All-or-nothing alloc of ``n`` blocks, evicting LRU cached
        blocks (unregistering their hashes) when the freelist runs dry."""
        if n > self.allocatable_blocks:
            return None
        while self.pool.free_blocks < n:
            bid, _h = self.cached.popitem(last=False)  # oldest first
            self._unregister(bid)
            self.pool.free([bid])
            if self._m_alloc is not None:
                self._m_pc_evict.inc()
        got = self.pool.alloc(n)
        if got is None:
            raise RuntimeError("block pool lost track of its free blocks")
        for b in got:
            self.refcounts[b] = 1
        return got

    def _decref(self, bid: int) -> None:
        self.refcounts[bid] -= 1
        if self.refcounts[bid] > 0:
            return
        del self.refcounts[bid]
        h = self.block_hash.get(bid)
        if h is not None and self.hash_to_block.get(h) == bid:
            # Reusable content: park on the LRU list, most recent last.
            self.cached[bid] = h
            self.cached.move_to_end(bid)
        else:
            self.block_hash.pop(bid, None)
            self.pool.free([bid])

    def _must_copy(self, bid: int) -> bool:
        """A write into ``bid`` must copy it out first: shared or
        hash-registered blocks are immutable."""
        return self.refcounts.get(bid, 0) > 1 or bid in self.block_hash

    # ------------------------------------------------------------------
    def has_room(self, seq_id: int, upto_tokens: int) -> bool:
        have = len(self.tables.get(seq_id, []))
        upto = min(upto_tokens, self.cfg.max_len)
        need = blocks_for(upto, self.cfg.block_size) - have
        return need <= self.allocatable_blocks

    def ensure(self, seq_id: int, upto_tokens: int) -> bool:
        """Grow ``seq_id``'s table to cover ``upto_tokens`` positions.

        Returns False (allocating nothing) when the pool cannot cover the
        growth — the scheduler then evicts or defers.
        """
        if upto_tokens > self.cfg.max_len:
            raise ValueError(
                f"sequence {seq_id} wants {upto_tokens} tokens > "
                f"max_len {self.cfg.max_len}"
            )
        table = self.tables.setdefault(seq_id, [])
        need = blocks_for(upto_tokens, self.cfg.block_size) - len(table)
        if need <= 0:
            return True
        got = self._alloc(need)
        if got is None:
            return False
        table.extend(got)
        if self._m_alloc is not None:
            self._m_alloc.inc(need)
            self._update_gauges()
        return True

    def release(self, seq_id: int) -> int:
        """Drop every block reference of ``seq_id``; returns how many
        references were dropped.  Refcount-aware: a block another live
        sequence still maps stays allocated."""
        table = self.tables.pop(seq_id, [])
        self._chains.pop(seq_id, None)
        for b in table:
            self._decref(b)
        if self._m_freed is not None and table:
            self._m_freed.inc(len(table))
            self._update_gauges()
        return len(table)

    def table_row(self, seq_id: int) -> list[int]:
        """``seq_id``'s block table padded to ``blocks_per_seq`` with the
        null block — one row of the (b, nb) device array."""
        table = self.tables.get(seq_id, [])
        pad = self.cfg.blocks_per_seq - len(table)
        return table + [NULL_BLOCK] * pad

    def null_row(self) -> list[int]:
        return [NULL_BLOCK] * self.cfg.blocks_per_seq

    @property
    def live_blocks(self) -> int:
        return sum(len(t) for t in self.tables.values())

    def utilization(self) -> float:
        """Fraction of allocatable blocks currently mapped by sequences."""
        total = self.cfg.num_blocks - 1
        return self.live_blocks / total if total else 0.0

    # ------------------------------------------------------------------
    # Prefix cache: chain-hash lookup, hit adoption, registration, COW
    # ------------------------------------------------------------------
    def adopt_prefix(self, seq_id: int, tokens) -> int:
        """Splice the longest cached block chain matching ``tokens`` into
        a FRESH table for ``seq_id``; returns how many context tokens the
        hit covers (0 with the cache off or on a miss).  The hit is
        capped at ``len(tokens) - 1`` so at least one token is left to
        feed."""
        if not self.prefix_cache or self.tables.get(seq_id):
            return 0
        if self._m_alloc is not None:
            self._m_lookups.inc()
        bs = self.cfg.block_size
        hits: list[int] = []
        chain: list[str] = []
        parent = None
        for b0 in range(0, (len(tokens) // bs) * bs, bs):
            h = _chain_hash(parent, tokens[b0 : b0 + bs])
            bid = self.hash_to_block.get(h)
            if bid is None:
                break
            hits.append(bid)
            chain.append(h)
            parent = h
        if not hits:
            return 0
        cached_tokens = min(len(hits) * bs, len(tokens) - 1)
        n_blocks = blocks_for(cached_tokens, bs)
        for bid in hits[:n_blocks]:
            self.refcounts[bid] = self.refcounts.get(bid, 0) + 1
            self.cached.pop(bid, None)  # no longer ref-0
        self.tables[seq_id] = list(hits[:n_blocks])
        self._chains[seq_id] = list(chain[:n_blocks])
        if self._m_alloc is not None:
            self._m_hit_tok.inc(cached_tokens)
            self._update_gauges()
        return cached_tokens

    def match_prefix(self, tokens) -> int:
        """Pure lookup: tokens a fresh :meth:`adopt_prefix` would cover."""
        if not self.prefix_cache:
            return 0
        bs = self.cfg.block_size
        parent, n = None, 0
        for b0 in range(0, (len(tokens) // bs) * bs, bs):
            parent = _chain_hash(parent, tokens[b0 : b0 + bs])
            if parent not in self.hash_to_block:
                break
            n += 1
        return min(n * bs, max(len(tokens) - 1, 0))

    def note_filled(self, seq_id: int, context_tokens, fed: int) -> None:
        """Register every newly FULL block of ``seq_id`` in the hash map
        (``context_tokens[:fed]`` is the content now in the cache)."""
        if not self.prefix_cache:
            return
        bs = self.cfg.block_size
        table = self.tables.get(seq_id, [])
        chain = self._chains.setdefault(seq_id, [])
        while len(chain) < fed // bs:
            i = len(chain)
            parent = chain[i - 1] if i else None
            h = _chain_hash(parent, context_tokens[i * bs : (i + 1) * bs])
            chain.append(h)
            bid = table[i]
            if h not in self.hash_to_block and bid not in self.block_hash:
                self.hash_to_block[h] = bid
                self.block_hash[bid] = h

    def make_writable(
        self, seq_id: int, start_tok: int, end_tok: int
    ) -> list[tuple[int, int]] | None:
        """Copy-on-write barrier for writes into positions
        [``start_tok``, ``end_tok``): every block the span touches that
        is shared (ref > 1) or hash-registered is replaced by a fresh
        block; returns the ``(src, dst)`` page copies the engine applies
        before scattering, or None (changing nothing) when the pool
        cannot supply them."""
        if end_tok <= start_tok:
            return []
        bs = self.cfg.block_size
        table = self.tables.get(seq_id, [])
        lo, hi = start_tok // bs, blocks_for(end_tok, bs)
        span = range(lo, min(hi, len(table)))
        need = [i for i in span if self._must_copy(table[i])]
        if not need:
            return []
        fresh = self._alloc(len(need))
        if fresh is None:
            return None
        copies = []
        chain = self._chains.get(seq_id, [])
        for i, dst in zip(need, fresh):
            src = table[i]
            copies.append((src, dst))
            table[i] = dst
            self._decref(src)
            if i < len(chain):
                del chain[i:]  # rewritten span: chain re-derives
        if self._m_alloc is not None:
            self._m_alloc.inc(len(need))
            self._m_cow.inc(len(need))
            self._update_gauges()
        return copies

    def check_invariants(self) -> None:
        """Assert the bookkeeping contract (refcounts equal table
        references; freelist, cached and referenced partition blocks
        1..n-1; the hash maps agree); raises AssertionError naming the
        broken clause.  O(pool + tables): for tests."""
        free = set(self.pool._free)
        cached = set(self.cached)
        referenced = set(self.refcounts)
        assert NULL_BLOCK not in free | cached | referenced, (
            "null block entered the pool"
        )
        counts: dict[int, int] = {}
        for t in self.tables.values():
            for b in t:
                counts[b] = counts.get(b, 0) + 1
        assert counts == self.refcounts, (
            f"refcounts {self.refcounts} != table references {counts}"
        )
        assert all(r >= 1 for r in self.refcounts.values()), (
            "zero/negative refcount retained"
        )
        assert free | cached | referenced == set(
            range(1, self.cfg.num_blocks)
        ), "pool partition lost blocks"
        overlap = free & cached or free & referenced or cached & referenced
        assert not overlap, "pool partition overlaps"
        for h, b in self.hash_to_block.items():
            assert self.block_hash.get(b) == h, (
                f"hash_to_block[{h[:8]}]={b} but block_hash="
                f"{self.block_hash.get(b)}"
            )
        for b, h in self.cached.items():
            assert self.hash_to_block.get(h) == b, (
                f"cached block {b} not registered under its hash"
            )
        for b in self.block_hash:
            assert b in cached or b in referenced, (
                f"registered block {b} is on the freelist"
            )


def default_num_blocks(slots: int, max_len: int, block_size: int) -> int:
    """Pool size matching a fixed-slot reservation: enough blocks for
    every slot at full length, plus the null block."""
    return 1 + slots * math.ceil(max_len / block_size)
