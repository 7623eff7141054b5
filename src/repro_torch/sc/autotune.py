"""Launch-shape autotuner for the port's bit-exact SC kernels (port of
``repro.sc.autotune``).

The reference tunes the (block_m, block_n, block_k, lane_words) tiling of
its Pallas kernels, whose working set must fit a TPU core's VMEM.  The
Hopper kernels have other knobs, and this module holds those:

* kernel 1, ``csrc/sc_fused.cu`` (:class:`FusedTile`): the threads of a
  block (the outputs along N it computes; one instantiation per supported
  size, so each keeps its own register budget) and the K split (blocks
  along K whose int32 partial totals meet in ``atomicAdd``);
* kernels 2 and 3, ``csrc/paged_attention.cu`` (:class:`AttnTile`): the
  SC logits pass's block size (0 for the exact QK^T, which has no such
  pass).  The split pass's 16 query rows a block (``kRowTile``) are not
  a knob: a decode call of the main path has at most 16 rows a kv head
  (7 in qwen2-0.5b), so any row tile launches the same grid there, and
  at a 56-row prefill no other row tile ran faster on an H100.

No knob changes a bit.  Integer sums are associative, so the K split and
the logits pass's block size only regroup a pop-count total.  What IS a
float order is never a tile: ``pages_per_split`` and ``splits`` fix the
softmax merge and depend on the table alone
(``kernels/paged_attention.py:paged_attention_plan``), and kernel 5's
split plan (``kernels/sc_mac.py:sc_mac_plan``) sums float32 partials;
kernel 4 has nothing the reference tunes.

* a **versioned on-disk cache** (``autotune_cache.json`` beside this
  module, or ``$REPRO_TORCH_SC_AUTOTUNE_CACHE``; never the reference's
  file, which holds Pallas tiles) maps a call shape to its measured-best
  tile, with the µs it took (``wall_us``, the reference's name: kernel
  1's CUDA-event time, the attention calls' device time), the
  heuristic's and the card it was measured on;
  ``tools/torch_autotune.py`` writes it on the card;
* a **deterministic heuristic** answers a miss: the launch shape the
  kernels took before the cache existed (:func:`heuristic_tile`,
  :func:`heuristic_attn_tile`);
* the tuner (:func:`tune_shape`, :func:`tune_attn_shape`) times every
  candidate through the real wrapper on the card: kernel 1 with CUDA
  events (its calls take 0.2-800 ms of the card, which the host keeps
  fed), the attention calls on the card's own clock
  (:func:`device_us`, the profiler's kernel records), since their
  wrappers' 0.04-0.2 ms of host time hides the kernels' 10-400 µs.

The wrappers look a tile up at every launch, so a lookup is memoized per
shape until :func:`reset_cache`: a hit costs a dict lookup on the host.
The telemetry (:func:`_note_lookup`) still counts every executed lookup;
the reference counts at trace time, once per compiled shape.

Cache format (``CACHE_VERSION`` bumps invalidate the whole file)::

    {"version": 1,
     "entries": {"2x896x9728|nbit=1024|dtype=float32":
                 {"threads": 128, "ksplit": 14, "wall_us": 52881.0,
                  "card": "NVIDIA H100 80GB HBM3"},
                 "attn|7x16x64|nbit=1024|dtype=bfloat16":
                 {"logit_threads": 256, ...}}}
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from repro_torch import obs

CACHE_VERSION = 1
DEFAULT_CACHE_PATH = os.path.join(os.path.dirname(__file__),
                                  "autotune_cache.json")
_CACHE_ENV = "REPRO_TORCH_SC_AUTOTUNE_CACHE"

# H100 SXM: the heuristic K split's SM count where the caller names no
# card (the wrapper names the card's own)
DEFAULT_SMS = 132
FUSED_THREADS = (64, 128, 256)  # block sizes csrc/sc_fused.cu instantiates
_FUSED_HEURISTIC_THREADS = 128
_BLOCKS_PER_SM = 16  # the heuristic K split's target occupancy
_LANE_BITS = 32
MAX_LOGIT_THREADS = 1024  # csrc/paged_attention.cu kMaxLogitThreads
# the heuristic logits block: the fastest of 128-1,024 at phase A's decode
# and prefill and at a 1,024-token cache (tools/paged_attention_bench.py
# --logit-threads, PR 15)
HEURISTIC_LOGIT_THREADS = 256


@dataclasses.dataclass(frozen=True)
class FusedTile:
    """Kernel 1's launch shape: ``threads`` outputs along N a block (one
    of :data:`FUSED_THREADS`) and ``ksplit`` blocks along K."""

    threads: int = _FUSED_HEURISTIC_THREADS
    ksplit: int = 1

    def kwargs(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class AttnTile:
    """Kernels 2 and 3's launch shape: ``logit_threads`` threads a block
    of the SC logits pass (0: exact QK^T, no logits pass; else a multiple
    of 32 up to :data:`MAX_LOGIT_THREADS`)."""

    logit_threads: int = 0

    def kwargs(self) -> dict:
        return dataclasses.asdict(self)


def dtype_name(dtype) -> str:
    """The cache's name of a torch dtype: ``torch.bfloat16`` ->
    ``"bfloat16"``."""
    return str(dtype).removeprefix("torch.")


def cache_key(m: int, k: int, n: int, nbit: int,
              dtype: str = "float32") -> str:
    return f"{m}x{k}x{n}|nbit={nbit}|dtype={dtype}"


def attn_cache_key(rows: int, block_size: int, head_dim: int, nbit: int,
                   dtype: str = "float32") -> str:
    """``attn`` kernel-kind key: (query rows, kv block, head dim, nbit).

    ``rows = group * chunk_width`` is the kernels' query-row axis per
    (batch, kv-head) slice; ``nbit = 0`` marks the exact QK^T; ``dtype``
    is q's and the pages' (:func:`dtype_name`).  The kind
    prefix keeps the attention entries disjoint from the matmul keys in
    the same versioned file.
    """
    return (f"attn|{rows}x{block_size}x{head_dim}|nbit={nbit}"
            f"|dtype={dtype}")


def _path(path: str | None) -> str:
    return path or os.environ.get(_CACHE_ENV) or DEFAULT_CACHE_PATH


def load_cache(path: str | None = None) -> dict:
    """Entries of the on-disk cache; {} when absent, invalid, or stale.

    A ``version`` mismatch (``CACHE_VERSION`` bump) invalidates the whole
    file: tables of older kernel generations are never applied.
    """
    try:
        with open(_path(path)) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(payload, dict) or payload.get("version") != \
            CACHE_VERSION:
        return {}
    entries = payload.get("entries")
    return entries if isinstance(entries, dict) else {}


def save_cache(entries: dict, path: str | None = None) -> str:
    path = _path(path)
    with open(path, "w") as f:
        json.dump({"version": CACHE_VERSION, "entries": entries}, f,
                  indent=2, sort_keys=True)
        f.write("\n")
    return path


_CACHE: dict | None = None
# (kind, shape..., sms) -> (result, tile) of the lookups since the cache
# was (re)read
_MEMO: dict = {}


def _cached_entries() -> dict:
    global _CACHE
    if _CACHE is None:
        _CACHE = load_cache()
    return _CACHE


def reset_cache() -> None:
    """Drop the in-process cache and the memoized lookups (tests, and
    after ``tools/torch_autotune.py`` runs)."""
    global _CACHE
    _CACHE = None
    _MEMO.clear()


def _note_lookup(kind: str, result: str, tile) -> None:
    """Telemetry for one tile lookup: a hit/miss counter in the global
    registry (disabled by default) plus the chosen tile folded into the
    innermost open trace span."""
    reg = obs.default_registry()
    if reg.enabled:
        reg.counter(
            "sc_autotune_lookups_total",
            "tile-cache lookups by the fused backends (hit = stored "
            "measured tile, miss = deterministic heuristic)").inc(
                kind=kind, result=result)
    tr = obs.current_tracer()
    if tr is not None and tr.enabled:
        tr.attr(sc_autotune=result,
                sc_tile=str(dataclasses.astuple(tile)))


def _lookup(kind: str, memo_key: tuple, cache, resolve):
    """``resolve(entries) -> (result, tile)``, memoized for the shipped
    cache; an explicit ``cache`` is read afresh."""
    if cache is not None:
        result, tile = resolve(cache)
    else:
        hit = _MEMO.get(memo_key)
        if hit is None:
            hit = _MEMO[memo_key] = resolve(_cached_entries())
        result, tile = hit
    _note_lookup(kind, result, tile)
    return tile


def _k_split(m: int, k: int, n: int, sms: int, threads: int,
             per_sm: int) -> int:
    """Blocks along K so the grid holds ~``per_sm`` blocks per SM: narrow
    outputs (wk / wv at N = 128) would otherwise leave most SMs idle."""
    tiles = m * -(-n // threads)
    want = max(1, min(k, -(-per_sm * sms // max(tiles, 1))))
    chunk = -(-k // want)
    return -(-k // chunk)


def heuristic_tile(m: int, k: int, n: int, nbit: int,
                   sms: int = DEFAULT_SMS) -> FusedTile:
    """Deterministic cache-miss fallback: 128 threads and ~16 blocks an
    SM, the launch kernel 1 took before the cache existed.  A pure
    function of the shape and the card's SM count (``nbit`` does not
    change the launch)."""
    del nbit
    threads = _FUSED_HEURISTIC_THREADS
    return FusedTile(threads, _k_split(m, k, n, sms, threads,
                                       _BLOCKS_PER_SM))


def _fused_entry(entry, k: int) -> FusedTile | None:
    try:
        tile = FusedTile(threads=int(entry["threads"]),
                         ksplit=int(entry["ksplit"]))
    except (KeyError, TypeError, ValueError):
        return None  # malformed entry -> heuristic
    if tile.threads not in FUSED_THREADS or not 1 <= tile.ksplit <= max(k, 1):
        return None  # a launch the kernel cannot take -> heuristic
    return tile


def get_tile(m: int, k: int, n: int, nbit: int, dtype: str = "float32",
             cache: dict | None = None, *,
             sms: int = DEFAULT_SMS) -> FusedTile:
    """Cache-then-heuristic lookup: THE launch shape of kernel 1.

    A pure function of (shape, nbit, dtype, SM count, cache contents): a
    hit returns the stored tile; a miss, or an entry the kernel cannot
    launch, the heuristic.  Either way the totals are the same bits.
    """
    def resolve(entries):
        tile = _fused_entry(entries.get(cache_key(m, k, n, nbit, dtype)), k)
        if tile is not None:
            return "hit", tile
        return "miss", heuristic_tile(m, k, n, nbit, sms)

    return _lookup("matmul", ("matmul", m, k, n, nbit, dtype, sms), cache,
                   resolve)


def heuristic_attn_tile(rows: int, block_size: int, head_dim: int,
                        nbit: int) -> AttnTile:
    """Deterministic cache-miss fallback: the launch kernels 2 and 3
    took before the cache existed.  The logits pass (``nbit > 0``) gives
    a logit's block one thread per (d, word) pair, 32 to
    :data:`HEURISTIC_LOGIT_THREADS`."""
    del rows, block_size
    threads = 0
    if nbit > 0:
        pairs = head_dim * (nbit // _LANE_BITS)
        threads = min(HEURISTIC_LOGIT_THREADS,
                      max(32, -(-pairs // 32) * 32))
    return AttnTile(logit_threads=threads)


def _attn_entry(entry, nbit: int) -> AttnTile | None:
    try:
        tile = AttnTile(logit_threads=int(entry["logit_threads"]))
    except (KeyError, TypeError, ValueError):
        return None  # malformed entry -> heuristic
    lt = tile.logit_threads
    if not (lt == 0 if nbit <= 0 else
            32 <= lt <= MAX_LOGIT_THREADS and lt % 32 == 0):
        return None  # a launch the kernels cannot take -> heuristic
    return tile


def get_attn_tile(rows: int, block_size: int, head_dim: int, nbit: int,
                  dtype: str = "float32",
                  cache: dict | None = None) -> AttnTile:
    """Cache-then-heuristic lookup for kernels 2 (``nbit = 0``) and 3.

    Same contract as :func:`get_tile`: a pure function of the call
    signature and the cache contents, and no tile changes a bit.
    """
    def resolve(entries):
        tile = _attn_entry(entries.get(
            attn_cache_key(rows, block_size, head_dim, nbit, dtype)), nbit)
        if tile is not None:
            return "hit", tile
        return "miss", heuristic_attn_tile(rows, block_size, head_dim, nbit)

    return _lookup("attn", ("attn", rows, block_size, head_dim, nbit, dtype),
                   cache, resolve)


def candidate_tiles(m: int, k: int, n: int, nbit: int,
                    sms: int = DEFAULT_SMS) -> list:
    """The tuner's search space for one call shape (heuristic included):
    every block size at K splits for 4 to 32 blocks an SM, at most 12
    tiles.  Each costs a launch at the real shape, so the set stays small
    enough for the unembed's ~0.8 s launches."""
    cands = {FusedTile(t, _k_split(m, k, n, sms, t, per_sm))
             for t in FUSED_THREADS for per_sm in (4, 8, 16, 32)}
    cands.add(heuristic_tile(m, k, n, nbit, sms))
    return sorted(cands, key=dataclasses.astuple)


def candidate_attn_tiles(rows: int, block_size: int, head_dim: int,
                         nbit: int) -> list:
    """Search space for one attention call shape (heuristic included):
    for the SC logits pass, 64 to 1,024 threads (no more than one a (d,
    word) pair); the exact QK^T has the heuristic alone."""
    threads = [0]
    if nbit > 0:
        pairs = head_dim * (nbit // _LANE_BITS)
        cap = max(32, -(-pairs // 32) * 32)
        threads = [t for t in (64, 128, 256, 512, MAX_LOGIT_THREADS)
                   if t <= cap] or [32]
    cands = {AttnTile(t) for t in threads}
    cands.add(heuristic_attn_tile(rows, block_size, head_dim, nbit))
    return sorted(cands, key=dataclasses.astuple)


def _card(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the autotuner times the kernels on a CUDA "
                           "device; none is available")
    return dev


_SAMPLE_US = 2000.0  # a timing sample spans at least this many µs


def _event_us(run, iters: int, warmup: int) -> float:
    """Median CUDA-event µs of one ``run()`` over ``iters`` samples,
    after ``warmup`` calls.  A sample is as many calls back to back as
    fill :data:`_SAMPLE_US` (one for kernel 1's large shapes), so a
    short call's launch jitter averages out."""
    def sample(reps: int) -> float:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            run()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) * 1e3 / reps

    for _ in range(max(warmup, 1)):
        run()
    torch.cuda.synchronize()
    reps = max(1, min(1000, int(_SAMPLE_US / max(sample(1), 1.0))))
    times = sorted(sample(reps) for _ in range(iters))
    return times[len(times) // 2]


_DEVICE_REPS = 20  # calls a profiled sample holds


def device_us(run, launches: int, kernel: str, iters: int = 3,
              warmup: int = 1, reps: int = _DEVICE_REPS) -> float:
    """Median device µs of one ``run()`` over ``iters`` samples, after
    ``warmup`` calls.  A sample is ``reps`` calls back to back under
    ``torch.profiler``; each call launches ``launches`` distinct kernels
    whose names hold ``kernel``, each once, and the sample's time is the
    sum over those kernels of each one's mean duration.  The host's time
    between launches is not in it.  The profiler at times drops a
    kernel's record (in a process that has traced before, up to 6 of
    40), so a mean stands on the records it kept; a trace that shows
    another set of kernels, or keeps under half of a kernel's launches,
    is taken again, twice at most.
    """
    from torch.profiler import ProfilerActivity, profile

    def sample() -> float:
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    run()
                torch.cuda.synchronize()
            by_name: dict = {}
            for ev in prof.events():
                if (ev.device_type == torch.autograd.DeviceType.CUDA
                        and not ev.is_user_annotation and kernel in ev.name):
                    by_name.setdefault(ev.name, []).append(
                        ev.time_range.elapsed_us())
            if len(by_name) == launches and all(
                    2 * len(us) >= reps for us in by_name.values()):
                return sum(sum(us) / len(us) for us in by_name.values())
        seen = {name[:40]: len(us) for name, us in by_name.items()}
        raise RuntimeError(f"device_us: {kernel!r} kernels {seen} in "
                           f"{reps} calls, {launches} a call expected")

    for _ in range(max(warmup, 1)):
        run()
    torch.cuda.synchronize()
    times = sorted(sample() for _ in range(iters))
    return times[len(times) // 2]


def measure_tile(m: int, k: int, n: int, nbit: int, tile: FusedTile, *,
                 operand_bits: int = 10, iters: int = 3, warmup: int = 1,
                 seed: int = 0, device="cuda") -> float:
    """Median µs of one kernel-1 launch under ``tile`` (the wrapper
    ``kernels/sc_fused.py:sc_fused_popcount``, per-row keys)."""
    from repro_torch.kernels import sc_fused

    dev = _card(device)
    gen = torch.Generator(dev).manual_seed(seed)
    x = torch.rand((m, k), generator=gen, device=dev) * 2 - 1
    w = torch.rand((k, n), generator=gen, device=dev) * 2 - 1
    keys = torch.randint(0, 2**31, (m, 4), generator=gen, device=dev)
    keys = keys.to(torch.uint32)

    def run():
        sc_fused.sc_fused_popcount(
            keys, x, w, k_orig=k, n_orig=n, nbit=nbit,
            levels=1 << operand_bits, row_keys=True, tile=tile)

    return _event_us(run, iters, warmup)


def tune_shape(m: int, k: int, n: int, nbit: int, *,
               candidates: list | None = None, iters: int = 3,
               verbose: bool = False, device="cuda") -> tuple:
    """Time every candidate tile; returns ``(best_tile, best_us, table)``."""
    cands = candidates
    if cands is None:
        props = torch.cuda.get_device_properties(_card(device))
        cands = candidate_tiles(m, k, n, nbit, props.multi_processor_count)
    table = []
    for tile in cands:
        us = measure_tile(m, k, n, nbit, tile, iters=iters, device=device)
        table.append((tile, us))
        if verbose:
            print(f"  {dataclasses.astuple(tile)!s:<22} {us:12.1f} us",
                  flush=True)
    best_tile, best_us = min(table, key=lambda tu: tu[1])
    return best_tile, best_us, table


def measure_attn_tile(rows: int, block_size: int, head_dim: int, nbit: int,
                      tile: AttnTile, *, heads: tuple = (1, 1),
                      lengths=None, num_pages: int = 8,
                      dtype: str = "float32", operand_bits: int = 10,
                      iters: int = 3, warmup: int = 1, seed: int = 0,
                      device="cuda") -> float:
    """Median device µs (:func:`device_us`) of one call of the
    paged-attention wrapper (kernel 2 at ``nbit = 0``, else kernel 3)
    under ``tile``, with q and the pages in ``dtype``.

    ``heads = (query heads, kv heads)`` sets the group, so the chunk
    width is ``rows / group``; one batch row per entry of ``lengths``
    (its cache length before the chunk; ``None``: one row whose chunk
    ends at its table's last position), ``num_pages`` pages each.
    """
    from repro_torch.kernels import paged_attention as pa

    dev = _card(device)
    h, kvh = heads
    group = h // kvh
    if h % kvh or rows % group:
        raise ValueError(f"rows {rows} and heads {heads}: the rows must "
                         "be a whole number of chunk positions per group")
    sc = rows // group
    if lengths is None:
        lengths = [num_pages * block_size - sc]
    batch = len(lengths)
    gen = torch.Generator(dev).manual_seed(seed)
    pool = (batch * num_pages + 1, block_size, kvh, head_dim)
    dt = getattr(torch, dtype)
    q = torch.randn((batch, sc, h, head_dim), generator=gen, device=dev)
    kp = torch.randn(pool, generator=gen, device=dev)
    vp = torch.randn(pool, generator=gen, device=dev)
    q, kp, vp = q.to(dt), kp.to(dt), vp.to(dt)
    bt = torch.randperm(pool[0] - 1, generator=gen, device=dev) + 1
    bt = bt[: batch * num_pages].reshape(batch, num_pages).to(torch.int32)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    keys = torch.randint(0, 2**31, (batch, sc, 2), generator=gen, device=dev)
    keys = keys.to(torch.uint32)

    if nbit <= 0:
        def run():
            pa.paged_attention_fused(q, kp, vp, bt, ln, tile=tile)
    else:
        def run():
            pa.paged_attention_fused_sc(keys, q, kp, vp, bt, ln, nbit=nbit,
                                        operand_bits=operand_bits, tile=tile)

    plan = pa.paged_attention_plan(batch, kvh, rows, sc, head_dim, num_pages,
                                   block_size, nbit, tile)
    return device_us(run, plan.launches, "paged_attn_", iters, warmup)


def tune_attn_shape(rows: int, block_size: int, head_dim: int, nbit: int, *,
                    candidates: list | None = None, iters: int = 3,
                    verbose: bool = False, **shape) -> tuple:
    """Time every candidate attention tile; ``(best, best_us, table)``.
    ``shape``: :func:`measure_attn_tile`'s ``heads``, ``lengths``,
    ``num_pages``, ``dtype``, ``device``."""
    cands = candidates if candidates is not None else candidate_attn_tiles(
        rows, block_size, head_dim, nbit)
    table = []
    for tile in cands:
        us = measure_attn_tile(rows, block_size, head_dim, nbit, tile,
                               iters=iters, **shape)
        table.append((tile, us))
        if verbose:
            print(f"  {dataclasses.astuple(tile)!s:<22} {us:12.1f} us",
                  flush=True)
    best_tile, best_us = min(table, key=lambda tu: tu[1])
    return best_tile, best_us, table
