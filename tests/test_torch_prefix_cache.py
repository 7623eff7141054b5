"""The port's block-level prefix cache: the invariants of
``tests/test_prefix_cache.py`` held on ``repro_torch``'s
``PagedKVCache`` and paged engine, then the port's engine against the
JAX engine.

Host bookkeeping (pure Python in both packages): chain hash, full-block
hits, the ``len - 1`` cap, shared release, LRU order, cache off == the
plain pool, a seeded sweep of random interleavings against a host model
(and the same sweep under hypothesis), and the null block never shared.

Port engine (``moment`` backend, CPU): tokens equal with the cache on
and off under content-chain keys, copy-on-write on a block-multiple
prompt, eviction of a prefix-sharing victim, and re-adoption on resume.

Against the JAX engine (same numpy weights, CPU): four requests that
share an 8-token prefix (two blocks; one prompt is the prefix alone, so
its adoption copies on write) served under ``rng_mode="content"`` on
``pallas_bitexact`` + ``fused_sc`` (d_model 32, nbit 32) and on
``exact`` + ``fused``.  The port's greedy tokens with the cache off and
with it on equal the JAX engine's request for request, and the
``serve_prefix_cache_*`` counters and ``serve_prefill_tokens_total``
equal the reference's, since host bookkeeping is deterministic.  The
JAX runs are shared through a module-scoped fixture; the SC case runs
the JAX engine with the cache on only (its interpret-mode kernels
compile anew for every engine, ~65 s a run), whose tokens equal its
cache-off tokens by the reference's own contract
(``tests/test_prefix_cache.py``).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.configs import get_smoke_config as jax_smoke
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.serve import Request as JaxRequest
from repro.serve import ServeOptions as JaxOptions
from repro.serve import build_engine as jax_build
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams
from repro_torch.serve import (
    PagedCacheConfig,
    PagedKVCache,
    Request,
    ServeOptions,
    build_engine,
)
from repro_torch.serve.kv_cache import _chain_hash


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel worker processes; keep torch to one
    intra-op thread beside the JAX reference."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kv(num_blocks=9, block_size=2, max_len=16, cache=True):
    return PagedKVCache(
        PagedCacheConfig(
            num_blocks=num_blocks, block_size=block_size, max_len=max_len
        ),
        enable_prefix_cache=cache,
    )


# ---------------------------------------------------------------------------
# Chain hash + lookup
# ---------------------------------------------------------------------------


def test_chain_hash_is_prefix_addressed():
    h1 = _chain_hash(None, [5, 9])
    assert h1 == _chain_hash(None, [5, 9])
    assert h1 != _chain_hash(None, [5, 10])
    assert _chain_hash(h1, [7, 7]) != _chain_hash(None, [7, 7])
    assert _chain_hash(None, [1, 23]) != _chain_hash(None, [12, 3])


def test_adopt_prefix_hits_full_blocks_only():
    kv = _kv()
    kv.ensure(0, 5)  # 3 blocks, the last one partial
    kv.note_filled(0, [5, 9, 17, 3, 8], 5)
    assert len(kv.hash_to_block) == 2
    kv.release(0)
    assert len(kv.cached) == 2  # registered blocks park on the LRU
    assert kv.pool.free_blocks == 6  # the partial block freed outright
    assert kv.adopt_prefix(1, [5, 9, 17, 3, 8]) == 4
    assert len(kv.tables[1]) == 2
    assert not kv.cached
    assert kv.adopt_prefix(2, [5, 9, 99, 99, 1]) == 2
    assert kv.match_prefix([5, 9, 17, 3, 8]) == 4
    kv.check_invariants()


def test_adopt_prefix_caps_below_full_context():
    """A fully cached prompt still re-feeds its last token through the
    adopted final block, which copy-on-write copies out."""
    kv = _kv()
    toks = [5, 9, 17, 3]  # exactly 2 full blocks
    kv.ensure(0, 4)
    kv.note_filled(0, toks, 4)
    kv.release(0)
    assert kv.adopt_prefix(1, list(toks)) == 3  # capped at len - 1
    assert len(kv.tables[1]) == 2  # both blocks adopted
    cow = kv.make_writable(1, 3, 4)
    assert len(cow) == 1
    kv.check_invariants()


def test_shared_release_keeps_neighbours_blocks():
    kv = _kv()
    toks = [5, 9, 17, 3, 8, 2]
    kv.ensure(0, 6)
    kv.note_filled(0, toks, 6)
    assert kv.adopt_prefix(1, toks + [7, 7]) == 6
    shared = list(kv.tables[1])
    assert shared == kv.tables[0]
    assert all(kv.refcounts[b] == 2 for b in shared)
    kv.release(0)  # the donor leaves first
    assert kv.tables[1] == shared
    assert all(kv.refcounts[b] == 1 for b in shared)
    assert kv.pool.free_blocks == 5
    kv.check_invariants()
    kv.release(1)
    assert len(kv.cached) == 3
    kv.check_invariants()


def test_lru_eviction_unregisters_oldest_first():
    kv = _kv(num_blocks=7, block_size=2, max_len=8)
    for sid, toks in enumerate(([5, 9], [17, 3], [8, 2])):
        kv.ensure(sid, 2)
        kv.note_filled(sid, toks, 2)
    old, mid, new = (kv.tables[s][0] for s in (0, 1, 2))
    for sid in (0, 1, 2):
        kv.release(sid)
    assert list(kv.cached) == [old, mid, new]
    assert kv.pool.free_blocks == 3
    kv.ensure(9, 8)  # needs 4: 3 free + the oldest cached
    assert old not in kv.cached and kv.block_hash.get(old) is None
    assert mid in kv.cached and new in kv.cached
    assert kv.adopt_prefix(10, [17, 3, 1]) == 2
    kv.check_invariants()


def test_cache_off_is_plain_pool():
    kv = _kv(cache=False)
    kv.ensure(0, 6)
    kv.note_filled(0, [1, 2, 3, 4, 5, 6], 6)
    assert not kv.hash_to_block
    assert kv.adopt_prefix(1, [1, 2, 3, 4, 5, 6]) == 0
    assert kv.make_writable(0, 0, 6) == []
    free_before = kv.pool.free_blocks
    assert kv.release(0) == 3
    assert kv.pool.free_blocks == free_before + 3
    kv.check_invariants()


def test_null_block_never_shared_or_cached():
    kv = _kv()
    kv.ensure(0, 6)
    kv.note_filled(0, [1, 2, 3, 4, 5, 6], 6)
    kv.release(0)
    assert 0 not in kv.cached and 0 not in kv.refcounts
    assert 0 not in kv.block_hash
    with pytest.raises(ValueError):
        kv.pool.free([0])


# ---------------------------------------------------------------------------
# Random interleavings against a host model
# ---------------------------------------------------------------------------

# Templates with overlapping prefixes: admissions share, diverge
# mid-block and re-hit the LRU.
_TEMPLATES = (
    [5, 9, 17, 3, 8, 2, 30, 11],
    [5, 9, 17, 3, 1, 1, 2, 7],
    [5, 9, 40, 40, 8, 2],
    [12, 33, 7, 9],
)


class _HostModel:
    """Drives one PagedKVCache through scheduler-shaped op sequences
    (admit with adoption, chunked feeds through the write barrier,
    release), checking the invariants after every op."""

    def __init__(self, rng: random.Random, chunk=3):
        self.rng = rng
        self.kv = _kv(
            num_blocks=rng.choice((6, 8, 11)), block_size=2, max_len=16
        )
        self.chunk = chunk
        self.live: dict = {}  # sid -> {tokens, fed}
        self.next_sid = 0
        self.cows = 0

    def _tokens(self):
        t = list(self.rng.choice(_TEMPLATES))
        if self.rng.random() < 0.5:  # mutate the tail: mid-block forks
            t = t[: self.rng.randrange(2, len(t))] + [self.rng.randrange(50)]
        return t[: self.kv.cfg.max_len]

    def op_admit(self):
        sid, self.next_sid = self.next_sid, self.next_sid + 1
        toks = self._tokens()
        cached = self.kv.adopt_prefix(sid, toks)
        assert cached < len(toks)
        if not self.kv.has_room(sid, min(len(toks), cached + self.chunk)):
            self.kv.release(sid)  # roll back, as the scheduler does
            return
        self.live[sid] = dict(tokens=toks, fed=cached)

    def op_feed(self):
        if not self.live:
            return
        sid = self.rng.choice(sorted(self.live))
        s = self.live[sid]
        want = min(len(s["tokens"]) - s["fed"], self.chunk)
        if want == 0 or not self.kv.ensure(sid, s["fed"] + want):
            return
        cow = self.kv.make_writable(sid, s["fed"], s["fed"] + want)
        if cow is None:
            return
        self.cows += len(cow)
        bs = self.kv.cfg.block_size
        table = self.kv.tables[sid]
        for i in range(s["fed"] // bs, -(-(s["fed"] + want) // bs)):
            assert self.kv.refcounts[table[i]] == 1
            assert table[i] not in self.kv.block_hash
        s["fed"] += want
        self.kv.note_filled(sid, s["tokens"], s["fed"])

    def op_release(self):
        if not self.live:
            return
        sid = self.rng.choice(sorted(self.live))
        self.kv.release(sid)
        del self.live[sid]

    def run(self, n_ops: int):
        ops = (self.op_admit, self.op_feed, self.op_feed, self.op_release)
        for _ in range(n_ops):
            self.rng.choice(ops)()
            self.kv.check_invariants()
        for sid in sorted(self.live):
            self.kv.release(sid)
            self.kv.check_invariants()
        n = self.kv.cfg.num_blocks - 1
        assert self.kv.pool.free_blocks + len(self.kv.cached) == n


def _sweep(seed: int, n_ops: int = 40) -> int:
    m = _HostModel(random.Random(seed))
    m.run(n_ops)
    return m.cows


def test_interleavings_deterministic_sweep():
    cows = sum(_sweep(seed) for seed in range(220))
    assert cows > 0, "the sweep never hit a copy-on-write"


@settings(max_examples=200, deadline=None)
@given(st.integers(min_value=0, max_value=10**9))
def test_interleavings_hypothesis(seed):
    _sweep(seed)


# ---------------------------------------------------------------------------
# The port's engine (moment backend, CPU)
# ---------------------------------------------------------------------------

_SHARED = [5, 9, 17, 3, 8, 2, 30, 11]


@pytest.fixture(scope="module")
def moment_model():
    cfg = torch_smoke("qwen2-0.5b").replace(
        param_dtype=torch.float32, act_dtype=torch.float32,
        sc_backend="moment", sc_nbit=512,
    )
    gen = torch.Generator().manual_seed(0)
    return tparams.init_params(tlm.lm_param_specs(cfg), gen, "cpu"), cfg


def _serve(params, cfg, reqs, **kw):
    base = dict(paged=True, slots=2, max_len=64, block_size=4,
                prefill_chunk=3)
    eng = build_engine(params, cfg, ServeOptions(**{**base, **kw}),
                       device="cpu")
    for r in reqs:
        eng.submit(r)
    ticks = 0
    while eng.scheduler.has_work():
        eng.step()
        eng.kv.check_invariants()
        ticks += 1
        assert ticks < 500
    return eng, {r.rid: r.generated for r in eng.finished}


def test_tokens_equal_cache_on_vs_off_moment(moment_model):
    """Greedy and sampled tokens are the same with the cache on and off
    under content-chain keys; the late request adopts the prefix."""
    params, cfg = moment_model
    mk = lambda: [  # noqa: E731
        Request(rid=i, prompt=_SHARED + [20 + i, 21 + i], max_new_tokens=5,
                temperature=t)
        for i, t in enumerate((0.0, 0.0, 0.7))
    ]
    e_off, off = _serve(params, cfg, mk(), rng_mode="content")
    e_on, on = _serve(params, cfg, mk(), prefix_cache=True)
    assert on == off
    hits = e_on.metrics.value("serve_prefix_cache_hit_tokens_total")
    assert hits and hits >= (len(_SHARED) // 4) * 4
    assert e_on.metrics.value("serve_prefill_tokens_total") < \
        e_off.metrics.value("serve_prefill_tokens_total")


def test_cow_fires_when_prompt_is_block_multiple(moment_model):
    params, cfg = moment_model
    mk = lambda: [  # noqa: E731
        Request(rid=i, prompt=list(_SHARED), max_new_tokens=4)
        for i in range(2)
    ]
    _, off = _serve(params, cfg, mk(), rng_mode="content", slots=1)
    e_on, on = _serve(params, cfg, mk(), prefix_cache=True, slots=1)
    assert on == off
    assert e_on.metrics.value("serve_prefix_cache_cow_total") >= 1


def test_eviction_of_prefix_sharing_victim(moment_model):
    params, cfg = moment_model
    mk = lambda: [  # noqa: E731
        Request(rid=i, prompt=_SHARED + [20 + i], max_new_tokens=12)
        for i in range(2)
    ]
    roomy_e, roomy = _serve(params, cfg, mk(), prefix_cache=True, max_len=28)
    tight_e, tight = _serve(params, cfg, mk(), prefix_cache=True,
                            max_len=28, num_blocks=8)
    assert tight_e.evictions > 0, "the pool was meant to force an eviction"
    assert roomy_e.evictions == 0
    assert tight == roomy


def test_resumed_victim_readopts_its_own_blocks(moment_model):
    params, cfg = moment_model
    mk = lambda: [  # noqa: E731
        Request(rid=i, prompt=_SHARED + [20 + i], max_new_tokens=12)
        for i in range(2)
    ]
    e, _ = _serve(params, cfg.replace(sc_backend="exact"), mk(),
                  prefix_cache=True, max_len=28, num_blocks=8)
    assert e.evictions > 0
    assert e.metrics.value("serve_prefix_cache_lookups_total") >= 3
    assert e.metrics.value("serve_prefix_cache_hit_tokens_total") > \
        len(_SHARED) - 4


# ---------------------------------------------------------------------------
# Against the JAX engine
# ---------------------------------------------------------------------------

PREFIX = [7, 19, 33, 4, 81, 5, 60, 12]  # two full 4-token blocks
PROMPTS = (PREFIX + [40, 41], PREFIX + [52], list(PREFIX), PREFIX + [63])
CASES = {
    "bitexact_fused_sc": dict(
        d_model=32, d_ff=64, vocab=128, sc_backend="pallas_bitexact",
        sc_nbit=32, paged_attn="fused_sc",
    ),
    "exact_fused": dict(d_ff=256, vocab=128, paged_attn="fused"),
}
COUNTERS = (
    "serve_prefix_cache_hit_tokens_total",
    "serve_prefix_cache_lookups_total",
    "serve_prefix_cache_cow_total",
    "serve_prefix_cache_evictions_total",
    "serve_prefill_tokens_total",
    "serve_tokens_generated_total",
)


def _drive(engine, request_cls):
    for rid, prompt in enumerate(PROMPTS):
        engine.submit(request_cls(rid=rid, prompt=list(prompt),
                                  max_new_tokens=4))
    ticks = 0
    while engine.scheduler.has_work():
        engine.step()
        ticks += 1
        assert ticks < 200
    return {r.rid: list(r.generated) for r in engine.finished}


@pytest.fixture(scope="module", params=sorted(CASES))
def served(request):
    """One case's runs, content keys throughout, the same numpy weights:
    {cache: (JAX engine, its tokens, port engine, its tokens)}, the JAX
    entries None where the case skips that JAX run."""
    dims = CASES[request.param]
    jcfg = jax_smoke("qwen2-0.5b").replace(
        param_dtype=jnp.float32, act_dtype=jnp.float32, **dims
    )
    tcfg = torch_smoke("qwen2-0.5b").replace(
        param_dtype=torch.float32, act_dtype=torch.float32, **dims
    )
    jp = jparams.init_params(
        jax.random.PRNGKey(0), jlm.lm_param_specs(jcfg), jnp.float32
    )
    tp = tparams.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    base = dict(paged=True, slots=2, max_len=32, block_size=4,
                prefill_chunk=3)
    runs = {}
    for name, kw in (("off", dict(rng_mode="content")),
                     ("on", dict(prefix_cache=True))):
        jeng = jtok = None
        if name == "on" or "sc_backend" not in dims:
            jeng = jax_build(jp, jcfg, JaxOptions(**base, **kw))
            jtok = _drive(jeng, JaxRequest)
        teng = build_engine(tp, tcfg, ServeOptions(**base, **kw),
                            device="cpu")
        runs[name] = (jeng, jtok, teng, _drive(teng, Request))
    return request.param, runs


def test_prefix_cache_tokens_match_jax_engine(served):
    case, runs = served
    want = runs["on"][1]
    assert sorted(want) == list(range(len(PROMPTS)))
    for name, (_, jtok, _, ttok) in runs.items():
        assert jtok is None or jtok == want
        for rid in want:
            assert ttok[rid] == want[rid], f"{case} cache {name} rid {rid}"


def test_prefix_cache_counters_match_jax_engine(served):
    case, runs = served
    for name, (jeng, _, teng, _) in runs.items():
        if jeng is None:
            continue
        for c in COUNTERS:
            assert teng.metrics.value(c) == jeng.metrics.value(c), \
                f"{case} cache {name}: {c}"
        assert teng.ticks == jeng.ticks
    on, off = runs["on"][2].metrics, runs["off"][2].metrics
    assert on.value("serve_prefix_cache_hit_tokens_total") >= len(PREFIX)
    assert on.value("serve_prefix_cache_cow_total") >= 1
    assert off.value("serve_prefix_cache_hit_tokens_total") == 0
    assert off.value("serve_prefill_tokens_total") == \
        sum(len(p) for p in PROMPTS)
    assert on.value("serve_prefill_tokens_total") < \
        off.value("serve_prefill_tokens_total")
