"""Speculative decoding on the port's paged engine: the speculative tests
of ``tests/test_serve_paged.py`` held on ``repro_torch``, the pool left
by speculative ticks, and the port against the JAX engine.

Port only (CPU, the port's own weights):

* draft-k / verify gives exactly the plain greedy tokens for
  k in {1, 2, 4} on the ``moment`` backend, with the verify step on the
  ``fused`` attention path, with a draft that disagrees (``exact``
  drafting for a noisy ``moment`` verifier), and in a mixed batch (a
  sampled neighbour) under eviction;
* the acceptance counters and histogram equal a replay of ``spec_log``;
* config validation (``spec_k < 1``, an unknown draft backend) and the
  draft pairing against the reference's registry;
* the pool: the draft writes its K/V into the real pools in place, so
  after every tick each live position of every row (``exact`` verify,
  a noisy ``moment`` draft at nbit 32, accepted and rejected) equals,
  bit for bit, the K/V that plain decode ticks leave at that position;
  and with the
  prefix cache on, no block that was shared or hash-registered before a
  tick changes during it (a draft never touches an adopted block).

Against the JAX engine (``pallas_bitexact`` + ``fused_sc``, d_model 32,
nbit 32, the same numpy weights, one module-scoped JAX run): the port's
speculative tokens (k = 2) equal the JAX engine's request for request.
Accepted counts are compared as a statistical class only: both drafts
are ``moment``, whose normal noise the port draws within ~1e-5 of
``jax.random.normal`` but not bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.serve import Request as JaxRequest
from repro.serve import ServeOptions as JaxOptions
from repro.serve import build_engine as jax_build
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams
from repro_torch.serve import Request, ServeOptions, build_engine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel worker processes; keep torch to one
    intra-op thread beside the JAX reference."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    return torch_smoke("qwen2-0.5b").replace(
        param_dtype=torch.float32, act_dtype=torch.float32, **kw
    )


@pytest.fixture(scope="module")
def params():
    gen = torch.Generator().manual_seed(0)
    return tparams.init_params(tlm.lm_param_specs(_cfg()), gen, "cpu")


def _spec_reqs():
    return [
        Request(rid=0, prompt=[5, 9, 17, 3], max_new_tokens=8),
        Request(rid=1, prompt=[40, 2, 8, 30, 7, 11], max_new_tokens=6),
    ]


def _engine(params, cfg, **kw):
    base = dict(paged=True, slots=2, max_len=64, block_size=4,
                prefill_chunk=3)
    return build_engine(params, cfg, ServeOptions(**{**base, **kw}),
                        device="cpu")


def _run(params, cfg, reqs, after_tick=None, **kw):
    eng = _engine(params, cfg, **kw)
    for r in reqs:
        eng.submit(r)
    ticks = 0
    while eng.scheduler.has_work():
        eng.step()
        eng.kv.check_invariants()
        if after_tick is not None:
            after_tick(eng)
        ticks += 1
        assert ticks < 500
    return eng, {r.rid: r.generated for r in eng.finished}


@pytest.mark.parametrize("k", [1, 2, 4])
def test_speculative_matches_plain_greedy(params, k):
    cfg = _cfg(sc_backend="moment", sc_nbit=512)
    _, ref = _run(params, cfg, _spec_reqs())
    eng, got = _run(params, cfg, _spec_reqs(), speculative=True, spec_k=k)
    assert got == ref
    drafted = eng.metrics.value("serve_spec_drafted_tokens_total")
    accepted = eng.metrics.value("serve_spec_accepted_tokens_total")
    assert drafted and drafted % k == 0
    assert 0 <= accepted <= drafted
    assert eng.metrics.value("serve_ticks_total", kind="spec") > 0


def test_speculative_fused_verify_matches_plain(params):
    cfg = _cfg(paged_attn="fused")
    _, ref = _run(params, cfg, _spec_reqs())
    eng, got = _run(params, cfg, _spec_reqs(), speculative=True, spec_k=3)
    assert got == ref
    assert eng.draft_cfg.paged_attn == "unfused"
    assert eng.metrics.value("serve_spec_drafted_tokens_total")


def test_speculative_disagreeing_draft_still_exact(params):
    cfg = _cfg(sc_backend="moment", sc_nbit=64)  # noisy verifier
    _, ref = _run(params, cfg, _spec_reqs())
    eng, got = _run(params, cfg, _spec_reqs(), speculative=True, spec_k=4,
                    draft_backend="exact")
    assert got == ref
    drafted = eng.metrics.value("serve_spec_drafted_tokens_total")
    accepted = eng.metrics.value("serve_spec_accepted_tokens_total")
    assert accepted < drafted, "exact drafts should miss a noisy verifier"


def test_speculative_mixed_batch_and_eviction(params):
    cfg = _cfg(sc_backend="moment", sc_nbit=512)
    mk = lambda: [  # noqa: E731
        Request(rid=0, prompt=[5, 9, 17, 3, 8, 2, 30, 11, 7, 6],
                max_new_tokens=16, temperature=0.0),
        Request(rid=1, prompt=[40, 2, 8, 30, 7, 11, 2, 4, 9, 9],
                max_new_tokens=16, temperature=0.6),
    ]
    roomy_e, roomy = _run(params, cfg, mk(), max_len=28, prefill_chunk=4)
    tight_e, tight = _run(params, cfg, mk(), max_len=28, prefill_chunk=4,
                          num_blocks=10, speculative=True, spec_k=2)
    assert roomy_e.evictions == 0
    assert tight_e.evictions > 0, "the pool was meant to force an eviction"
    assert tight == roomy
    assert tight_e.metrics.value("serve_spec_accepted_tokens_total")


def test_spec_counters_match_host_replay(params):
    cfg = _cfg(sc_backend="moment", sc_nbit=64)
    eng, got = _run(params, cfg, _spec_reqs(), speculative=True, spec_k=3,
                    draft_backend="exact")
    log = eng.spec_log
    assert log, "greedy requests must take speculative ticks"
    replay = []
    for e in log:
        a = 0
        while a < len(e["drafted"]) and e["drafted"][a] == e["verified"][a]:
            a += 1
        replay.append(a)
        assert e["accepted"] == a
        assert len(e["verified"]) == e["k"] + 1
        assert 1 <= e["committed"] <= a + 1
    assert eng.metrics.value("serve_spec_drafted_tokens_total") == \
        sum(e["k"] for e in log)
    assert eng.metrics.value("serve_spec_accepted_tokens_total") == \
        sum(replay)
    hist = eng.metrics.histogram("spec_accepted_tokens")
    assert hist.count() == len(log)
    assert hist.sum() == float(sum(replay))
    committed = sum(e["committed"] for e in log)
    assert committed <= sum(len(v) for v in got.values())


def test_speculative_config_validation(params):
    cfg = _cfg()
    with pytest.raises(ValueError, match="spec_k"):
        _engine(params, cfg, speculative=True, spec_k=0)
    with pytest.raises(ValueError, match="unknown SC backend"):
        _engine(params, cfg, speculative=True,
                draft_backend="no-such-backend")
    with pytest.raises(ValueError, match="rng_mode"):
        _engine(params, cfg, rng_mode="no-such-mode")


def test_draft_pairs_match_reference_registry():
    """Every backend drafts with the reference's pairing (``exact`` as
    itself, the rest with ``moment``; ``fast_backend`` upgrades do not
    change it), and a registered pair must name a known draft."""
    from repro import sc as jsc
    from repro_torch import sc as tsc

    for name in tsc.available_backends():
        assert tsc.draft_backend(name) == jsc.draft_backend(name), name
    assert tsc.draft_backend("pallas_bitexact") == "moment"
    with pytest.raises(ValueError, match="unknown SC backend"):
        tsc.register_draft_pair("moment", "no-such-backend")
    tsc.register_draft_pair("bitexact", "exact")
    try:
        assert tsc.draft_backend("bitexact") == "exact"
    finally:
        del tsc.registry._DRAFT_PAIRS["bitexact"]


# ---------------------------------------------------------------------------
# The pool after speculative ticks
# ---------------------------------------------------------------------------


def _live_kv(eng, seq):
    """(k, v) at positions [0, fed) of ``seq``, gathered through its
    block table: (layers, fed, kvh, hd) each."""
    bs = eng.scfg.block_size
    table = torch.tensor(eng.kv.tables[seq.req.rid], dtype=torch.int64)
    pos = torch.arange(seq.fed)
    blocks, offs = table[pos // bs], pos % bs
    return tuple(eng.pages[n][:, blocks, offs].clone() for n in ("k", "v"))


def _pool_reqs():
    return [
        Request(rid=0, prompt=[5, 9, 17, 3, 8], max_new_tokens=10),
        Request(rid=1, prompt=[40, 2, 8, 30, 7, 11, 4], max_new_tokens=9),
    ]


def test_spec_ticks_leave_the_plain_decode_pool(params):
    """exact verify, a noisy moment draft: every live position after
    every tick holds bit for bit the K/V plain decode ticks leave."""
    cfg = _cfg()
    plain: dict = {}

    def snap_plain(eng):
        for seq in eng.scheduler.rows:
            if seq is not None:
                plain[(seq.req.rid, seq.fed)] = _live_kv(eng, seq)

    _, ref = _run(params, cfg, _pool_reqs(), after_tick=snap_plain)
    seen = []

    def check_spec(eng):
        for seq in eng.scheduler.rows:
            if seq is None:
                continue
            want = plain[(seq.req.rid, seq.fed)]
            got = _live_kv(eng, seq)
            for w, g in zip(want, got):
                assert torch.equal(w, g), (seq.req.rid, seq.fed)
            seen.append(seq.fed)

    eng, got = _run(params, cfg.replace(sc_nbit=32), _pool_reqs(),
                    after_tick=check_spec, speculative=True, spec_k=3,
                    draft_backend="moment")
    assert got == ref
    log = eng.spec_log
    assert any(e["accepted"] < e["k"] for e in log), "no draft was rejected"
    assert any(e["accepted"] > 0 for e in log), "no draft was accepted"
    assert seen


def test_spec_draft_never_touches_a_shared_or_registered_block(params):
    """Prefix cache and speculation together: every block that is shared
    or hash-registered before a tick is bit for bit unchanged after it,
    and the tokens equal the cache-on plain run's."""
    cfg = _cfg(sc_backend="moment", sc_nbit=512)
    shared = [5, 9, 17, 3, 8, 2, 30, 11]
    mk = lambda: [  # noqa: E731
        Request(rid=i, prompt=shared + tail, max_new_tokens=8)
        for i, tail in enumerate(([20, 21], [22], [], [23]))
    ]
    _, ref = _run(params, cfg, mk(), prefix_cache=True)
    eng = _engine(params, cfg, prefix_cache=True, speculative=True,
                  spec_k=3)
    for r in mk():
        eng.submit(r)
    checked = 0
    while eng.scheduler.has_work():
        kv = eng.kv
        frozen = {b for b, n in kv.refcounts.items() if n > 1}
        frozen |= set(kv.block_hash)
        before = {b: (eng.pages["k"][:, b].clone(),
                      eng.pages["v"][:, b].clone()) for b in frozen}
        eng.step()
        for b, (k0, v0) in before.items():
            assert torch.equal(eng.pages["k"][:, b], k0), b
            assert torch.equal(eng.pages["v"][:, b], v0), b
            checked += 1
    got = {r.rid: r.generated for r in eng.finished}
    assert got == ref
    assert eng.metrics.value("serve_prefix_cache_hit_tokens_total") > 0
    assert eng.metrics.value("serve_spec_drafted_tokens_total") > 0
    assert checked


# ---------------------------------------------------------------------------
# Against the JAX engine
# ---------------------------------------------------------------------------

SC_DIMS = dict(d_model=32, d_ff=64, vocab=128, sc_backend="pallas_bitexact",
               sc_nbit=32, paged_attn="fused_sc")
SPEC_K = 2


def _drive(engine, request_cls):
    for r in _spec_reqs():
        engine.submit(request_cls(rid=r.rid, prompt=list(r.prompt),
                                  max_new_tokens=r.max_new_tokens))
    ticks = 0
    while engine.scheduler.has_work():
        engine.step()
        ticks += 1
        assert ticks < 200
    return {r.rid: list(r.generated) for r in engine.finished}


@pytest.fixture(scope="module")
def served_sc():
    """The JAX engine speculating (k = 2), and the port plain and
    speculating, on the same numpy weights."""
    jcfg = jax_smoke("qwen2-0.5b").replace(
        param_dtype=jnp.float32, act_dtype=jnp.float32, **SC_DIMS
    )
    tcfg = _cfg(**SC_DIMS)
    jp = jparams.init_params(
        jax.random.PRNGKey(0), jlm.lm_param_specs(jcfg), jnp.float32
    )
    tp = tparams.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    base = dict(paged=True, slots=2, max_len=32, block_size=4,
                prefill_chunk=3)
    spec = dict(speculative=True, spec_k=SPEC_K)
    jeng = jax_build(jp, jcfg, JaxOptions(**base, **spec))
    jtok = _drive(jeng, JaxRequest)
    plain = build_engine(tp, tcfg, ServeOptions(**base), device="cpu")
    teng = build_engine(tp, tcfg, ServeOptions(**base, **spec),
                        device="cpu")
    return jeng, jtok, _drive(plain, Request), teng, _drive(teng, Request)


def test_speculative_tokens_match_jax_engine(served_sc):
    jeng, jtok, plain, teng, ttok = served_sc
    assert sorted(ttok) == [0, 1]
    for rid in jtok:
        assert ttok[rid] == jtok[rid], f"rid {rid}"
        assert plain[rid] == jtok[rid], f"rid {rid} (plain)"
    assert teng.metrics.value("serve_ticks_total", kind="spec") > 0
    assert teng.draft_cfg.sc_backend == "moment"


def test_speculative_acceptance_matches_jax_statistically(served_sc):
    jeng, _, _, teng, _ = served_sc

    def rate(eng):
        drafted = eng.metrics.value("serve_spec_drafted_tokens_total")
        assert drafted > 0 and drafted % SPEC_K == 0
        return eng.metrics.value("serve_spec_accepted_tokens_total") / drafted

    assert abs(rate(teng) - rate(jeng)) <= 0.25
