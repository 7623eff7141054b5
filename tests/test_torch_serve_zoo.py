"""PyTorch port vs JAX reference: the SSM (mamba2-370m) and hybrid
(zamba2-7b) families through both serving engines — the reference's
``tests/test_serve_zoo.py`` held across the two packages.

At the two SMOKE configs, float32, on the same numpy weights:

* ``CachePlan`` and the ``init_paged_cache`` / ``init_cache`` leaves
  equal to the reference's; ``lm.encode`` / ``prefill`` /
  ``decode_step`` / ``decode_paged`` on ``exact`` within 1e-5 (caches
  included), and the whole model on ``moment`` with the 10-bit operand
  grid off (1e-4) and on (1e-2: an ulp of float math can move an
  operand across a grid step);
* the paged and the fixed-slot engines' greedy tokens equal to the JAX
  engines', request for request, on ``exact`` and ``pallas_bitexact``
  (nbit 256; zamba2-7b at one group of the SMOKE config), and paged
  tokens equal to fixed-slot tokens;
* on ``moment`` (the port alone: sampled rows draw Gumbel-max, the
  reference ``jax.random.categorical``) chunk-width invariance, state
  reset on slot reuse (and ``_reset_fresh_state`` against the
  reference's), eviction-resume tokens and batch-composition invariance;
* ``prefix_cache`` / ``speculative`` raise ``ValueError`` as in the
  reference; ``drain`` is cold and ``restore`` gives an unfaulted run's
  tokens;
* ``dense_workload`` sites and their array pricing equal the
  reference's; ``launch/serve.py --smoke --arch mamba2-370m`` gives the
  reference engine's tokens on the launcher's weights and the reference
  launcher's prompts;
* ``lm_loss`` and the trainer run both families (their parity with the
  reference is ``tests/test_torch_train_ssm.py``'s), and under
  ``frontend="embeddings"`` the specs gain the reference's frontend
  projection and token prompts still serve.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import arch as jarch
from repro.arch import workload as jworkload
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.configs import supported_shapes as jax_supported_shapes
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.sc import encoding as jenc
from repro.serve import Request as JaxRequest
from repro.serve import ServeOptions as JaxOptions
from repro.serve import build_engine as jax_build
from repro.serve.kv_cache import CachePlan as JaxCachePlan
from repro_torch import arch as tarch
from repro_torch.configs import ARCH_IDS, supported_shapes
from repro_torch.configs import get_config as torch_config
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.launch import serve as serve_launch
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams
from repro_torch.sc import encoding as tenc
from repro_torch.serve import Request as TorchRequest
from repro_torch.serve import ServeOptions as TorchOptions
from repro_torch.serve import build_engine as torch_build
from repro_torch.serve.kv_cache import CachePlan
from repro_torch.train import TrainConfig, make_train_step, train_state_init
from test_torch_launch_serve import _jax_prompts

ARCHS = ["mamba2-370m", "zamba2-7b"]
JF32 = dict(param_dtype=jnp.float32, act_dtype=jnp.float32)
TF32 = dict(param_dtype=torch.float32, act_dtype=torch.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    return (jax_smoke(arch).replace(**JF32, **kw),
            torch_smoke(arch).replace(**TF32, **kw))


def _params(jcfg, seed=0):
    """The reference's weights, with every SSM layer's A_log, D and
    dt_bias drawn at random (their inits are constants)."""
    p = jparams.init_params(jax.random.PRNGKey(seed),
                            jlm.lm_param_specs(jcfg), jnp.float32)
    p = jax.tree.map(np.asarray, p)
    rng = np.random.default_rng(seed + 10)
    s = p["blocks"]["ssm"]
    s["A_log"] = rng.uniform(-1.0, 1.0, s["A_log"].shape).astype(np.float32)
    s["D"] = rng.uniform(0.5, 1.5, s["D"].shape).astype(np.float32)
    s["dt_bias"] = rng.uniform(-2.0, 0.5, s["dt_bias"].shape).astype(
        np.float32)
    return (jax.tree.map(jnp.asarray, p),
            tparams.params_from_numpy(p, device="cpu"))


def _port_params(tcfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return tparams.init_params(tlm.lm_param_specs(tcfg), gen, "cpu")


def _close(got, want, tol=1e-5):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _close_tree(got, want, tol=1e-5):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close_tree(got[k], want[k], tol)
        return
    _close(got, want, tol)


def _toks(rng, vocab, lens):
    return [rng.integers(3, vocab, n).tolist() for n in lens]


# ---------------------------------------------------------------------------
# Cache plan and cache layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "arch", ["qwen2-0.5b", "moonshot-v1-16b-a3b"] + ARCHS)
def test_cache_plan_and_paged_cache_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jplan, tplan = JaxCachePlan.for_config(jcfg), CachePlan.for_config(tcfg)
    assert dataclasses.astuple(tplan) == dataclasses.astuple(jplan)
    assert (tplan.has_paged, tplan.has_state) == (jplan.has_paged,
                                                  jplan.has_state)
    kw = dict(slots=2) if tplan.has_state else {}
    want = jax.tree.map(np.shape, jlm.init_paged_cache(jcfg, 8, 4, **kw))
    got = tlm.init_paged_cache(tcfg, 8, 4, device="cpu", **kw)
    assert jax.tree.map(lambda t: tuple(t.shape), got) == want
    if arch in ARCHS:
        assert tplan.has_state
        assert tplan.has_paged == (arch == "zamba2-7b")
        assert got["ssm"]["state"].dtype == torch.float32
        with pytest.raises(ValueError, match="slots="):
            tlm.init_paged_cache(tcfg, 8, 4, device="cpu")
    want = jax.tree.map(np.shape, jlm.init_cache(jcfg, 3, 16))
    got = tlm.init_cache(tcfg, 3, 16, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), got) == want


# ---------------------------------------------------------------------------
# The model on exact and moment
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_encode_prefill_and_decode_step_match_reference(arch):
    """``encode``, a 13-token ``prefill`` (two SSD chunks, the second
    short) and two ``decode_step``s on ``exact``: hidden states, logits
    and every cache leaf within 1e-5."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (2, 13)).astype(np.int32)
    _close(tlm.encode(tp, torch.tensor(toks), tcfg),
           jlm.encode(jp, jnp.asarray(toks), jcfg))
    jl, jc, jlen = jlm.prefill(jp, jnp.asarray(toks), jcfg, 24)
    tl, tc, tlen = tlm.prefill(tp, torch.tensor(toks), tcfg, 24)
    _close(tl, jl)
    _close_tree(tc, jc)
    assert tlen.tolist() == np.asarray(jlen).tolist()
    for step in range(2):
        nxt = rng.integers(0, jcfg.vocab, 2).astype(np.int32)
        jl, jc = jlm.decode_step(jp, jc, jnp.asarray(nxt), jlen + step, jcfg)
        tl, tc = tlm.decode_step(tp, tc, torch.tensor(nxt), tlen + step,
                                 tcfg)
        _close(tl, jl)
        _close_tree(tc, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_paged_matches_reference(arch):
    """A 3-token prefill chunk (the second row fed 2), then a decode step
    on ``exact``: logits and every page / state row within 1e-5."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    nb, bs = 6, 4
    jpages = jlm.init_paged_cache(jcfg, nb, bs, slots=2)
    tpages = tlm.init_paged_cache(tcfg, nb, bs, slots=2, device="cpu")
    table = np.array([[1, 2], [3, 4]], np.int32)
    steps = [
        (np.array([[5, 9, 17], [40, 2, 0]]), np.array([0, 0]),
         np.array([3, 2])),
        (np.array([[11], [6]]), np.array([3, 2]), np.array([1, 1])),
    ]
    for toks, lengths, n_valid in steps:
        args = [toks.astype(np.int32), lengths.astype(np.int32),
                n_valid.astype(np.int32)]
        jl, jpages = jlm.decode_paged(jp, jpages, jnp.asarray(table),
                                      *map(jnp.asarray, args), jcfg)
        tl, tpages = tlm.decode_paged(tp, tpages, torch.tensor(table),
                                      *map(torch.tensor, args), tcfg)
        _close(tl, jl)
        _close_tree(tpages, jpages)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("grid", [False, True])
def test_forward_on_moment_matches_reference(arch, grid, monkeypatch):
    """The whole model's logits on ``moment`` under one raw key: 1e-4 of
    max |ref| with the operand grid off in both packages, 1e-2 with it
    on (``tests/test_torch_train.py``'s two tolerances)."""
    if not grid:
        monkeypatch.setattr(jenc, "quantize_grid", lambda p, levels: p)
        monkeypatch.setattr(tenc, "quantize_grid", lambda p, levels: p)
    jcfg, tcfg = _cfgs(arch, sc_backend="moment", sc_nbit=256)
    jp, tp = _params(jcfg)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 11))
    key = jax.random.PRNGKey(5)
    want = jlm.forward(jp, jnp.asarray(toks, jnp.int32), jcfg, rng=key)
    tkey = torch.tensor(np.asarray(key).astype(np.int64)).to(torch.uint32)
    got = tlm.forward(tp, torch.tensor(toks), tcfg, rng=tkey)
    _close(got, want, 1e-2 if grid else 1e-4)


# ---------------------------------------------------------------------------
# Both engines against the JAX engines
# ---------------------------------------------------------------------------


def _serve(build, request_cls, params, cfg, specs, **kw):
    eng = build(params, cfg, kw.pop("options"), **kw)
    for s in specs:
        eng.submit(request_cls(**dict(s)))
    done = eng.run_until_drained()
    return {r.rid: list(r.generated) for r in done}


# pallas_bitexact at d_model 32 (the port's plain int64 Threefry is most
# of its time); zamba2-7b's bit-exact cases, whose JAX engines take ~1-2
# minutes each to compile their interpret-mode kernels, are
# test_hybrid_engine_greedy_tokens_match_reference_on_bitexact below
_ENGINE_CASES = [
    (arch, "exact", paged) for arch in ARCHS for paged in (True, False)
] + [("mamba2-370m", "pallas_bitexact", paged) for paged in (True, False)]


@pytest.mark.parametrize("arch, backend, paged", _ENGINE_CASES)
def test_engine_greedy_tokens_match_reference(arch, backend, paged):
    """``build_engine`` on both sides, the same greedy workload: equal
    tokens request for request.  Prompts share one length on
    ``pallas_bitexact`` so the fixed-slot JAX engine compiles one
    prefill."""
    assert_engines_match(arch, backend, paged)


@pytest.mark.parametrize("paged", [True, False])
def test_hybrid_engine_greedy_tokens_match_reference_on_bitexact(paged):
    """zamba2-7b on ``pallas_bitexact`` — kernel 1 for every SSM
    projection, the shared block and the unembed, with per-token keys on
    the paged engine and one key a call on the fixed-slot engine: one
    group of the SMOKE config (two SSM layers and one shared invocation)
    at d_model 32, nbit 256.  The paged engine feeds one token a tick,
    so its JAX twin compiles one step width.  These are the file's
    longest cases; they stay in this file of many tests because
    ``--dist loadfile`` hands out files with the most tests first, so a
    file of two long tests would start last and end the run late."""
    assert_engines_match("zamba2-7b", "pallas_bitexact", paged,
                         prefill_chunk=1, n_layers=3)


def assert_engines_match(arch, backend, paged, prefill_chunk=4, **dims):
    if backend != "exact":
        dims = dict(d_model=32, vocab=128, **dims)
    jcfg, tcfg = _cfgs(arch, sc_backend=backend, sc_nbit=256, **dims)
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(1)
    plens = (6, 6, 6) if backend != "exact" else (4, 11, 6)
    specs = [dict(rid=i, prompt=p, max_new_tokens=3 + i % 2)
             for i, p in enumerate(_toks(rng, jcfg.vocab, plens))]
    opts = dict(slots=2, max_len=24)
    if paged:
        opts.update(paged=True, block_size=4, prefill_chunk=prefill_chunk)
    jtok = _serve(jax_build, JaxRequest, jp, jcfg, specs,
                  options=JaxOptions(**opts))
    ttok = _serve(torch_build, TorchRequest, tp, tcfg, specs,
                  options=TorchOptions(**opts), device="cpu")
    assert sorted(ttok) == list(range(len(plens)))
    assert ttok == jtok


def test_short_prompt_conv_tail_splices_as_the_reference():
    """A prompt shorter than the conv tail (``ssm_conv - 1`` = 3): the
    reference's prefill keeps only its own rows, and the fixed-slot
    engine's splice writes them at the front of the slot's tail, leaving
    the rest as the slot held it (ROADMAP queue 3, a reference caveat).
    The port splices the same way, so the tokens stay the reference's,
    a request of a long prompt having held the slot before."""
    jcfg, tcfg = _cfgs("mamba2-370m")
    jp, tp = _params(jcfg)
    specs = [dict(rid=0, prompt=[7, 40, 9, 21, 3, 11], max_new_tokens=2),
             dict(rid=1, prompt=[5, 9], max_new_tokens=4),
             dict(rid=2, prompt=[30], max_new_tokens=3)]
    opts = dict(slots=1, max_len=24)
    jtok = _serve(jax_build, JaxRequest, jp, jcfg, specs,
                  options=JaxOptions(**opts))
    ttok = _serve(torch_build, TorchRequest, tp, tcfg, specs,
                  options=TorchOptions(**opts), device="cpu")
    assert ttok == jtok


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_matches_fixed_slot_greedy(arch):
    _, tcfg = _cfgs(arch)
    tp = _port_params(tcfg)
    prompts = {0: [5, 9, 17, 3], 1: [40, 2, 8, 30, 7]}
    specs = [dict(rid=r, prompt=p, max_new_tokens=5)
             for r, p in prompts.items()]
    fixed = _serve(torch_build, TorchRequest, tp, tcfg, specs,
                   options=TorchOptions(slots=2, max_len=48), device="cpu")
    paged = _serve(torch_build, TorchRequest, tp, tcfg, specs,
                   options=TorchOptions(paged=True, slots=2, max_len=48,
                                        block_size=4, prefill_chunk=3),
                   device="cpu")
    assert paged == fixed


# ---------------------------------------------------------------------------
# Per-request rng invariants on a stochastic substrate (the port alone)
# ---------------------------------------------------------------------------


def _run_paged(params, cfg, reqs, *, slots=2, seed=7, num_blocks=0,
               submit_after=None, **kw):
    defaults = dict(slots=slots, max_len=48, block_size=4, prefill_chunk=3,
                    seed=seed, num_blocks=num_blocks)
    defaults.update(kw)
    opts = TorchOptions(paged=True, **defaults)
    eng = torch_build(params, cfg, opts, device="cpu")
    late = dict(submit_after or {})
    for r in reqs:
        eng.submit(r)
    ticks = 0
    while eng.scheduler.has_work() or late:
        for t in [t for t in sorted(late) if ticks >= t]:
            eng.submit(late.pop(t))
        eng.step()
        ticks += 1
        assert ticks < 500
    return eng, {r.rid: r.generated for r in eng.finished}


REQ0 = dict(rid=0, prompt=[5, 9, 17, 3], max_new_tokens=6, temperature=0.8)
REQ1 = dict(rid=1, prompt=[40, 2, 8, 30, 7, 11, 2, 4], max_new_tokens=6,
            temperature=0.3)


def _moment(arch):
    _, tcfg = _cfgs(arch, sc_backend="moment", sc_nbit=256)
    return tcfg, _port_params(tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_composition_invariance_stochastic(arch):
    """Tokens are a function of (request key, position) alone: solo,
    batched and admitted mid-stream agree, sampled rows included."""
    cfg, params = _moment(arch)
    _, solo = _run_paged(params, cfg, [TorchRequest(**REQ0)], slots=1)
    _, full = _run_paged(params, cfg,
                         [TorchRequest(**REQ0), TorchRequest(**REQ1)])
    _, mid = _run_paged(params, cfg, [TorchRequest(**REQ1)],
                        submit_after={3: TorchRequest(**REQ0)})
    assert solo[0] == full[0] == mid[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_eviction_resume_reproduces_tokens(arch):
    """A tight pool forces an eviction mid-decode; the resumed request
    re-feeds its context from position 0 (its state zeroed) and emits
    the roomy pool's tokens."""
    cfg, params = _moment(arch)

    def mk():
        return [
            TorchRequest(rid=0, prompt=[5, 9, 17, 3, 8, 2, 30, 11, 7, 6],
                         max_new_tokens=16, temperature=0.6),
            TorchRequest(rid=1, prompt=[40, 2, 8, 30, 7, 11, 2, 4, 9, 9],
                         max_new_tokens=16, temperature=0.6),
        ]

    roomy_e, roomy = _run_paged(params, cfg, mk(), prefill_chunk=4)
    tight_e, tight = _run_paged(params, cfg, mk(), prefill_chunk=4,
                                num_blocks=13)
    assert tight_e.evictions > 0, "pool was meant to force an eviction"
    assert roomy_e.evictions == 0
    assert roomy == tight


@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_width_invariance(arch):
    """The recurrent paged feed makes a row's tokens independent of the
    prefill chunking."""
    cfg, params = _moment(arch)
    req = dict(rid=0, prompt=[5, 9, 17, 3, 8, 2, 30, 11], max_new_tokens=6,
               temperature=0.7)
    outs = [_run_paged(params, cfg, [TorchRequest(**req)], slots=1,
                       prefill_chunk=c)[1] for c in (2, 3, 8)]
    assert outs[0] == outs[1] == outs[2]


def test_state_resets_on_slot_reuse():
    """Serving B after A in one slot equals serving B alone."""
    cfg, params = _moment("mamba2-370m")
    a = dict(rid=0, prompt=[5, 9, 17], max_new_tokens=3)
    b = dict(rid=1, prompt=[40, 2, 8, 30], max_new_tokens=5,
             temperature=0.5)
    _, alone = _run_paged(params, cfg, [TorchRequest(**b)], slots=1)
    _, after = _run_paged(params, cfg, [TorchRequest(**a)], slots=1,
                          submit_after={1: TorchRequest(**b)})
    assert after[1] == alone[1]


def test_reset_fresh_state_zeroes_exactly_the_fresh_rows():
    """The rows at ``lengths == 0`` (a fresh admission or an eviction
    resume) of every leaf are zeroed in place, the others kept — the
    reference's ``_reset_fresh_state`` on the same stale state."""
    jcfg, tcfg = _cfgs("zamba2-7b")
    rng = np.random.default_rng(3)
    stale = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in jlm.init_paged_cache(jcfg, 4, 4, slots=3)[
                 "ssm"].items()}
    lengths = np.array([5, 0, 2], np.int32)
    want = jlm._reset_fresh_state(jax.tree.map(jnp.asarray, stale),
                                  jnp.asarray(lengths))
    got = {k: torch.tensor(v) for k, v in stale.items()}
    tlm._reset_fresh_state(got, torch.tensor(lengths))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert not got[k][:, 1].any() and got[k][:, 0].any()


# ---------------------------------------------------------------------------
# Refused features, drain / restore
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("feature", ["prefix_cache", "speculative"])
def test_state_families_refuse_prefix_cache_and_speculation(arch, feature):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    with pytest.raises(ValueError, match=feature) as jerr:
        jax_build(jp, jcfg, JaxOptions(paged=True, **{feature: True}))
    with pytest.raises(ValueError, match=feature) as terr:
        torch_build(tp, tcfg, TorchOptions(paged=True, **{feature: True}),
                    device="cpu")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("arch", ARCHS)
def test_drain_is_cold_and_restore_gives_unfaulted_tokens(arch):
    """Drain after three ticks (one row mid-prefill, one decoding):
    every checkpoint has no K/V payload, and restoring them on a fresh
    engine recomputes from tokens to an unfaulted engine's tokens."""
    cfg, params = _moment(arch)

    def mk():
        return [TorchRequest(rid=0, prompt=[5, 9, 17, 3, 8, 2, 30, 11],
                             max_new_tokens=5, temperature=0.6),
                TorchRequest(rid=1, prompt=[40, 2, 8], max_new_tokens=5)]

    _, want = _run_paged(params, cfg, mk())
    opts = TorchOptions(paged=True, slots=2, max_len=48, block_size=4,
                        prefill_chunk=3, seed=7)
    eng = torch_build(params, cfg, opts, device="cpu")
    for r in mk():
        eng.submit(r)
    for _ in range(3):
        eng.step()
    ckpts = eng.drain()
    assert len(ckpts) == 2 and any(c["fed"] for c in ckpts)
    assert all(c["kv"] is None for c in ckpts)
    assert not eng.scheduler.has_work()
    fresh = torch_build(params, cfg, opts, device="cpu")
    assert [fresh.restore(c) for c in ckpts] == [False, False]
    got = {r.rid: r.generated for r in fresh.run_until_drained()}
    assert got == want


# ---------------------------------------------------------------------------
# Workload sites, the launcher, what still raises
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_workload_sites_and_pricing_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    for tokens in (1, 16):
        js = jworkload.dense_workload(jcfg, tokens)
        ts = tarch.dense_workload(tcfg, tokens)
        assert [dataclasses.astuple(s) for s in ts] == [
            dataclasses.astuple(s) for s in js]
        _, jtot = jworkload.price_workload(js, 256)
        _, ttot = tarch.price_workload(ts, 256)
        assert tarch.report_dict(ttot) == jarch.report_dict(jtot)
    labels = [s.label for s in ts]
    assert labels[:6] == ["ssm.wz", "ssm.wx", "ssm.wB", "ssm.wC", "ssm.wdt",
                          "ssm.out"]
    assert any(lbl.startswith("shared.") for lbl in labels) == (
        arch == "zamba2-7b")


def test_serve_launcher_gives_the_reference_engines_tokens():
    """``launch/serve.py --smoke --arch mamba2-370m`` (fixed-slot, exact,
    float32, the port's weights from ``--seed``) against the reference
    engine on the same weights and the reference launcher's prompts."""
    args = ["--arch", "mamba2-370m", "--smoke", "--device", "cpu",
            "--requests", "3", "--slots", "2", "--max-len", "48",
            "--max-new", "4", "--seed", "2"]
    finished = serve_launch.main(args)
    got = {r.rid: list(r.generated) for r in finished}
    tcfg = torch_smoke("mamba2-370m").replace(**TF32)
    tp = tparams.init_params(tlm.lm_param_specs(tcfg),
                             torch.Generator().manual_seed(2), "cpu")
    jp = jax.tree.map(jnp.asarray,
                      tparams.tree_map(lambda t: t.numpy(), tp))
    jcfg = jax_smoke("mamba2-370m").replace(**JF32)
    prompts = _jax_prompts(2, 3, jcfg.vocab, 0)
    specs = [dict(rid=i, prompt=p, max_new_tokens=4)
             for i, p in enumerate(prompts)]
    want = _serve(jax_build, JaxRequest, jp, jcfg, specs,
                  options=JaxOptions(slots=2, max_len=48, seed=2))
    assert [r.prompt for r in sorted(finished, key=lambda r: r.rid)] == \
        prompts
    assert got == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_supported_shapes_match_reference(arch):
    assert supported_shapes(torch_config(arch)) == \
        jax_supported_shapes(jax_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_family_trains_and_takes_the_embeddings_frontend(arch):
    """Both families train: ``lm_loss`` back-propagates to every leaf
    and ``make_train_step`` takes a finite step from
    ``train_state_init``.  Under ``frontend="embeddings"`` the specs
    equal the reference's (the frontend's (d, d) projection added), and
    the paged cache and the engine build for token prompts."""
    jcfg, tcfg = _cfgs(arch)
    tp = _port_params(tcfg)
    toks = torch.arange(8, dtype=torch.int32).reshape(1, 8) + 3
    batch = {"inputs": toks, "labels": toks.roll(-1, 1)}
    tracked = tparams.tree_map(lambda t: t.requires_grad_(True), tp)
    loss = tlm.lm_loss(tracked, batch, tcfg)
    loss.backward()
    assert torch.isfinite(loss)
    assert all(t.grad is not None for t in tparams.tree_leaves(tracked))
    state = train_state_init(0, tcfg, TrainConfig(), device="cpu")
    _, metrics = make_train_step(tcfg, TrainConfig())(state, batch)
    assert torch.isfinite(metrics["loss"])
    jemb, temb = (c.replace(frontend="embeddings") for c in (jcfg, tcfg))
    want = jax.tree.map(lambda s: (s.shape, s.axes, s.init),
                        jlm.lm_param_specs(jemb),
                        is_leaf=lambda s: hasattr(s, "axes"))
    got = tparams.tree_map_specs(lambda s: (s.shape, s.axes, s.init),
                                 tlm.lm_param_specs(temb))
    assert got == want and "frontend" in got
    ep = _port_params(temb)
    torch_build(ep, temb, TorchOptions(paged=True), device="cpu")
    tlm.init_paged_cache(temb, 4, 4, slots=1, device="cpu")
