"""PyTorch port vs JAX reference: the MoE family and the attention-stack
zoo configs.

At the SMOKE sizes of ``moonshot-v1-16b-a3b`` (8 experts, top-2) and
``llama4-maverick-400b-a17b`` (8 experts, top-1, a shared expert), on the
same numpy weights and inputs:

* ``moe.moe_ffn`` on ``exact`` within 1e-5 of max |ref| (the float32
  einsums and softmax round differently), including the reference's
  capacity-overflow case (``tests/test_model_zoo.py``);
* tied router logits pick ``jax.lax.top_k``'s experts (the lower index);
* ``layers.expert_dense`` on ``pallas_fused`` (one kernel-1 launch per
  expert, per-slot keys) bit-equal, and per-token keys following the
  dispatch (a token's output bit-equal solo and in a batch);
* ``lm.encode`` and ``lm_loss`` with gradients;
* the paged and the fixed-slot engines' greedy tokens equal to the JAX
  engines' on ``exact`` and ``pallas_bitexact``;
* batch-composition invariance on ``moment``
  (``tests/test_serve_zoo.py``), on the port;
* ``arch.workload.dense_workload``'s sites equal to the reference's;
* one ``decode_paged`` step for each of the four attention-stack dense /
  vlm configs (qwen3-14b, yi-6b, starcoder2-15b, chameleon-34b).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sc as jsc
from repro.arch import workload as jworkload
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import params as jparams
from repro.serve import Request as JaxRequest
from repro.serve import ServeOptions as JaxOptions
from repro.serve import build_engine as jax_build
from repro_torch.arch import workload as tworkload
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as torch_config
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models import params as tparams
from repro_torch.serve import PagedServeConfig, PagedServingEngine
from repro_torch.serve import Request as TorchRequest
from repro_torch.serve import ServeOptions as TorchOptions
from repro_torch.serve import build_engine as torch_build

MOE_ARCHS = ["moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b"]
ZOO_ARCHS = ["qwen3-14b", "yi-6b", "starcoder2-15b", "chameleon-34b"]
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


def _moe_params(jcfg, seed=0):
    p = jparams.init_params(jax.random.PRNGKey(seed), jmoe.moe_specs(jcfg),
                            jnp.float32)
    return p, tparams.params_from_numpy(jax.tree.map(np.asarray, p),
                                        device="cpu")


def _lm_params(jcfg, seed=0):
    p = jparams.init_params(jax.random.PRNGKey(seed), jlm.lm_param_specs(jcfg),
                            jnp.float32)
    return p, tparams.params_from_numpy(jax.tree.map(np.asarray, p),
                                        device="cpu")


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# moe_ffn and expert_dense
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_exact_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _moe_params(jcfg)
    x = _x((2, 5, jcfg.d_model))
    _close(tmoe.moe_ffn(torch.tensor(x), tp, tcfg),
           jmoe.moe_ffn(jnp.asarray(x), jp, jcfg))


def test_moe_capacity_overflow_matches_reference():
    """The reference's overflow case: late arrivals beyond an expert's
    capacity drop, and drops do occur."""
    kw = dict(n_experts=2, top_k=1, capacity_factor=0.25, shared_expert=False)
    jcfg, tcfg = _cfgs("moonshot-v1-16b-a3b", **kw)
    s = 32
    jp, tp = _moe_params(jcfg)
    x = _x((2, s, jcfg.d_model))
    cap = tmoe.capacity(tcfg, s)
    assert cap == jmoe.capacity(jcfg, s)
    eidx = torch.argmax(torch.tensor(x) @ tp["router"], -1)
    assert int(torch.bincount(eidx.reshape(-1)).max()) > cap
    _close(tmoe.moe_ffn(torch.tensor(x), tp, tcfg),
           jmoe.moe_ffn(jnp.asarray(x), jp, jcfg))


def test_tied_router_logits_pick_the_reference_experts():
    """Experts with identical router columns tie exactly: the port takes
    ``lax.top_k``'s lower indices, where ``torch.topk`` need not."""
    jcfg, tcfg = _cfgs("moonshot-v1-16b-a3b", top_k=3)
    jp, tp = _moe_params(jcfg)
    router = np.array(jp["router"])
    router[:, 1] = router[:, 6] = router[:, 3] = router[:, 0]
    router[:, 5] = router[:, 2]
    jp = {**jp, "router": jnp.asarray(router)}
    tp = {**tp, "router": torch.tensor(router)}
    x = _x((2, 6, jcfg.d_model))
    probs = torch.softmax(torch.tensor(x) @ tp["router"], -1)
    _, got = tmoe._top_k(probs, 3)
    _, want = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert got.tolist() == np.asarray(want).tolist()
    _close(tmoe.moe_ffn(torch.tensor(x), tp, tcfg),
           jmoe.moe_ffn(jnp.asarray(x), jp, jcfg))


@pytest.mark.parametrize("per_slot", [True, False])
def test_expert_dense_pallas_fused_bit_equal(per_slot):
    """Ragged expert shapes, one rows-mode call per expert: the same
    values as the reference, bit for bit, with per-slot keys or one raw
    key broadcast to every slot."""
    b, e, cap, d, f = 1, 3, 4, 24, 40
    jcfg, tcfg = _cfgs("qwen2-0.5b", sc_backend="pallas_fused", sc_nbit=64)
    x, w = _x((b, e, cap, d)), _x((e, d, f), seed=2)
    jkey = jax.random.fold_in(jax.random.PRNGKey(0), 2)
    if per_slot:
        jkey = jax.random.split(jkey, b * e * cap).reshape(b, e, cap, 2)
    tkey = torch.tensor(np.asarray(jkey).astype(np.int64)).to(torch.uint32)
    want = jlayers.expert_dense(jnp.asarray(x), jnp.asarray(w), jcfg, jkey,
                                site="moe_wi")
    got = tlayers.expert_dense(torch.tensor(x), torch.tensor(w), tcfg, tkey,
                               site="moe_wi")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_expert_dense_without_key_names_the_site():
    _, tcfg = _cfgs("qwen2-0.5b", sc_backend="moment", sc_nbit=64)
    xe = torch.ones((1, 2, 4, 4))
    we = torch.ones((2, 4, 3))
    with pytest.raises(ValueError, match="'moe_wi'"):
        tlayers.expert_dense(xe, we, tcfg, site="moe_wi")
    exact = tcfg.replace(sc_backend="exact")
    assert tlayers.expert_dense(xe, we, exact).shape == (1, 2, 4, 3)


def test_moe_per_token_keys_follow_dispatch():
    """(b, s, 2) per-token keys ride the token -> slot dispatch: the port
    equals the reference, and a token's output is bit-equal alone and
    beside another row."""
    jcfg, tcfg = _cfgs("moonshot-v1-16b-a3b", sc_backend="pallas_bitexact",
                       sc_nbit=32, d_model=32, d_ff=32)
    jp, tp = _moe_params(jcfg)
    s = 3
    xa, xb = _x((1, s, jcfg.d_model), 1), _x((1, s, jcfg.d_model), 2)
    ka = jax.random.split(jax.random.PRNGKey(3), s)[None]
    kb = jax.random.split(jax.random.PRNGKey(4), s)[None]

    def t(v):
        return torch.tensor(np.asarray(v).astype(np.int64)).to(torch.uint32)

    solo = tmoe.moe_ffn(torch.tensor(xa), tp, tcfg, t(ka))
    both = tmoe.moe_ffn(torch.tensor(np.concatenate([xa, xb])), tp, tcfg,
                        torch.cat([t(ka), t(kb)]))
    assert torch.equal(solo[0], both[0])
    want = jax.jit(jmoe.moe_ffn, static_argnums=2)(jnp.asarray(xa), jp,
                                                   jcfg, ka)
    _close(solo, want)


def test_load_balancing_loss_matches_reference():
    rng = np.random.default_rng(5)
    probs = rng.dirichlet(np.ones(8), (2, 5)).astype(np.float32)
    eidx = rng.integers(0, 8, (2, 5, 2)).astype(np.int32)
    want = jmoe.load_balancing_loss(jnp.asarray(probs), jnp.asarray(eidx), 8)
    got = tmoe.load_balancing_loss(torch.tensor(probs), torch.tensor(eidx), 8)
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


# ---------------------------------------------------------------------------
# The model: encode, loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_encode_loss_and_gradients_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _lm_params(jcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab, (2, 8)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, (2, 8)).astype(np.int32)
    _close(tlm.encode(tp, torch.tensor(toks), tcfg),
           jlm.encode(jp, jnp.asarray(toks), jcfg))
    jbatch = {"inputs": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jloss, jgrads = jax.value_and_grad(jlm.lm_loss)(jp, jbatch, jcfg)
    leaves = dict(tparams._leaves(tp))
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    tbatch = {"inputs": torch.tensor(toks), "labels": torch.tensor(labels)}
    tloss = tlm.lm_loss(tp, tbatch, tcfg)
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    jleaves = dict(tparams._leaves(jax.tree.map(np.asarray, jgrads)))
    assert set(jleaves) == set(leaves)
    # each leaf within 1e-4 of its own max |grad|, floored at 1e-3 of the
    # largest leaf's: llama4's top-1 router gradient is zero (its one
    # renormalized gate is 1) up to rounding noise on both sides
    top = max(float(np.abs(g).max()) for g in jleaves.values())
    for path, leaf in leaves.items():
        want = jleaves[path]
        scale = max(float(np.abs(want).max()), 1e-3 * top)
        err = float(np.abs(leaf.grad.numpy() - want).max())
        assert err <= 1e-4 * scale, path


# ---------------------------------------------------------------------------
# Serving: both engines against the JAX engines
# ---------------------------------------------------------------------------


def _serve(build, request_cls, params, cfg, specs, **kw):
    eng = build(params, cfg, kw.pop("options"), **kw)
    for s in specs:
        eng.submit(request_cls(**dict(s)))
    done = eng.run_until_drained()
    return {r.rid: list(r.generated) for r in done}


# one JAX engine on pallas_bitexact compiles its interpret-mode kernels
# for ~50 s, so llama4 (top-1 and the shared expert, a dense MLP) runs
# on exact only
_SERVE_CASES = [
    ("moonshot-v1-16b-a3b", "exact", True),
    ("moonshot-v1-16b-a3b", "exact", False),
    ("moonshot-v1-16b-a3b", "pallas_bitexact", True),
    ("moonshot-v1-16b-a3b", "pallas_bitexact", False),
    ("llama4-maverick-400b-a17b", "exact", True),
    ("llama4-maverick-400b-a17b", "exact", False),
]


@pytest.mark.parametrize("arch, backend, paged", _SERVE_CASES)
def test_engine_greedy_tokens_match_reference(arch, backend, paged):
    """``build_engine`` on both sides, the same greedy workload: equal
    tokens request for request.  Prompts share one length on
    ``pallas_bitexact`` so the fixed-slot JAX engine compiles one
    prefill."""
    dims = dict(d_model=32, d_ff=48, vocab=128, sc_backend=backend,
                sc_nbit=32)
    jcfg, tcfg = _cfgs(arch, **dims)
    jp, tp = _lm_params(jcfg)
    rng = np.random.default_rng(1)
    plens = (6, 6, 6) if backend != "exact" else (4, 9, 6)
    specs = [dict(rid=i, prompt=rng.integers(3, 128, n).tolist(),
                  max_new_tokens=3 + i % 2) for i, n in enumerate(plens)]
    opts = dict(slots=2, max_len=24)
    if paged:
        opts.update(paged=True, block_size=4, prefill_chunk=4)
    jtok = _serve(jax_build, JaxRequest, jp, jcfg, specs,
                  options=JaxOptions(**opts))
    ttok = _serve(torch_build, TorchRequest, tp, tcfg, specs,
                  options=TorchOptions(**opts), device="cpu")
    assert sorted(ttok) == list(range(len(plens)))
    assert ttok == jtok


def _run_paged(params, cfg, reqs, *, slots, submit_after=None):
    eng = PagedServingEngine(
        params, cfg,
        PagedServeConfig(slots=slots, max_len=48, block_size=4,
                         prefill_chunk=3, seed=7),
        device="cpu",
    )
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
    return {r.rid: r.generated for r in eng.finished}


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_batch_composition_invariance_on_moment(arch):
    """Tokens are a function of (request key, position) alone: solo,
    batched and admitted mid-stream agree, sampled requests included."""
    _, tcfg = _cfgs(arch, sc_backend="moment", sc_nbit=256)
    gen = torch.Generator().manual_seed(0)
    params = tparams.init_params(tlm.lm_param_specs(tcfg), gen, "cpu")
    r0 = dict(rid=0, prompt=[5, 9, 17, 3], max_new_tokens=6, temperature=0.8)
    r1 = dict(rid=1, prompt=[40, 2, 8, 30, 7, 11, 2, 4], max_new_tokens=6,
              temperature=0.3)
    solo = _run_paged(params, tcfg, [TorchRequest(**r0)], slots=1)
    full = _run_paged(params, tcfg, [TorchRequest(**r0), TorchRequest(**r1)],
                      slots=2)
    mid = _run_paged(params, tcfg, [TorchRequest(**r1)], slots=2,
                     submit_after={3: TorchRequest(**r0)})
    assert solo[0] == full[0] == mid[0]


# ---------------------------------------------------------------------------
# Configs, workload sites, and the attention-stack zoo configs
# ---------------------------------------------------------------------------


_DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_matches_reference(arch):
    for get in ((jax_config, torch_config), (jax_smoke, torch_smoke)):
        jcfg, tcfg = get[0](arch), get[1](arch)
        for f in dataclasses.fields(tcfg):
            want = getattr(jcfg, f.name)
            want = _DTYPES.get(want, want)
            assert getattr(tcfg, f.name) == want, (arch, f.name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dense_workload_sites_match_reference(arch):
    jsites = jworkload.dense_workload(jax_config(arch), 7)
    tsites = tworkload.dense_workload(torch_config(arch), 7)
    assert [dataclasses.astuple(s) for s in tsites] == \
        [dataclasses.astuple(s) for s in jsites]


@pytest.mark.parametrize("arch", ZOO_ARCHS)
def test_decode_paged_matches_reference(arch):
    """A 3-token prefill chunk then a decode step through the paged cache
    (exact, unfused attention): logits and every page within 1e-5."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _lm_params(jcfg)
    nb, bs = 6, 4
    jpages = jlm.init_paged_cache(jcfg, nb, bs)
    tpages = tlm.init_paged_cache(tcfg, nb, bs, device="cpu")
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
        for name in ("k", "v"):
            _close(tpages[name], jpages[name])


def test_sc_fused_is_the_expert_backend():
    """``pallas_bitexact`` experts run the fused engine (kernel 1), as in
    the reference (``sc.fast_backend``)."""
    from repro_torch import sc as tsc

    assert tsc.fast_backend("pallas_bitexact", 1024) == \
        jsc.fast_backend("pallas_bitexact", 1024) == "pallas_fused"


@pytest.mark.parametrize("b,s,k,cap", [(2, 16, 2, 8), (3, 64, 6, 16)])
def test_dispatch_gradient_sums_a_tokens_slots_in_slot_order(b, s, k, cap):
    """``moe._take_rows``' backward (gathers, the same bits on the card
    from run to run) is ``torch.gather``'s scatter-add backward bit for
    bit: each token's slot gradients added in slot order."""
    rng = np.random.default_rng(s)
    e, d = 8, 5
    # every token in k distinct experts' slots, some dropped at capacity
    eidx = np.stack([rng.permutation(e)[:k] for _ in range(b * s)])
    slot = np.full((b, e * cap), -1)
    for r in range(b):
        fill = np.zeros(e, int)
        for t in range(s):
            for x in eidx[r * s + t]:
                if fill[x] < cap:
                    slot[r, x * cap + fill[x]] = t
                    fill[x] += 1
    src = torch.tensor(slot)
    x = torch.tensor(rng.standard_normal((b, s, d)), dtype=torch.float32)
    g = torch.tensor(rng.standard_normal((b, e * cap, d)),
                     dtype=torch.float32)
    xa = x.clone().requires_grad_(True)
    (tmoe._take_rows(xa, src, k) * g).sum().backward()
    xb = x.clone().requires_grad_(True)
    idx = src.clamp_min(0)[..., None].expand(b, e * cap, d)
    rows = torch.where((src >= 0)[..., None], torch.gather(xb, 1, idx),
                       torch.zeros(()))
    (rows * g).sum().backward()
    assert torch.equal(tmoe._take_rows(x, src, k), rows.detach())
    assert torch.equal(xa.grad, xb.grad)
