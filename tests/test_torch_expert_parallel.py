"""PyTorch port vs JAX reference: the expert-parallel layout of the MoE
FFN (``sharding/ep.py``): a rank's block of the experts over ``model``
in the mesh step, prefill and decode, with each rank gathering only its
experts' block of the expert weights under FSDP.

The reference runs in a subprocess on 4 host devices with an Auto-axes
mesh; the port as 4 gloo ranks of the CPU under ``torchrun``; both sides
live in ``tests/_torch_expert_parallel_ranks.py`` and start together.
Held, for moonshot-v1-16b-a3b's smoke config (8 experts, top-2) and
llama4-maverick's (8 experts, top-1, a shared expert) on data 2 x
model 2:

* (a) the mesh train step with the layout against the same step with it
  off (``make_constrain(..., tensor_parallel=False)``), under
  ``remat="full"``, on ``exact`` and ``pallas_moment``, replicated and
  FSDP, 2 AdamW steps: both losses within 1e-6 (relative) and every
  step-1 gradient leaf within 1e-5 of its max |g|, on every rank; in the
  replicated layout the ranks hold the same parameters bit for bit
  after step 1;
* (b) the ``pallas_moment`` encoder output under the layout bit-equal to
  the whole layout's: a rank's experts draw the whole layout's bits
  (keys folded with the global expert index);
* (c) the ``exact`` losses within 1e-6 (relative) of the reference's
  mesh step;
* (d) ``pallas_bitexact`` (the ``pallas_fused`` twin on the CPU; one
  layer at nbit 32) prefill logits bit-equal to the whole layout's, and
  the same greedy ``decode_step`` tokens and logits;
* (e) in process, on a ``RecordingMesh``: ``tp_collective_plan``'s
  ``ep.*`` and ``tp.*`` entries and ``fsdp.collective_plan`` equal to
  the collectives a step records; no op of an FSDP step makes a whole
  expert leaf or a whole expert gradient; an expert count the span does
  not divide stays whole; one rank's expert outputs equal the whole
  layout's for the same global experts; the weights' and activations'
  expert layouts cannot disagree.
"""

import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import lm as jlm
from repro.models import params as jparams
from repro_torch.launch import cost_analysis as C
from repro_torch.launch.mesh import RecordingMesh
from repro_torch.models import layers
from repro_torch.models import lm as tlm
from repro_torch.models.params import init_params, params_from_numpy
from repro_torch.optim import adamw_init
from repro_torch.sc import ctr_rng
from repro_torch.sharding import ep, fsdp, param_shardings, rules, tp
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train.step import make_constrain, make_param_constrain

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
HELPER = os.path.join(HERE, "_torch_expert_parallel_ranks.py")
sys.path.insert(0, HERE)
import _torch_expert_parallel_ranks as ranks  # noqa: E402
from _torch_train_mesh_ranks import _flat  # noqa: E402

RANKS = 4
TIMEOUT = 300  # seconds a side may take
LOSS_TOL = 1e-6  # relative
GRAD_TOL = 1e-5  # of the leaf's max |g|


def _weights(name):
    cfg = ranks.jax_cfg(name)
    params = jparams.init_params(jax.random.PRNGKey(0),
                                 jlm.lm_param_specs(cfg), jnp.float32)
    return jax.tree.map(np.asarray, params)


def _inputs(path):
    rng = np.random.default_rng(0)
    flat = {}
    for name in ranks.CONFIGS:
        flat.update(_flat(_weights(name), f"{name}/params"))
        flat[f"serve/{name}/prompt"] = rng.integers(
            0, ranks.torch_cfg(name).vocab,
            (ranks.SERVE_ROWS * ranks.MESH[0], ranks.SERVE_PROMPT)
        ).astype(np.int32)
    vocab = ranks.torch_cfg("moonshot").vocab
    for i in range(ranks.STEPS):
        tok = rng.integers(0, vocab, (ranks.BATCH, ranks.SEQ + 1))
        flat[f"batch{i}/inputs"] = tok[:, :-1].astype(np.int32)
        flat[f"batch{i}/labels"] = tok[:, 1:].astype(np.int32)
    np.savez(path, **flat)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("expert_parallel")
    inputs = str(tmp / "inputs.npz")
    _inputs(inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = {
        "port": subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={RANKS}", HELPER, "port", inputs,
             str(tmp / "port")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            start_new_session=True),
        "ref": subprocess.Popen(
            [sys.executable, HELPER, "ref", inputs, str(tmp / "ref.npz")],
            env=jenv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            start_new_session=True),
    }
    try:
        for name, p in procs.items():
            out, _ = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"{name}:\n{out.decode()[-4000:]}"
    finally:  # a failed side leaves no process behind
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    ref = ranks.load(tmp / "ref.npz")
    port = [ranks.load(tmp / f"port.rank{r}.npz") for r in range(RANKS)]
    return dict(ref=ref, port=port,
                meta=[json.loads(str(p["meta"])) for p in port])


CASES = [(name, layout, backend) for name in ranks.CONFIGS
         for layout in ranks.LAYOUTS for backend in ranks.BACKENDS]


def _rel(got, want):
    return np.abs(np.asarray(got) - want) / np.abs(want)


@pytest.mark.parametrize("name,layout,backend", CASES)
def test_expert_parallel_matches_the_whole_layout(runs, name, layout,
                                                  backend):
    """Each gradient leaf is held to the replicated step's whole leaf's
    max |g| (under FSDP a rank holds a shard's gradient).  A leaf whose
    gradient is zero but for float rounding, under GRAD_TOL of the
    step's largest |g| (the router of a top-1 config: its renormalized
    gate is 1 whatever the logits), is held there in both layouts."""
    on = ranks.case(name, layout, backend, True)
    off = ranks.case(name, layout, backend, False)
    rep = ranks.case(name, "replicated", backend, False)
    for r, got in enumerate(runs["port"]):
        assert np.all(np.isfinite(got[f"{on}/losses"]))
        assert np.all(_rel(got[f"{on}/losses"], got[f"{off}/losses"])
                      <= LOSS_TOL), (r, got[f"{on}/losses"],
                                     got[f"{off}/losses"])
        keys = [k for k in got if k.startswith(f"{off}/grads/")]
        assert any("/ffn/wi" in k for k in keys)
        scales = {k: float(np.abs(got[k.replace(off, rep, 1)]).max())
                  for k in keys}
        top = max(scales.values())
        zero = {k for k in keys if scales[k] < GRAD_TOL * top}
        assert all(k.endswith("/ffn/router") for k in zero), zero
        assert not zero or ranks.torch_cfg(name).top_k == 1, zero
        for k in keys:
            want, g = got[k], got[k.replace(off, on, 1)]
            if scales[k] < GRAD_TOL * top:
                assert max(np.abs(g).max(), np.abs(want).max()) \
                    <= GRAD_TOL * top, (r, k)
                continue
            assert np.abs(g - want).max() <= GRAD_TOL * scales[k], (r, k)


@pytest.mark.parametrize("name", list(ranks.CONFIGS))
def test_the_ranks_hold_the_same_parameters(runs, name):
    for backend in ranks.BACKENDS:
        c = ranks.case(name, "replicated", backend, True)
        first = runs["port"][0]
        keys = [k for k in first if k.startswith(f"{c}/params1/")]
        assert keys
        for other in runs["port"][1:]:
            for k in keys:
                np.testing.assert_array_equal(other[k], first[k], err_msg=k)


@pytest.mark.parametrize("name", list(ranks.CONFIGS))
def test_the_moment_encoder_output(runs, name):
    on = ranks.case(name, "replicated", "pallas_moment", True)
    off = ranks.case(name, "replicated", "pallas_moment", False)
    for got in runs["port"]:
        np.testing.assert_array_equal(got[f"{on}/encode"],
                                      got[f"{off}/encode"])


@pytest.mark.parametrize("name", list(ranks.CONFIGS))
def test_exact_losses_match_the_reference_mesh_step(runs, name):
    want = runs["ref"][f"train/{name}/losses"]
    for layout in ranks.LAYOUTS:
        c = ranks.case(name, layout, "exact", True)
        got = runs["port"][0][f"{c}/losses"]
        assert np.all(_rel(got, want) <= LOSS_TOL), (layout, got, want)


@pytest.mark.parametrize("name", list(ranks.CONFIGS))
def test_bitexact_prefill_and_decode_are_the_whole_layouts(runs, name):
    for r, got in enumerate(runs["port"]):
        on, off = f"serve/{name}/ep", f"serve/{name}/whole"
        assert np.all(np.isfinite(got[f"{on}/prefill"]))
        np.testing.assert_array_equal(got[f"{on}/prefill"],
                                      got[f"{off}/prefill"],
                                      err_msg=f"rank {r}")
        for i in range(ranks.SERVE_STEPS):
            np.testing.assert_array_equal(got[f"{on}/tokens{i}"],
                                          got[f"{off}/tokens{i}"])
            np.testing.assert_array_equal(got[f"{on}/logits{i}"],
                                          got[f"{off}/logits{i}"],
                                          err_msg=f"rank {r} step {i}")


# ---------------------------------------------------------------------------
# In process, on a RecordingMesh
# ---------------------------------------------------------------------------


def _params(name):
    return params_from_numpy(_weights(name), device="cpu")


def _recorded(mesh, prefixes):
    got: dict = {}
    for (_, _, nbytes), site in zip(mesh.records, mesh.sites):
        if site.startswith(prefixes):
            e = got.setdefault(site, {"count": 0, "bytes": 0})
            e["count"] += 1
            e["bytes"] += nbytes
    return got


def _traced_step(name, backend, layout, mesh, **cfg_kw):
    cfg = ranks.torch_cfg(name, sc_backend=backend, remat="full", **cfg_kw)
    tcfg = TrainConfig(fsdp=layout == "fsdp", microbatches=2)
    params = _params(name) if not cfg_kw else init_params(
        tlm.lm_param_specs(cfg), torch.Generator().manual_seed(0), "cpu",
        torch.float32)
    if tcfg.fsdp:
        params = fsdp.shard_tree(params, param_shardings(
            tlm.lm_param_specs(cfg), mesh))
    state = {"params": params, "opt": adamw_init(params, tcfg.optimizer)}
    b = 4 * mesh.shape["data"]
    tok = torch.zeros((b, ranks.SEQ), dtype=torch.int32)
    C.trace_cost(make_train_step(cfg, tcfg, mesh), state,
                 {"inputs": tok, "labels": tok}, mesh=mesh)
    return cfg, tcfg, b


@pytest.mark.parametrize("name,layout,backend", CASES)
def test_collective_plans_count_a_step(name, layout, backend):
    rec = RecordingMesh(ranks.MESH, ("data", "model"))
    cfg, tcfg, b = _traced_step(name, backend, layout, rec)
    got = _recorded(rec, ("tp.", "ep."))
    assert {"ep.gather", "ep.sum"} <= set(got)
    assert ("ep.grad" in got) == (layout == "replicated")
    assert tp.tp_collective_plan(cfg, rec, b, ranks.SEQ, microbatches=2,
                                 fsdp=tcfg.fsdp) == got
    if tcfg.fsdp:
        plan = fsdp.collective_plan(cfg, rec, reduce_axes=("data",),
                                    microbatches=2)
        kinds: dict = {}
        for (kind, _, nbytes), site in zip(rec.records, rec.sites):
            if site in ("mesh.all_gather", "reduce-scatter"):
                e = kinds.setdefault(kind, {"count": 0, "bytes": 0})
                e["count"] += 1
                e["bytes"] += nbytes
        assert kinds == {k: plan[k] for k in kinds}
        assert set(kinds) == {"all-gather", "reduce-scatter"}
        # the expert leaves gather over data only: the plan with the
        # layout off gathers them over model too, at more bytes
        off = fsdp.collective_plan(cfg, rec, reduce_axes=("data",),
                                   microbatches=2, expert_parallel=False)
        assert off["all-gather"]["count"] > plan["all-gather"]["count"]
        assert off["reduce-scatter"] == plan["reduce-scatter"]


class _Shapes(TorchDispatchMode):
    """Every op output's shape under the mode."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.add(tuple(t.shape))
        return out


@pytest.mark.parametrize("name", list(ranks.CONFIGS))
def test_no_whole_expert_leaf_is_live_under_fsdp(name):
    """No op of an FSDP step with the layout on makes a tensor of a whole
    expert leaf's shape (the gathered leaf, its gradient, a gradient
    sum); with the layout off the gathers make them."""
    cfg = ranks.torch_cfg(name, sc_backend="exact", remat="full")
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    whole = {(e, d, 2 * f), (e, f, d)}
    block = {(e // 2, d, 2 * f), (e // 2, f, d)}
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (8, ranks.SEQ)).astype(np.int32))
    seen = {}
    for on in (True, False):
        rec = RecordingMesh(ranks.MESH, ("data", "model"))
        tcfg = TrainConfig(fsdp=True)
        params = fsdp.shard_tree(_params(name), param_shardings(
            tlm.lm_param_specs(cfg), rec))
        state = {"params": params, "opt": adamw_init(params, tcfg.optimizer)}
        with ranks.layout(on):
            step = make_train_step(cfg, tcfg, rec)
        with _Shapes() as mode:
            step.loss_and_grads(state, {"inputs": tok, "labels": tok})
        seen[on] = mode.shapes
    assert not seen[True] & whole and block <= seen[True]
    assert whole <= seen[False]


def test_an_indivisible_expert_count_stays_whole():
    """6 experts on model 4: the experts stay whole on every rank (the
    reference's per-tensor fallback), no ``ep.*`` collective runs and
    FSDP gathers the expert leaves whole."""
    mesh = RecordingMesh((1, 4), ("data", "model"))
    cfg = ranks.torch_cfg("moonshot", n_experts=6)
    assert ep.expert_block(make_constrain(mesh), cfg) is None
    assert ep.expert_block(make_constrain(mesh), ranks.torch_cfg(
        "moonshot")).size == 2
    specs = tlm.lm_param_specs(cfg)
    kept = fsdp.keep_blocks(param_shardings(specs, mesh), specs)
    assert kept["blocks"]["ffn"]["wi"].keep == ()
    _traced_step("moonshot", "exact", "fsdp", mesh, n_experts=6)
    assert not any(s.startswith("ep.") for s in mesh.sites)
    assert tp.tp_collective_plan(cfg, mesh, 4, ranks.SEQ, microbatches=2,
                                 fsdp=True).keys().isdisjoint(
        {"ep.gather", "ep.sum", "ep.grad"})


@pytest.mark.parametrize("backend", ["exact", "pallas_moment",
                                     "pallas_bitexact"])
def test_a_ranks_experts_are_the_whole_layouts(backend):
    """``expert_dense`` on a rank's block of the experts (keys folded
    with the global expert index) gives the whole layout's outputs for
    those experts, bit for bit, at each coordinate of model 4."""
    cfg = ranks.torch_cfg("moonshot", sc_backend=backend, sc_nbit=32)
    # narrow operands: the plain bit-exact version costs ~4 µs a MUL
    e, c, d, f = cfg.n_experts, 2, 16, 12
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, e, c, d), generator=g)
    w = torch.randn((e, d, f), generator=g) / d ** 0.5
    keys = ctr_rng.fold_in(ctr_rng.prng_key(9), torch.arange(
        2 * e * c).reshape(2, e, c))
    key = None if backend == "exact" else keys
    want = layers.expert_dense(x, w, cfg, key)
    mesh = RecordingMesh((1, 4), ("data", "model"))
    for c in range(4):
        mesh.coords = {"data": 0, "model": c}
        blk = rules.col_block(mesh, ("model",), e)
        sl = slice(blk.start, blk.stop)
        got = layers.expert_dense(
            x[:, sl], w[sl], cfg, None if key is None else key[:, sl],
            experts=blk)
        assert torch.equal(got, want[:, sl]), c
    if backend != "exact":  # the global index, not the local one
        local = layers.expert_dense(x[:, sl], w[sl], cfg, key[:, sl])
        assert not torch.equal(local, want[:, sl])


def test_the_layouts_cannot_disagree():
    """``make_param_constrain``'s expert layout must be the activation
    constraint's: a mismatch raises, and expert leaves of the wrong
    size raise."""
    mesh = RecordingMesh(ranks.MESH, ("data", "model"))
    cfg = ranks.torch_cfg("maverick")
    params = _params("maverick")
    tok = torch.zeros((2, ranks.SEQ), dtype=torch.int64)
    for on in (True, False):
        cst = make_constrain(mesh, tensor_parallel=on)
        cstp = make_param_constrain(mesh, cfg, expert_parallel=not on)
        assert cstp.expert_parallel == (not on)
        with pytest.raises(ValueError, match="lays the experts out"):
            tlm.encode(params, tok, cfg, constrain=cst,
                       constrain_params=cstp)
    trivial = RecordingMesh((4, 1), ("data", "model"))
    assert not make_param_constrain(trivial, cfg).expert_parallel
    blk = ep.expert_block(make_constrain(mesh), cfg)
    w = params["blocks"]["ffn"]["wi"][0]
    with pytest.raises(ValueError, match="neither all"):
        ep.local_experts(w[:3], blk, cfg.n_experts)
    with pytest.raises(ValueError, match="expert-parallel layout is off"):
        ep.local_experts(w[:4], None, cfg.n_experts)
    mine = w[:4]
    assert ep.local_experts(mine, blk, cfg.n_experts) is mine
    assert torch.equal(ep.local_experts(w, blk, cfg.n_experts), mine)


def test_the_replicated_slice_gathers_its_gradient():
    """In the replicated layout a whole expert leaf is sliced to the
    rank's block, and its gradient is gathered whole over ``model``
    (``ep.grad``): the block's rows carry the gradient of the block."""
    mesh = RecordingMesh(ranks.MESH, ("data", "model"))
    blk = rules.col_block(mesh, ("model",), 8)
    w = torch.randn((8, 3, 5), requires_grad=True)
    part = ep.local_experts(w, blk, 8)
    assert part.shape == (4, 3, 5)
    (part * torch.arange(4.0)[:, None, None]).sum().backward()
    assert w.grad.shape == (8, 3, 5)
    assert torch.equal(w.grad[:4], torch.arange(4.0)[:, None, None]
                       .expand(4, 3, 5))
    assert mesh.sites == ["ep.grad"]
    with torch.no_grad():
        view = ep.local_experts(w, blk, 8)
    assert view.data_ptr() == w.data_ptr()  # no copy without a gradient
