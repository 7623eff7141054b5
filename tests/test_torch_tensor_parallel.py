"""PyTorch port vs JAX reference: the in-layer layout of a mesh step
(``sharding/tp.py``): the heads / kv heads, the MLP hidden, the loss's
vocabulary and the SSM's ``d_inner`` / heads over ``model``, the
context-parallel attention branch where the heads do not divide, and
the SSM decode state's heads block.

The reference runs in a subprocess on 4 host devices with Auto-axes
meshes; the port as 4 gloo ranks of the CPU under ``torchrun``; both
sides live in ``tests/_torch_tensor_parallel_ranks.py`` and start
together.  Held:

* the mesh train step with the in-layer layout against the same step
  with it off (``make_constrain(..., tensor_parallel=False)``: the
  sequence layouts alone), for the dense, SSM and hybrid smoke configs on data 2 x
  model 2 (the heads branch) and a 6-head dense config on data 1 x
  model 4 (the context-parallel branch), under ``remat="full"``, on
  ``exact`` and ``pallas_moment``, replicated and FSDP, 2 AdamW steps:
  both losses within 1e-6 (relative) and every step-1 gradient leaf
  within 1e-5 of its max |g|, on every rank; the replicated layout's
  ranks hold the same parameters bit for bit after step 1;
* the ``pallas_moment`` encoder output (``lm.encode``) under the layout
  bit-equal to the whole layout's, every family: every SC call sees the
  whole layout's operands (a column-parallel call slices the whole
  layout's merged product, a row-parallel call takes its K block as the
  whole layout's call cuts it, the SSM's per-token ``out`` call its
  gathered input), and the heads' and the SSD's per-head arithmetic
  rounds as it does on all heads;
* the ``exact`` losses within 1e-6 (relative) of the reference's mesh
  step under its shipped ``ACT_RULES``;
* ``exact`` decode on the rank's heads block (a whole cache, dense) and
  on its SSM state block (``cst.lay_out_cache``, SSM and hybrid: the
  state ``(b, h/2, n, p)`` and ``conv_x``'s ``d_inner`` block, half the
  whole state's bytes): logits within 1e-5 of max |logit| of the
  reference's ``lm.decode_step``, equal greedy tokens;
* in process, on a ``RecordingMesh``: each checkpoint's in-layer saved
  tensors at their block's width (``saved_tensors_hooks``); an axis that
  does not divide stays whole; ``tp_collective_plan`` equal to the
  ``tp.*`` collectives a step records; the decode cache at
  ``launch/specs.py:cache_shardings``' shard shapes.
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

from repro.models import lm as jlm
from repro.models import params as jparams
from repro_torch.launch import cost_analysis as C
from repro_torch.launch.mesh import AbstractMesh, RecordingMesh
from repro_torch.models import lm as tlm
from repro_torch.models.params import init_params, params_from_numpy, tree_map
from repro_torch.optim import adamw_init
from repro_torch.sharding import fsdp, param_shardings, rules, tp
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train.step import make_constrain

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
HELPER = os.path.join(HERE, "_torch_tensor_parallel_ranks.py")
sys.path.insert(0, HERE)
import _torch_tensor_parallel_ranks as ranks  # noqa: E402
from _torch_train_mesh_ranks import _flat  # noqa: E402

RANKS = 4
TIMEOUT = 300  # seconds a side may take
LOSS_TOL = 1e-6  # relative
GRAD_TOL = 1e-5  # of the leaf's max |g|
LOGIT_TOL = 1e-5  # of max |logit|


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
    vocab = ranks.torch_cfg("dense").vocab
    for i in range(ranks.STEPS):
        tok = rng.integers(0, vocab, (ranks.BATCH, ranks.SEQ + 1))
        flat[f"batch{i}/inputs"] = tok[:, :-1].astype(np.int32)
        flat[f"batch{i}/labels"] = tok[:, 1:].astype(np.int32)
    for case, (name, batch, max_len, fills, steps, _) in ranks.DECODE.items():
        cfg = ranks.jax_cfg(name)
        cache = jax.tree.map(np.asarray, jlm.init_cache(cfg, batch, max_len))
        for key, v in _flat(cache, f"{case}/cache").items():
            flat[key] = rng.standard_normal(v.shape).astype(v.dtype)
        flat[f"{case}/lengths"] = np.asarray(fills, np.int32)
        flat[f"{case}/tokens"] = rng.integers(
            0, cfg.vocab, (steps, batch)).astype(np.int32)
    np.savez(path, **flat)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tensor_parallel")
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


CASES = [(name, mesh, layout, backend) for name, mesh in ranks.TRAIN
         for layout in ranks.LAYOUTS for backend in ranks.BACKENDS]


def _rel(got, want):
    return np.abs(np.asarray(got) - want) / np.abs(want)


@pytest.mark.parametrize("name,mesh,layout,backend", CASES)
def test_in_layer_layout_matches_the_whole_layout(runs, name, mesh, layout,
                                                  backend):
    """Each gradient leaf is held to its whole leaf's max |g| (under
    FSDP a rank holds a shard's gradient; the scale is the replicated
    step's whole leaf)."""
    tpc = ranks._case(name, mesh, layout, backend, True)
    whole = ranks._case(name, mesh, layout, backend, False)
    rep = ranks._case(name, mesh, "replicated", backend, False)
    for r, got in enumerate(runs["port"]):
        assert np.all(np.isfinite(got[f"{tpc}/losses"]))
        assert np.all(_rel(got[f"{tpc}/losses"], got[f"{whole}/losses"])
                      <= LOSS_TOL), (r, got[f"{tpc}/losses"],
                                     got[f"{whole}/losses"])
        keys = [k for k in got if k.startswith(f"{whole}/grads/")]
        assert keys
        for k in keys:
            want, g = got[k], got[k.replace(whole, tpc, 1)]
            scale = float(np.abs(got[k.replace(whole, rep, 1)]).max()) or 1.0
            assert np.abs(g - want).max() <= GRAD_TOL * scale, (r, k)


@pytest.mark.parametrize("name,mesh", ranks.TRAIN)
def test_the_ranks_hold_the_same_parameters(runs, name, mesh):
    for backend in ranks.BACKENDS:
        case = ranks._case(name, mesh, "replicated", backend, True)
        first = runs["port"][0]
        keys = [k for k in first if k.startswith(f"{case}/params1/")]
        assert keys
        for other in runs["port"][1:]:
            for k in keys:
                np.testing.assert_array_equal(other[k], first[k], err_msg=k)


@pytest.mark.parametrize("name,mesh", ranks.TRAIN)
def test_the_moment_encoder_output(runs, name, mesh):
    tpc = ranks._case(name, mesh, "replicated", "pallas_moment", True)
    whole = ranks._case(name, mesh, "replicated", "pallas_moment", False)
    for got in runs["port"]:
        np.testing.assert_array_equal(got[f"{tpc}/encode"],
                                      got[f"{whole}/encode"])


@pytest.mark.parametrize("name,mesh", ranks.TRAIN)
def test_exact_losses_match_the_reference_mesh_step(runs, name, mesh):
    want = runs["ref"][f"train/{name}/{mesh}/losses"]
    for layout in ranks.LAYOUTS:
        case = ranks._case(name, mesh, layout, "exact", True)
        got = runs["port"][0][f"{case}/losses"]
        assert np.all(_rel(got, want) <= LOSS_TOL), (layout, got, want)


@pytest.mark.parametrize("case", sorted(ranks.DECODE))
def test_decode_on_the_rank_blocks_matches_the_reference(runs, case):
    name, batch, max_len, fills, steps, lay = ranks.DECODE[case]
    for r, got in enumerate(runs["port"]):
        meta = runs["meta"][r]
        lo, hi = meta[f"decode/{case}/rows"]
        for i in range(steps):
            want = runs["ref"][f"decode/{case}/logits{i}"][lo:hi]
            out = got[f"decode/{case}/logits{i}"]
            scale = float(np.abs(want).max())
            np.testing.assert_allclose(out, want, rtol=0,
                                       atol=LOGIT_TOL * scale,
                                       err_msg=f"rank {r} step {i}")
            np.testing.assert_array_equal(out.argmax(-1), want.argmax(-1))
        if lay == "state":
            cfg = ranks.torch_cfg(name)
            whole = tlm.init_cache(cfg, hi - lo, max_len, device="meta")
            n = sum(t.numel() * t.element_size()
                    for t in whole["ssm"].values())
            state = whole["ssm"]["state"]
            half = state.numel() * state.element_size() // 2 + (
                whole["ssm"]["conv_x"].numel()
                * whole["ssm"]["conv_x"].element_size() // 2)
            assert meta[f"decode/{case}/state_bytes"] == n - half


# ---------------------------------------------------------------------------
# In process, on a RecordingMesh
# ---------------------------------------------------------------------------


def _params(name):
    return params_from_numpy(_weights(name), device="cpu")


def test_each_layer_saves_its_blocks():
    """What a layer saves for its backward (``remat="none"``: under
    ``remat="full"`` the same tensors are what the recompute holds) is
    the rank's block of the MLP hidden (the activation's ``gate`` and
    ``up`` ``d_ff / 2`` wide), never the whole ``d_ff``; with the layout
    off the whole hidden is saved."""
    cfg = ranks.torch_cfg("dense", remat="none", d_ff=256)
    params = init_params(tlm.lm_param_specs(cfg),
                         torch.Generator().manual_seed(0), "cpu",
                         torch.float32)
    params = tree_map(lambda t: t.requires_grad_(True), params)
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 16)))
    f = cfg.d_ff
    widths = {}
    for on in (True, False):
        mesh = RecordingMesh((2, 2), ("data", "model"))
        cst = make_constrain(mesh, tensor_parallel=on)
        saved = []

        def pack(t):
            saved.append(tuple(t.shape))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = tlm.lm_loss(params, {"inputs": tok, "labels": tok}, cfg,
                               constrain=cst)
        loss.backward()
        widths[on] = {s[-1] for s in saved if len(s) == 3 and s[:2] == (
            2, 16)}
    assert f not in widths[True] and f // 2 in widths[True], widths
    assert f in widths[False] and f // 2 not in widths[False], widths


def test_an_indivisible_axis_stays_whole():
    """On model 3 nothing of the dense smoke config divides (4 heads, 2
    kv heads, d_ff 128, vocab 256, a sequence of 16): every in-layer
    tensor stays whole, no ``tp.*`` collective runs, and the loss is the
    whole layout's bit for bit."""
    mesh = RecordingMesh((1, 3), ("data", "model"))
    layout = tp.TensorParallel(mesh)
    cfg = ranks.torch_cfg("dense", remat="full")
    for n in (cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab, 16):
        assert layout.block(n) is None
    assert layout.block(12).width == 4 and layout.block(12, 2).width == 4
    assert rules.col_block(AbstractMesh((2, 1), ("data", "model")),
                           ("model",), 8) is None
    params = _params("dense")
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 16)))
    losses = []
    for on in (True, False):
        cst = make_constrain(mesh, tensor_parallel=on)
        losses.append(tlm.lm_loss(params, {"inputs": tok, "labels": tok},
                                  cfg, constrain=cst))
    assert torch.equal(losses[0], losses[1])
    assert not any(s.startswith("tp.") for s in mesh.sites)
    assert tp.tp_collective_plan(cfg, mesh, 2, 16) == {}


PLAN_CASES = [(name, mesh, backend, lay, "float32")
              for name, mesh in ranks.TRAIN for backend in ranks.BACKENDS
              for lay in ranks.LAYOUTS] + [
                  ("hybrid", "2x2", backend, "fsdp", "bfloat16")
                  for backend in ranks.BACKENDS]


@pytest.mark.parametrize("name,mesh,backend,layout,dtype", PLAN_CASES)
def test_tp_collective_plan_counts_a_step(name, mesh, backend, layout,
                                          dtype):
    dt = getattr(torch, dtype)
    cfg = ranks.torch_cfg(name, sc_backend=backend, remat="full").replace(
        param_dtype=dt, act_dtype=dt)
    rec = RecordingMesh(ranks.MESHES[mesh], ("data", "model"))
    tcfg = TrainConfig(fsdp=layout == "fsdp", microbatches=2)
    params = tree_map(lambda t: t.to(dt), _params(name))
    if tcfg.fsdp:
        params = fsdp.shard_tree(params, param_shardings(
            tlm.lm_param_specs(cfg), rec))
    state = {"params": params, "opt": adamw_init(params, tcfg.optimizer)}
    b = 4 * rec.shape["data"]
    tok = torch.zeros((b, ranks.SEQ), dtype=torch.int32)
    C.trace_cost(make_train_step(cfg, tcfg, rec), state,
                 {"inputs": tok, "labels": tok}, mesh=rec)
    got: dict = {}
    for (_, _, nbytes), site in zip(rec.records, rec.sites):
        if site.startswith("tp."):
            e = got.setdefault(site, {"count": 0, "bytes": 0})
            e["count"] += 1
            e["bytes"] += nbytes
    assert got
    assert tp.tp_collective_plan(cfg, rec, b, ranks.SEQ,
                                 microbatches=2) == got


@pytest.mark.parametrize("name", ["ssm", "hybrid", "dense"])
def test_the_decode_cache_is_cache_shardings_block(name):
    """``init_cache`` under ``cst.lay_out_cache`` holds every leaf at
    ``launch/specs.py:cache_shardings``' shard shape on data 4 x model 4
    (the SSM state's heads and ``conv_x``'s ``d_inner`` over ``model``);
    with the in-layer layout off the state stays whole."""
    from repro_torch.launch import specs as S
    from repro_torch.models.params import _leaves

    cfg = ranks.torch_cfg(name)
    mesh = AbstractMesh((4, 4), ("data", "model"))
    mesh.coords = {"data": 0, "model": 0}
    batch, max_len = 128, 32768
    rows = batch // 4
    cst = make_constrain(mesh)
    cst.lay_out_cache(batch, max_len)
    got = dict(_leaves(tlm.init_cache(cfg, rows, max_len, device="meta",
                                      constrain=cst)))
    want = dict(_leaves(S.cache_shardings(cfg, mesh, batch, max_len)))
    whole = dict(_leaves(tlm.init_cache(cfg, batch, max_len,
                                        device="meta")))
    assert set(got) == set(want) == set(whole)
    for path, t in got.items():
        assert tuple(t.shape) == want[path].shard_shape(whole[path].shape), \
            path
    off = make_constrain(mesh, tensor_parallel=False)
    off.lay_out_cache(batch, max_len)
    old = dict(_leaves(tlm.init_cache(cfg, rows, max_len, device="meta",
                                      constrain=off)))
    if cfg.family in ("ssm", "hybrid"):
        state = ("ssm", "state")
        assert got[state].shape[2] == cfg.ssm_heads // 4
        assert old[state].shape[2] == cfg.ssm_heads
