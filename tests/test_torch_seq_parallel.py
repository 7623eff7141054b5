"""PyTorch port vs JAX reference: the sequence layouts of activations
(``sharding/seq.py``): the residual stream's sequence over ``model``
between the layers of a mesh train step, and a rank's block of the
decode cache's sequence in prefill and decode.

The reference runs in a subprocess on 4 host devices with an Auto-axes
mesh; the port as 4 gloo ranks of the CPU under ``torchrun``; both sides
live in ``tests/_torch_seq_parallel_ranks.py`` and start together.  The
port runs with every in-layer tensor whole (``make_constrain(...,
tensor_parallel=False)``, the layout these layouts came with; the
in-layer layout is ``tests/test_torch_tensor_parallel.py``'s).  Held:

* the mesh train step with the sequence layout, on the replicated and
  FSDP layouts, for the dense, SSM and hybrid smoke configs under
  ``remat="full"``, on ``exact`` and ``pallas_moment``, 2 AdamW steps on
  data 2 x model 2: losses and every leaf of the state equal to the
  step with the sequence whole (``make_constrain(...,
  seq_parallel=False)``) bit for bit, on every rank; the ``exact``
  losses within 1e-7 (relative) of the reference's mesh step beyond the
  reference's own shift between its two layouts (XLA reorders the
  gradient sums);
* each layer's checkpoint saves its block of ``s / 2`` positions
  (``torch.autograd.graph.saved_tensors_hooks``), and a sequence that
  does not divide stays whole;
* prefill laid out by a rank's block holds exactly that slice of the
  unsharded prefill's cache, dense and hybrid (``shared_k`` /
  ``shared_v``), at every coordinate of 2 x 2 and of a batch of 1;
* ``exact`` decode on the rank's block of the cache across a block
  boundary, on 2 x 2 (a row whose fill leaves one block empty) and at a
  batch of 1 with the sequence over data x model, dense and hybrid:
  logits within 1e-5 of max |logit| of the reference's
  ``lm.decode_step`` and equal greedy tokens; the ranks of a model group
  hold the same bits.
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

from repro.configs import get_smoke_config as jsmoke
from repro.models import lm as jlm
from repro.models import params as jparams
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.launch import cost_analysis as C
from repro_torch.launch.mesh import AbstractMesh, RecordingMesh
from repro_torch.models import lm as tlm
from repro_torch.models.params import params_from_numpy
from repro_torch.optim import adamw_init
from repro_torch.sharding import rules, seq
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train.step import make_constrain

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
HELPER = os.path.join(HERE, "_torch_seq_parallel_ranks.py")
sys.path.insert(0, HERE)
import _torch_seq_parallel_ranks as ranks  # noqa: E402
from _torch_train_mesh_ranks import _flat  # noqa: E402

RANKS = 4
TIMEOUT = 300  # seconds a side may take
LOSS_TOL = 1e-7  # relative: one float32 ulp of a loss near 5.5
LOGIT_TOL = 1e-5  # of max |logit|


def _jcfg(arch, **kw):
    return jsmoke(arch).replace(param_dtype=jnp.float32,
                                act_dtype=jnp.float32, **kw)


def _tcfg(arch, **kw):
    return tsmoke(arch).replace(param_dtype=torch.float32,
                                act_dtype=torch.float32, **kw)


def _weights(arch):
    cfg = _jcfg(arch)
    params = jparams.init_params(jax.random.PRNGKey(0),
                                 jlm.lm_param_specs(cfg), jnp.float32)
    return jax.tree.map(np.asarray, params)


def _inputs(path):
    rng = np.random.default_rng(0)
    flat = {}
    for arch in ranks.ARCHS:
        flat.update(_flat(_weights(arch), f"{arch}/params"))
    vocab = tsmoke(ranks.ARCHS[0]).vocab
    for i in range(ranks.STEPS):
        tok = rng.integers(0, vocab, (ranks.BATCH, ranks.SEQ + 1))
        flat[f"batch{i}/inputs"] = tok[:, :-1].astype(np.int32)
        flat[f"batch{i}/labels"] = tok[:, 1:].astype(np.int32)
    for name, (arch, batch, max_len, fills, steps) in ranks.DECODE.items():
        cfg = _jcfg(arch)
        cache = jax.tree.map(np.asarray, jlm.init_cache(cfg, batch, max_len))
        for key, v in _flat(cache, f"{name}/cache").items():
            flat[key] = rng.standard_normal(v.shape).astype(v.dtype)
        flat[f"{name}/lengths"] = np.asarray(fills, np.int32)
        flat[f"{name}/tokens"] = rng.integers(
            0, cfg.vocab, (steps, batch)).astype(np.int32)
    np.savez(path, **flat)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq_parallel")
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


CASES = [(arch, layout, backend) for arch in ranks.ARCHS
         for layout in ranks.LAYOUTS for backend in ranks.BACKENDS]


@pytest.mark.parametrize("arch,layout,backend", CASES)
def test_sequence_layout_is_the_whole_sequence_step_bit_for_bit(
        runs, arch, layout, backend):
    sp = ranks._case(arch, layout, backend, True)
    whole = ranks._case(arch, layout, backend, False)
    for r, got in enumerate(runs["port"]):
        np.testing.assert_array_equal(got[f"{sp}/losses"],
                                      got[f"{whole}/losses"],
                                      err_msg=f"rank {r}")
        keys = [k for k in got if k.startswith(f"{whole}/state/")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(
                got[k.replace(whole, sp, 1)], got[k],
                err_msg=f"rank {r}: {k}")
    losses = runs["port"][0][f"{sp}/losses"]
    assert all(np.array_equal(p[f"{sp}/losses"], losses)
               for p in runs["port"])
    assert np.all(np.isfinite(losses))


def _rel(got, want):
    return np.abs(np.asarray(got) - want) / np.abs(want)


@pytest.mark.parametrize("arch,layout", [(a, la) for a in ranks.ARCHS
                                         for la in ranks.LAYOUTS])
def test_sequence_layout_losses_match_the_reference_mesh_step(runs, arch,
                                                              layout):
    """Within 1e-7 of the reference's mesh step (the residual sequence
    over ``model``) beyond the reference's own shift from its step with
    the sequence whole: XLA sums the layers' gradients in another order
    under either layout (up to 2 float32 ulps of a loss here), while the
    port's layout changes no bit."""
    ref = runs["ref"]
    sp, whole = (ref[f"train/{arch}/{t}/losses"] for t in ("sp", "whole"))
    got = runs["port"][0][f"{ranks._case(arch, layout, 'exact', True)}/losses"]
    assert np.all(_rel(got, sp) <= LOSS_TOL + _rel(whole, sp)), (got, sp,
                                                                 whole)


@pytest.mark.parametrize("name", sorted(ranks.DECODE))
def test_decode_on_the_rank_block_matches_the_reference(runs, name):
    arch, batch, max_len, fills, steps = ranks.DECODE[name]
    spans = set()
    for r, got in enumerate(runs["port"]):
        meta = runs["meta"][r]
        lo, hi = meta[f"decode/{name}/rows"]
        start, stop, axes = meta[f"decode/{name}/block"]
        spans.add((start, stop))
        for i in range(steps):
            want = runs["ref"][f"decode/{name}/logits{i}"][lo:hi]
            out = got[f"decode/{name}/logits{i}"]
            scale = float(np.abs(want).max())
            np.testing.assert_allclose(out, want, rtol=0,
                                       atol=LOGIT_TOL * scale,
                                       err_msg=f"rank {r} step {i}")
            np.testing.assert_array_equal(out.argmax(-1), want.argmax(-1))
    # every rank its own block: 2 on 2 x 2, 4 (data x model) at batch 1
    assert len(spans) == (4 if batch == 1 else 2)
    # the ranks of a model group hold the same bits
    for r in range(0, RANKS, 2):
        for i in range(steps):
            k = f"decode/{name}/logits{i}"
            np.testing.assert_array_equal(runs["port"][r][k],
                                          runs["port"][r + 1][k])


def test_a_fill_leaves_a_block_empty():
    """The cases above hold a row whose every position lies in the other
    rank's block (so that block contributes exactly zero), and rows that
    cross the boundary."""
    for name, (arch, batch, max_len, fills, steps) in ranks.DECODE.items():
        mesh = AbstractMesh(*ranks.MESH)
        axes = rules.cache_seq_axes(mesh, batch, max_len)
        size = max_len // int(np.prod([mesh.shape[a] for a in axes]))
        last = [f + steps for f in fills]
        assert min(last) <= max_len - size, name  # the last block empty
        assert any(f < size <= f + steps - 1 for f in fills), name


def _mesh_at(shape, names, coords):
    mesh = AbstractMesh(shape, names)
    mesh.coords = dict(zip(names, coords))
    return mesh


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-7b"])
@pytest.mark.parametrize("batch", [4, 1])
def test_prefill_keeps_the_rank_slice_of_the_cache(arch, batch):
    cfg = _tcfg(arch)
    params = params_from_numpy(_weights(arch), device="cpu")
    max_len, s = 32, 20
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (batch, s)))
    with torch.no_grad():
        logits, whole, lengths = tlm.prefill(params, tokens, cfg, max_len)
    names = ("shared_k", "shared_v") if cfg.family == "hybrid" \
        else ("k", "v")
    seen = set()
    for coords in np.ndindex(*ranks.MESH[0]):
        mesh = _mesh_at(*ranks.MESH, coords)
        cst = make_constrain(mesh, tensor_parallel=False)
        blk = cst.lay_out_cache(batch, max_len)
        assert blk.axes == (("model",) if batch == 4 else ("data", "model"))
        with torch.no_grad():
            lg, cache, ln = tlm.prefill(params, tokens, cfg, max_len,
                                        constrain=cst)
        assert torch.equal(lg, logits) and torch.equal(ln, lengths)
        for n in names:
            assert cache[n].shape[2] == max_len // blk.span
            assert torch.equal(cache[n], whole[n][:, :, blk.start:blk.stop])
        if cfg.family == "hybrid":
            for k, v in cache["ssm"].items():
                assert torch.equal(v, whole["ssm"][k])
        seen.add(blk.start)
    assert len(seen) == (2 if batch == 4 else 4)


def test_cache_axes_are_cache_shardings_axes():
    from repro_torch.launch import specs as S

    for shape, names in (((16, 16), ("data", "model")),
                         ((2, 16, 16), ("pod", "data", "model")),
                         ((2, 2), ("data", "model"))):
        mesh = AbstractMesh(shape, names)
        for batch in (1, 2, 8, 128):
            for max_len in (24, 32, 32768, 524288):
                spec = S.cache_shardings(_tcfg("qwen2-0.5b"), mesh, batch,
                                         max_len)["k"].spec[2]
                axes = rules.cache_seq_axes(mesh, batch, max_len)
                assert axes == rules.spec_axes(spec), (shape, batch, max_len)
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert rules.cache_seq_axes(mesh, 1, 524288) == ("pod", "data", "model")
    assert rules.cache_seq_axes(mesh, 128, 32768) == ("model",)
    assert rules.cache_seq_axes(mesh, 128, 100) == ()


@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_each_layer_saves_its_block(arch):
    """Under ``remat="full"`` each layer's checkpoint saves its input,
    this rank's block of ``s / 2`` positions (on a ``RecordingMesh``,
    whose gathers repeat the block); with the sequence whole it saves
    all ``s``."""
    cfg = _tcfg(arch, remat="full")
    params = params_from_numpy(_weights(arch), device="cpu")
    b, s, d = 2, 16, cfg.d_model
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (b, s)))
    bodies = tlm.n_backbone_layers(cfg) + tlm.n_shared_invocations(cfg)
    for sp, want in ((True, s // 2), (False, s)):
        mesh = RecordingMesh(*ranks.MESH)
        cst = make_constrain(mesh, seq_parallel=sp, tensor_parallel=False)
        saved = []

        def pack(t):
            saved.append(tuple(t.shape))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            tlm.lm_loss(params, {"inputs": tok, "labels": tok}, cfg,
                        constrain=cst)
        acts = [t for t in saved if len(t) == 3 and t[0] == b and t[2] == d]
        # the layers' inputs, then the last layer's output, gathered
        assert acts[:bodies] == [(b, want, d)] * bodies, (sp, acts)
        assert acts[bodies:] == [(b, s, d)], (sp, acts)
        if sp:
            gathers = [r for r in mesh.records if r[0] == "all-gather"]
            assert len(gathers) == bodies + 1  # the forward's


def test_an_indivisible_sequence_stays_whole():
    cfg = _tcfg("qwen2-0.5b", remat="full")
    mesh = RecordingMesh(*ranks.MESH)
    cst = make_constrain(mesh, tensor_parallel=False)
    assert cst.seq_axes == ("model",)
    assert cst.seq_block(15) is None and cst.seq_block(16).size == 8
    assert seq.seq_collective_plan(cfg, mesh, 4, 15) == {}
    params = params_from_numpy(_weights("qwen2-0.5b"), device="cpu")
    state = {"params": params, "opt": adamw_init(params,
                                                 TrainConfig().optimizer)}
    tok = torch.zeros((4, 15), dtype=torch.int32)
    with ranks.whole_sequence(False):
        step = make_train_step(cfg, TrainConfig(), mesh)
    _, cost = C.trace_cost(step, state, {"inputs": tok, "labels": tok},
                           mesh=mesh)
    assert "all-gather" not in cost.coll_by_kind
    assert {r[1] for r in mesh.records} == {"data"}


def test_seq_collective_plan_counts_a_step():
    cfg = _tcfg("zamba2-7b", remat="full")
    mesh = AbstractMesh(*ranks.MESH)
    plan = seq.seq_collective_plan(cfg, mesh, 4, 16, microbatches=2)
    bodies = 4 + 2  # backbone layers and shared invocations
    n = 2 * (2 + 3 * bodies)
    rows = 4 // (2 * 2)
    assert plan["all-gather"] == {"count": n,
                                  "bytes": n * rows * 8 * cfg.d_model * 4}
    assert plan["by_axis"] == {"all-gather:model": plan["all-gather"][
        "bytes"]}
