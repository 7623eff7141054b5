"""PyTorch port vs JAX reference: the mesh train step on the FSDP ∘ TP
layout (``TrainConfig(fsdp=True)``, ``sharding/fsdp.py``).

The reference runs in three subprocesses on 4 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``), its meshes
built with Auto axes, its step jitted with the state's shardings
(``launch/specs.py``) as in and out shardings, as its dry-run jits it;
the port runs as 4 gloo ranks of the CPU under ``torchrun``.  Both sides
live in ``tests/_torch_train_fsdp_ranks.py`` and start together; the
weights and batches are ``tests/test_torch_train_mesh.py``'s.  Held:

* on data 2 x model 2, data 4 x model 1 and pod 2 x data 1 x model 2,
  on ``exact`` and ``pallas_moment`` (operand grid off), 3 AdamW steps:
  every loss within 1e-7 relative (one float32 ulp of the loss); each
  rank's shard of ``m`` and ``v`` against the reference's
  ``addressable_shards`` on the device at the rank's mesh coordinates
  within 1e-5 of the leaf's max |value|; its shard of the parameters
  within ``tests/test_torch_train_mesh.py``'s tolerances in units of the
  learning rate: 1e-2 lr, or 0.1 lr where the step-1 gradient is within
  1e-4 of the leaf's max of zero (there Adam's step follows the sign of
  noise);
* each rank's shard shape of every leaf of ``params``, ``m`` and ``v`` is
  the reference's, and its persistent state bytes are the reference
  layout's (``launch/dryrun.py:_sharded_bytes``); the eval step on the
  shards gives the reference's loss (1e-7);
* ``GatherParam``'s gradient is the slice of the whole leaf's mean
  gradient, bit for bit on integer data, for leaves split over data and
  model, one axis, none, and one (2 KV heads on model = 4) that falls
  back to replication, on 2x2, 1x4, 4x1 and the pod mesh;
* on pod 2 x data 2 with int8 AdamW state and the cross-pod compression,
  every int8 payload, scale and compressed gradient on the shards equals
  the slice of the replicated step's, element for element, with a leaf
  whose absmax lies on one shard;
* checkpoints: the sharded save restores in the reference's
  ``checkpoint.restore`` (the shards' bits), and the reference's
  checkpoint restores into shards (its bits) and the next step matches
  the reference's next step;
* under ``remat="full"`` the backward's recompute gathers every layer
  again (the recorded all-gathers of one step on a ``RecordingMesh``
  equal ``sharding.fsdp.collective_plan``, twice a layer), so no
  layer's gathered weights are kept for the backward.
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

from repro import checkpoint as jckpt
from repro.configs import get_smoke_config as jsmoke
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as jadamw_init
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.data import SyntheticLMData, make_batch
from repro_torch.launch import cost_analysis as C
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import RecordingMesh, make_local_mesh
from repro_torch.models import lm as tlm
from repro_torch.models import params as params_lib
from repro_torch.optim import AdamWConfig as TAdamW
from repro_torch.optim import adamw_init
from repro_torch.sharding import fsdp, param_shardings
from repro_torch.train import TrainConfig as TTrain
from repro_torch.train import make_train_step as tmake_train_step
from repro_torch.train import train_state_init as ttrain_state_init

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
HELPER = os.path.join(HERE, "_torch_train_fsdp_ranks.py")
sys.path.insert(0, HERE)
import _torch_train_fsdp_ranks as ranks  # noqa: E402
from test_torch_train_mesh import _inputs, _load  # noqa: E402

RANKS = 4
TIMEOUT = 240  # seconds a side may take (each takes ~15 s here)
REF_GROUPS = (("2x2/exact", "2x2/pallas_moment"),
              ("4x1/exact", "4x1/pallas_moment"),
              ("pod/exact", "pod/pallas_moment"))
LOSS_TOL = 1e-7  # relative: one float32 ulp of a loss near 5.5
MOMENT_TOL = 1e-5  # of the leaf's max |value|
P_TOL, P_TOL_NOISY, GRAD_NOISE = 1e-2, 0.1, 1e-4  # lr units; of max


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_fsdp")
    inputs = str(tmp / "inputs.npz")
    _inputs(inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PORT_CKPT=str(tmp / "port_ckpt"),
               REF_CKPT=str(tmp / "ref_ckpt"))
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = {"port": subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={RANKS}", HELPER, "port", inputs,
         str(tmp / "port")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        start_new_session=True)}
    for i, group in enumerate(REF_GROUPS):
        procs[f"ref{i}"] = subprocess.Popen(
            [sys.executable, HELPER, "ref", inputs, str(tmp / f"ref{i}.npz"),
             *group],
            env=jenv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            start_new_session=True)
    try:
        for name, p in procs.items():
            out, _ = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"{name}:\n{out.decode()[-4000:]}"
    finally:  # a failed side leaves no process behind
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    ref = {}
    for i in range(len(REF_GROUPS)):
        ref.update(_load(tmp / f"ref{i}.npz"))
    port = [_load(tmp / f"port.rank{r}.npz") for r in range(RANKS)]
    return dict(ref=ref, port=port, tmp=tmp,
                meta=[json.loads(str(p["meta"])) for p in port],
                inputs=_load(inputs))


def _rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


def _leaf_names(ref, prefix):
    return sorted({k[len(prefix):] for k in ref if k.startswith(prefix)})


def _leaf_max(ref, name, what, leaf):
    return max(np.abs(ref[f"{name}/{what}/rank{r}/{leaf}"]).max()
               for r in range(RANKS))


@pytest.mark.parametrize("name", list(ranks.CASES))
def test_fsdp_step_matches_reference_shards(runs, name):
    ref, lr = runs["ref"], ranks.base.ADAM["lr"]
    for r, port in enumerate(runs["port"]):
        for got, want in zip(port[f"{name}/losses"], ref[f"{name}/losses"]):
            assert _rel(got, want) <= LOSS_TOL, (r, got, want)
        for what in ("m", "v"):
            for leaf in _leaf_names(ref, f"{name}/{what}/rank{r}/"):
                got = port[f"{name}/{what}/{leaf}"]
                want = ref[f"{name}/{what}/rank{r}/{leaf}"]
                assert got.shape == want.shape, (r, what, leaf)
                scale = _leaf_max(ref, name, what, leaf)
                assert np.abs(got - want).max() <= MOMENT_TOL * scale, (
                    r, what, leaf)
        for leaf in _leaf_names(ref, f"{name}/params/rank{r}/"):
            got = port[f"{name}/params/{leaf}"]
            want = ref[f"{name}/params/rank{r}/{leaf}"]
            assert got.shape == want.shape, (r, leaf)
            m1 = ref[f"{name}/m1/rank{r}/{leaf}"]  # (1 - b1) x step-1 grad
            noisy = np.abs(m1) <= GRAD_NOISE * _leaf_max(ref, name, "m1",
                                                         leaf)
            err = np.abs(got - want) / lr
            assert err[~noisy].max(initial=0) <= P_TOL, (r, leaf)
            assert err.max() <= P_TOL_NOISY, (r, leaf)


@pytest.mark.parametrize("name", list(ranks.CASES))
def test_shard_shapes_and_state_bytes_are_the_reference_layout(runs, name):
    """Every rank holds exactly the reference's shard shape of every
    leaf (so no whole copy of a leaf the layout splits), and its
    persistent state is the reference layout's bytes."""
    ref = runs["ref"]
    mesh_name, _ = ranks.CASES[name]
    shape, names = ranks.MESHES[mesh_name]
    cfg = tsmoke("qwen2-0.5b").replace(param_dtype=torch.float32)
    rec = RecordingMesh(shape, names)
    whole = params_lib.abstract_params(tlm.lm_param_specs(cfg), torch.float32)
    p_sh = S.param_shardings(cfg, rec)
    want_bytes = 3 * dryrun._sharded_bytes(whole, p_sh) + 4
    for r, meta in enumerate(runs["meta"]):
        shapes = meta[f"{name}/shapes"]
        assert sorted(shapes) == _leaf_names(ref, f"{name}/params/rank{r}/")
        for leaf, got in shapes.items():
            assert tuple(got) == ref[f"{name}/params/rank{r}/{leaf}"].shape
        assert meta[f"{name}/state_bytes"] == want_bytes
    # the layout splits leaves on every one of these meshes
    assert want_bytes < 3 * 4 * C.param_count(cfg)


@pytest.mark.parametrize("name", [n for n in ranks.CASES
                                  if n.endswith("exact")])
def test_eval_step_on_shards_matches_reference(runs, name):
    for port in runs["port"]:
        assert _rel(port[f"{name}/eval"], runs["ref"][f"{name}/eval"]) \
            <= LOSS_TOL


@pytest.mark.parametrize("mesh_name", ranks.GRAD_MESHES)
def test_gather_param_gradient_is_the_slice_of_the_mean_gradient(
        runs, mesh_name):
    keys = set(ranks.GRAD_SPECS)
    for port in runs["port"]:
        for k in keys:
            pre = f"grad/{mesh_name}/{k}"
            np.testing.assert_array_equal(port[f"{pre}/got"],
                                          port[f"{pre}/want"], err_msg=pre)
            np.testing.assert_array_equal(port[f"{pre}/gathered"],
                                          runs["port"][0][f"{pre}/gathered"])
    if mesh_name == "1x4":  # 2 KV heads replicate over model = 4
        shape, names = ranks.MESHES[mesh_name]
        specs = {k: params_lib.ParamSpec(s, a)
                 for k, (s, a) in ranks.GRAD_SPECS.items()}
        pl = param_shardings(specs, RecordingMesh(shape, names))
        assert pl["wk"].spec == ("data", None, None)
        assert runs["port"][0][f"grad/{mesh_name}/wk/got"].shape == (8, 2, 4)


def test_int8_state_and_compressed_gradient_equal_the_replicated_step(runs):
    port = runs["port"]
    got = [k for k in port[0] if k.startswith("int8/") and k.endswith("/got")]
    assert len(got) == 13 * 6  # 13 leaves: m, v (q, scale), 2 gradients
    for p in port:
        for k in got:
            np.testing.assert_array_equal(p[k], p[k[:-4] + "/want"],
                                          err_msg=k)
    below = [m["int8_local_below"] for m in runs["meta"]]
    # a leaf whose absmax lies on one shard: some rank's own is below it
    assert any(any(b.values()) for b in below)
    assert any(b["blocks/ffn/wi"] for b in below)


def _jstate_like():
    jcfg = jsmoke("qwen2-0.5b").replace(param_dtype=jnp.float32,
                                        act_dtype=jnp.float32)
    params = jparams.init_params(jax.random.PRNGKey(0),
                                 jlm.lm_param_specs(jcfg), jnp.float32)
    return {"params": params,
            "opt": jadamw_init(params, JAdamW(**ranks.base.ADAM))}


def _rank_slice(whole, shard_shape, coords, spec):
    """The block of ``whole`` a rank at ``coords`` holds."""
    out = whole
    for i, n in enumerate(shard_shape):
        entry = spec[i] if i < len(spec) else None
        block = 0 if entry is None else coords[entry]
        out = np.take(out, range(block * n, (block + 1) * n), axis=i)
    return out


def test_sharded_checkpoint_restores_in_the_reference(runs):
    """The port's 2x2 checkpoint, gathered leaf by leaf from the shards,
    read by the reference's ``checkpoint.restore``: each rank's shard is
    its block of every restored leaf, bit for bit."""
    state, extra, step = jckpt.restore(str(runs["tmp"] / "port_ckpt"),
                                       _jstate_like())
    assert step == ranks.STEPS and extra["data_step"] == ranks.STEPS
    name = ranks.CKPT_CASE
    shape, names = ranks.MESHES[ranks.CASES[name][0]]
    cfg = tsmoke("qwen2-0.5b")
    pl = param_shardings(tlm.lm_param_specs(cfg),
                         RecordingMesh(shape, names))
    n = 0
    for r, port in enumerate(runs["port"]):
        coords = dict(zip(names, np.unravel_index(r, shape)))
        for what, tree in (("params", state["params"]),
                           ("m", state["opt"]["m"]),
                           ("v", state["opt"]["v"])):
            for k, whole in ranks.base._flat(
                    jax.tree.map(np.asarray, tree), what).items():
                leaf = k[len(what) + 1:]
                got = port[f"{name}/{what}/{leaf}"]
                np.testing.assert_array_equal(
                    _rank_slice(whole, got.shape, coords,
                                dict(params_lib._leaves(pl))[
                                    tuple(leaf.split("/"))].spec),
                    got, err_msg=k)
                n += 1
    assert n == RANKS * 3 * 13


def test_reference_checkpoint_restores_into_shards(runs):
    """The reference's 2x2 checkpoint restored into each rank's shards
    (its bits), and the next step against the reference's next step."""
    ref, lr = runs["ref"], ranks.base.ADAM["lr"]
    name = ranks.CKPT_CASE
    for r, port in enumerate(runs["port"]):
        assert int(port["restore/step"]) == ranks.STEPS
        for leaf in _leaf_names(ref, f"{name}/params/rank{r}/"):
            np.testing.assert_array_equal(
                port[f"restore/shards/{leaf}"],
                ref[f"{name}/params/rank{r}/{leaf}"], err_msg=leaf)
            got = port[f"restore/params/{leaf}"]
            want = ref[f"{name}/next/params/rank{r}/{leaf}"]
            assert np.abs(got - want).max() / lr <= P_TOL_NOISY, leaf
        assert _rel(port["restore/loss"], ref[f"{name}/next/loss"]) \
            <= LOSS_TOL


def _recorded_step(remat: str, mesh):
    cfg = tsmoke("qwen2-0.5b").replace(param_dtype=torch.float32,
                                       act_dtype=torch.float32, remat=remat)
    tt = TTrain(fsdp=True)
    whole = params_lib.abstract_params(tlm.lm_param_specs(cfg),
                                       torch.float32)
    params = fsdp.shard_tree(whole,
                             param_shardings(tlm.lm_param_specs(cfg), mesh))
    state = {"params": params, "opt": adamw_init(params, tt.optimizer)}
    tok = torch.empty((8, 16), dtype=torch.int32, device="meta")
    _, cost = C.trace_cost(tmake_train_step(cfg, tt, mesh), state,
                           {"inputs": tok, "labels": tok}, mesh=mesh)
    return cfg, cost


def _by_kind(records):
    out = {}
    for kind, _, nb in records:
        e = out.setdefault(kind, {"count": 0, "bytes": 0})
        e["count"] += 1
        e["bytes"] += nb
    return out


@pytest.mark.parametrize("remat", ["full", "none"])
def test_recompute_gathers_every_layer_again(remat):
    """One step's recorded all-gathers and reduce-scatters on a data 2 x
    model 2 ``RecordingMesh`` equal the plan from the placements: the
    leaves outside the layer stack gathered once, each layer's once in
    the forward and, under ``remat="full"``, once more in the backward's
    recompute (so no layer's gathered weights are saved for it); every
    gradient reduced once.  The residual sequence's gathers (site
    ``seq.all_gather``) are ``sharding.seq.seq_collective_plan``'s; the
    in-layer layout's (``tp.*``) are ``sharding.tp``'s, apart."""
    from repro_torch.sharding import seq

    mesh = RecordingMesh((2, 2), ("data", "model"))
    cfg, cost = _recorded_step(remat, mesh)
    plan = fsdp.collective_plan(cfg, mesh, reduce_axes=("data",))
    sites = list(zip(mesh.records, mesh.sites))
    got = _by_kind([r for r, site in sites if site != "seq.all_gather"
                    and not site.startswith("tp.")])
    assert _by_kind([r for r, site in sites if site == "seq.all_gather"])[
        "all-gather"] == seq.seq_collective_plan(cfg, mesh, 8, 16)[
            "all-gather"]
    for kind in ("all-gather", "reduce-scatter"):
        assert got[kind] == plan[kind], kind
    # the gradient all-reduces of the leaves no dimension splits over
    # data (the biases), the loss's over data, the norm's over both axes
    assert got["all-reduce"]["count"] == plan["all-reduce"]["count"] + 3
    assert got["all-reduce"]["bytes"] == plan["all-reduce"]["bytes"] + 12
    specs = tlm.lm_param_specs(cfg)
    # the leaves the in-layer layout runs on their model block keep it
    pl = fsdp.keep_blocks(param_shardings(specs, mesh), cfg)

    def gathered(p, ndim):
        return len([a for a in p.live_axes(ndim) if a not in p.keep])

    layer_gathers = sum(
        gathered(p, len(s.shape) - 1) for (_, p), (_, s) in zip(
            params_lib._leaves(fsdp.layer_placements(pl)),
            params_lib._leaves(specs["blocks"])))
    outside = sum(gathered(p, len(s.shape)) for (path, p), (_, s) in
                  zip(params_lib._leaves(pl), params_lib._leaves(specs))
                  if path[0] != "blocks")
    per_layer = 2 if remat == "full" else 1
    assert got["all-gather"]["count"] == (
        outside + per_layer * cfg.n_layers * layer_gathers)
    assert cost.off_meta == 0


def test_recording_mesh_collectives_record_their_operands():
    mesh = RecordingMesh((2, 4), ("data", "model"))
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    assert mesh_lib.all_gather(t, mesh, "model", 1).shape == (3, 16)
    assert mesh_lib.reduce_scatter(t, mesh, "data", 1).shape == (3, 2)
    with pytest.raises(ValueError, match="does not split"):
        mesh_lib.reduce_scatter(t, mesh, "model", 0)
    assert mesh_lib.all_reduce(t, mesh, "data", op="max") is t
    assert mesh.records == [("all-gather", "model", 48),
                            ("reduce-scatter", "data", 48),
                            ("all-reduce", "data", 48)]


def test_world_of_one_fsdp_is_the_single_device_step_bit_for_bit():
    cfg = tsmoke("qwen2-0.5b").replace(param_dtype=torch.float32,
                                       act_dtype=torch.float32,
                                       sc_backend="pallas_moment")
    batch = make_batch(SyntheticLMData(vocab=cfg.vocab, seq_len=16,
                                       global_batch=4), 0)
    out = []
    for fsdp_on, mesh in ((False, None), (True, make_local_mesh(device="cpu"))):
        tt = TTrain(optimizer=TAdamW(**ranks.base.ADAM,
                                     state_dtype="int8"), fsdp=fsdp_on)
        state = ttrain_state_init(0, cfg, tt, device="cpu", mesh=mesh)
        step = tmake_train_step(cfg, tt, mesh)
        losses = []
        for _ in range(2):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        out.append((losses, ranks.base._flat(state, "s")))
    assert out[0][0] == out[1][0]
    for k, v in out[0][1].items():
        np.testing.assert_array_equal(out[1][1][k], v, err_msg=k)


@pytest.mark.parametrize("backend", ["exact", "pallas_moment"])
def test_the_dense_leaves_keep_their_model_block(backend):
    """qwen2-0.5b at full width, 2 layers, float32 on data 2 x model 2
    (chip_smoke's TM-t): with the in-layer layout on, every dense leaf
    gathers over ``data`` only, so a step's plan gathers nothing over
    ``model``: 34 gathers of 195,788,544 bytes against 71 of 587,342,592
    gathered whole; the reductions run at the same block sizes, and
    SwiGLU's ``wi`` adds its relayout both ways."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen2-0.5b").replace(
        n_layers=2, sc_backend=backend, param_dtype=torch.float32,
        act_dtype=torch.float32)
    mesh = mesh_lib.AbstractMesh((2, 2), ("data", "model"))
    on = fsdp.collective_plan(cfg, mesh, reduce_axes=("data",))
    off = fsdp.collective_plan(cfg, mesh, reduce_axes=("data",),
                               tensor_parallel=False)
    assert off["all-gather"] == {"count": 71, "bytes": 587_342_592}
    assert on["all-gather"] == {"count": 34, "bytes": 195_788_544}
    assert "all-gather:model" not in on["by_axis"]
    assert on["reduce-scatter"] == off["reduce-scatter"]
    wi = 896 * 9728 // 2 * 4  # a rank's block of one layer's wi
    assert on["all-to-all"] == {"count": 2 * (2 + 1), "bytes": 6 * wi}
