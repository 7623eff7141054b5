"""PyTorch port vs JAX reference: training on a device mesh.

The reference runs in subprocesses on 4 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``), its meshes
built with Auto axes (its mesh step runs on them on jax 0.9.0; the
launcher's Explicit axes do not); the port runs as 4 gloo ranks of the
CPU under ``torchrun``.  Both sides live in
``tests/_torch_train_mesh_ranks.py`` and start together, beside a
``torchrun -m repro_torch.launch.train`` run.  The same numpy weights
(the reference's ``init_params``) and batches feed both.  Held:

* ``make_train_step`` (and ``make_eval_step`` on ``exact``) on data 2 x
  model 2, data 4 x model 1 and pod 2 x data 1 x model 2, 3 AdamW steps, on ``exact`` and ``pallas_moment``
  (``microbatches`` 2 on the 2x2 mesh too): the loss of every step, the
  step-1 gradient leaves and the parameters after step 3.  Tolerances
  are ``tests/test_torch_train.py``'s: with the 10-bit operand grid off
  in both packages (or on ``exact``), losses 1e-5 relative and gradient
  leaves 1e-4 of their max |value|; the grid-on case 1e-4 and 1e-2 (an
  ulp apart, an operand can cross a grid step).  Parameters after 3
  steps, in units of the learning rate (Adam moves a parameter by about
  lr·sign(g) a step): 1e-2 lr, or 0.1 lr where the step-1 gradient is
  within the gradient tolerance of zero (there the sign is noise); with
  the grid on 0.2 lr and 2 lr a step;
* every rank ends each case with the same bits in every parameter and
  optimizer leaf;
* ``compressed_grads`` bit for bit against the reference's own on a
  scan-free gradient, over 3 error-feedback steps; the compressed LM
  step on ``exact`` (pod 2 x data 2) against one composed from the
  reference's functions: losses to 1e-6, and residuals and parameters
  to 1e-6 of their scale except at the few elements an int8 payload
  rounds the other way (counted; see the test);
* ``param_shardings(...).shard_shape`` equal to ``NamedSharding``'s;
* ``restore_resharded``: a 2x2 checkpoint from rank 0 restored at 4x1
  and in the world of one, the next step against the reference's from
  the same restored state; each package restores the other's checkpoint;
* the launcher under ``torchrun``: the reference's mesh losses, resume,
  recovery on every rank, each rank holding only its FSDP shards;
* the refusals: each a ``ValueError``.
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
from repro.data import SyntheticLMData as JData
from repro.data import make_batch as jmake_batch
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.optim import AdamWConfig as JAdamW
from repro.train import TrainConfig as JTrain
from repro.train import make_train_step as jmake_train_step
from repro.train.step import train_state_init as jtrain_state_init
from repro_torch import checkpoint as tckpt
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.launch.mesh import AbstractMesh, make_local_mesh
from repro_torch.models import lm as tlm
from repro_torch.models.params import _leaves
from repro_torch.optim import AdamWConfig as TAdamW
from repro_torch.sharding import param_shardings
from repro_torch.train import TrainConfig as TTrain
from repro_torch.train import make_train_step as tmake_train_step
from repro_torch.train import train_state_init as ttrain_state_init

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
HELPER = os.path.join(HERE, "_torch_train_mesh_ranks.py")
sys.path.insert(0, HERE)
import _torch_train_mesh_ranks as ranks  # noqa: E402

RANKS = 4
TIMEOUT = 400
LAUNCH_ARCH = ranks.LAUNCH_ARGS[ranks.LAUNCH_ARGS.index("--arch") + 1]
REF_GROUPS = (
    ("2x2/exact/1", "2x2/pallas_moment/1", "2x2/pallas_moment/1/grid",
     "2x2/exact/2", "2x2/pallas_moment/2"),
    ("4x1/exact/1", "4x1/pallas_moment/1", "pod/exact/1",
     "pod/pallas_moment/1"),
)


def _inputs(path):
    jcfg = jsmoke("qwen2-0.5b").replace(param_dtype=jnp.float32,
                                        act_dtype=jnp.float32)
    params = jparams.init_params(
        jax.random.PRNGKey(0), jlm.lm_param_specs(jcfg), jnp.float32)
    flat = ranks._flat(jax.tree.map(np.asarray, params), "params")
    tcfg = tsmoke("qwen2-0.5b").replace(param_dtype=torch.float32,
                                        act_dtype=torch.float32)
    launch = ttrain_state_init(0, tcfg, TTrain(), device="cpu")["params"]
    flat.update(ranks._flat(launch, "launch"))
    data = JData(vocab=jcfg.vocab, seq_len=ranks.SEQ,
                 global_batch=ranks.BATCH)
    for i in range(ranks.STEPS + 1):
        for k, v in jmake_batch(data, i).items():
            flat[f"batch{i}/{k}"] = np.asarray(v)
    rng = np.random.default_rng(0)
    f32 = np.float32
    flat["lsq/w"] = rng.integers(-3, 4, (ranks.LSQ_K, ranks.LSQ_N)).astype(f32)
    for i in range(3):
        flat[f"lsq{i}/x"] = rng.integers(
            -3, 4, (2 * ranks.LSQ_ROWS, ranks.LSQ_K)).astype(f32)
        flat[f"lsq{i}/y"] = rng.integers(
            -9, 10, (2 * ranks.LSQ_ROWS, ranks.LSQ_N)).astype(f32)
    np.savez(path, **flat)
    return launch


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_mesh")
    inputs = str(tmp / "inputs.npz")
    _inputs(inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PORT_CKPT=str(tmp / "port_ckpt"),
               REF_CKPT=str(tmp / "ref_ckpt"))
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                f"--nproc-per-node={RANKS}"]
    procs = {
        "port": subprocess.Popen(
            torchrun + [HELPER, "port", inputs, str(tmp / "port")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            start_new_session=True),
        "cli": subprocess.Popen(
            torchrun + ["-m", "repro_torch.launch.train"]
            + ranks.LAUNCH_ARGS
            + ["--device", "cpu", "--ckpt-dir", str(tmp / "cli_ckpt")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            start_new_session=True),
        "ref-misc": subprocess.Popen(
            [sys.executable, HELPER, "ref-misc", inputs,
             str(tmp / "ref_misc.npz")],
            env=jenv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            start_new_session=True),
    }
    for i, group in enumerate(REF_GROUPS):
        procs[f"ref-steps{i}"] = subprocess.Popen(
            [sys.executable, HELPER, "ref-steps", inputs,
             str(tmp / f"ref_steps{i}.npz"), *group],
            env=jenv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            start_new_session=True)
    outs = {}
    try:
        for name, p in procs.items():
            out, _ = p.communicate(timeout=TIMEOUT)
            outs[name] = out.decode()
            assert p.returncode == 0, f"{name}:\n{outs[name][-4000:]}"
    finally:  # a failed side leaves no process behind (torchrun's ranks
        # are in its process group)
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    ref = {}
    for i in range(len(REF_GROUPS)):
        ref.update(_load(tmp / f"ref_steps{i}.npz"))
    misc = _load(tmp / "ref_misc.npz")
    ref.update({k: v for k, v in misc.items() if k != "meta"})
    port = [_load(tmp / f"port.rank{r}.npz") for r in range(RANKS)]
    return dict(ref=ref, ref_meta=json.loads(str(misc["meta"])), port=port,
                port_meta=[json.loads(str(p["meta"])) for p in port],
                cli=outs["cli"], tmp=tmp, inputs=_load(inputs))


def _rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


def _arrays(d):
    return {k: v for k, v in d.items() if k != "meta"}


def test_every_rank_holds_the_same_bits(runs):
    first = _arrays(runs["port"][0])
    for other in runs["port"][1:]:
        other = _arrays(other)
        assert sorted(other) == sorted(first)
        for k in first:
            np.testing.assert_array_equal(other[k], first[k], err_msg=k)
    metas = runs["port_meta"]
    assert all(m == metas[0] for m in metas[1:])


def _tols(name):
    """(loss, gradient, parameter, parameter where the step-1 gradient
    is noise): the first two as ``tests/test_torch_train.py`` holds
    them, the parameter ones in units of the learning rate."""
    _, backend, _, grid = ranks.STEP_CASES[name]
    if grid and backend != "exact":
        return 1e-4, 1e-2, 0.2, 2.0 * ranks.STEPS
    return 1e-5, 1e-4, 1e-2, 0.1


@pytest.mark.parametrize("name", list(ranks.STEP_CASES))
def test_mesh_train_step_matches_reference(runs, name):
    port, ref = runs["port"][0], runs["ref"]
    loss_tol, grad_tol, p_tol, p_tol_noisy = _tols(name)
    for got, want in zip(port[f"{name}/losses"], ref[f"{name}/losses"]):
        assert _rel(got, want) <= loss_tol, (got, want)
    assert _rel(port[f"{name}/grad_loss"], ref[f"{name}/grad_loss"]) \
        <= loss_tol
    if f"{name}/eval" in ref:  # make_eval_step on the same mesh
        assert _rel(port[f"{name}/eval"], ref[f"{name}/eval"]) <= loss_tol
        assert _rel(port[f"{name}/eval"], port[f"{name}/grad_loss"]) <= 1e-6
    grads = [k for k in ref if k.startswith(f"{name}/grads/")]
    assert len(grads) == sum(k.startswith("params/")
                             for k in runs["inputs"])
    lr = ranks.ADAM["lr"]
    for k in grads:
        g, want = port[k], ref[k]
        scale = np.abs(want).max()
        assert np.abs(g - want).max() <= grad_tol * scale, k
        # Adam moves a parameter by about lr·sign(g) a step: its error is
        # measured in units of lr, and where the step-1 gradient is
        # within the gradient tolerance of zero that sign is noise
        pk = k.replace("/grads/", "/params/")
        noisy = np.abs(want) <= grad_tol * scale
        err = np.abs(port[pk] - ref[pk]) / lr
        assert err[~noisy].max(initial=0) <= p_tol, pk
        assert err.max() <= p_tol_noisy, pk


def test_compressed_grads_bit_equal_reference(runs):
    port, ref = runs["port"][0], runs["ref"]
    for i in range(3):
        for what in ("loss", "grad", "ef"):
            k = f"lsq/{i}/{what}"
            np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    ef = port["lsq/2/ef"]
    assert ef.shape == (2, ranks.LSQ_K, ranks.LSQ_N)
    assert np.abs(ef).max() > 0


def test_compressed_lm_step_matches_composed_reference(runs):
    """Losses within 1e-6.  The two packages' pod gradients agree to a
    few 1e-6 of their max (sums in another order), so an element at a
    half-quantum boundary can round to either int8 value: its residual
    then differs by up to a quantum, at this step and the next ones.
    Everywhere else each step's residual is within 1e-5 of its leaf's
    int8 range (127 quanta) of the reference's.  The flipped elements
    are counted (at most 1e-3 of them); the parameters are within 1e-6
    of their leaf's max |value| plus 1e-2 lr everywhere else (Adam
    divides by |g| + eps, so where a gradient is near eps its step
    feels the last places, as in ``test_mesh_train_step_matches_
    reference``), and within Adam's 2·lr a step at a flipped element."""
    port, ref = runs["port"][0], runs["ref"]
    steps = ranks.COMPRESS_STEPS
    for i in range(steps):
        assert _rel(port[f"clm/{i}/loss"], ref[f"clm/{i}/loss"]) <= 1e-6
    flipped, n_flips, n_elems = {}, 0, 0
    for i in range(steps):
        for k in [k for k in ref if k.startswith(f"clm/{i}/ef/")]:
            leaf = k[len(f"clm/{i}/ef/"):]
            got, want = port[k], ref[k]
            assert got.shape == want.shape and got.shape[0] == 2
            quantum = np.broadcast_to(ref[f"clm/{i}/scale/{leaf}"].reshape(
                (2,) + (1,) * (want.ndim - 1)), want.shape)
            d = np.abs(got - want)
            flip = d > 1e-5 * 127 * quantum
            assert np.all(d <= quantum * (1 + 1e-5)), k
            flipped[leaf] = flipped.get(leaf, False) | flip.any(0)
    for leaf, mask in flipped.items():
        n_flips += int(mask.sum())
        n_elems += mask.size
    assert n_flips <= 1e-3 * n_elems, (n_flips, n_elems)
    lr = ranks.ADAM["lr"]
    for leaf, mask in flipped.items():
        got, want = port[f"clm/params/{leaf}"], ref[f"clm/params/{leaf}"]
        err = np.abs(got - want)
        assert err[~mask].max(initial=0) <= 1e-6 * np.abs(want).max() \
            + 1e-2 * lr, leaf
        assert err.max() <= 2 * lr * steps, leaf


@pytest.mark.parametrize("tag", ["full", "smoke"])
def test_param_shardings_shard_shapes_equal_reference(runs, tag):
    want = runs["ref_meta"]["shard_shapes"]
    for arch in ranks.SHARD_ARCHS:
        cfg = (tget_config if tag == "full" else tsmoke)(arch)
        specs = tlm.lm_param_specs(cfg)
        flat_specs = [p for _, p in _leaves(specs)]
        for mesh_name in ("2x2", "pod"):
            shape, names = ranks.MESHES[mesh_name]
            sh = param_shardings(specs, AbstractMesh(shape, names))
            got = [list(s.shard_shape(p.shape)) for (_, s), p in zip(
                _leaves(sh), flat_specs)]
            assert got == want[f"{arch}/{tag}/{mesh_name}"], mesh_name


def test_restore_resharded_and_the_next_step(runs):
    """Rank 0's 2x2 checkpoint restored at 4x1 (in the ranks) and in the
    world of one (here): the next step against the reference's from the
    same restored state; the reference restores the port's checkpoint
    and the port the reference's."""
    port, tmp = runs["port"][0], runs["tmp"]
    jcfg = jsmoke("qwen2-0.5b").replace(param_dtype=jnp.float32,
                                        act_dtype=jnp.float32)
    tcfg = tsmoke("qwen2-0.5b").replace(param_dtype=torch.float32,
                                        act_dtype=torch.float32)
    jt = JTrain(optimizer=JAdamW(**ranks.ADAM))
    tt = TTrain(optimizer=TAdamW(**ranks.ADAM))
    jstate_like = jtrain_state_init(jax.random.PRNGKey(0), jcfg, jt)
    jstate, _, step_no = jckpt.restore(str(tmp / "port_ckpt"), jstate_like)
    assert step_no == ranks.STEPS == int(port["restore/step"])
    batch = ranks.batches(runs["inputs"])[ranks.STEPS]
    jstate, jm = jax.jit(jmake_train_step(jcfg, jt))(jstate, batch)
    assert _rel(port["restore/loss"], jm["loss"]) <= 1e-5
    tlike = ttrain_state_init(0, tcfg, tt, device="cpu")
    mesh = make_local_mesh(device="cpu")
    sh = {"params": param_shardings(tlm.lm_param_specs(tcfg), mesh)}
    tstate, _, _ = tckpt.restore_resharded(str(tmp / "port_ckpt"), tlike, sh)
    tstate, tm = tmake_train_step(tcfg, tt, mesh)(tstate, batch)
    assert _rel(tm["loss"], jm["loss"]) <= 1e-5
    for k, want in ranks._flat(jax.tree.map(np.asarray, jstate["params"]),
                               "restore/params").items():
        scale = np.abs(want).max()
        assert np.abs(port[k] - want).max() <= 1e-5 * scale + 1e-6, k
    got1 = ranks._flat(tstate["params"], "restore/params")
    for k in got1:
        np.testing.assert_allclose(got1[k], port[k], rtol=0,
                                   atol=1e-5 * np.abs(port[k]).max() + 1e-6)
    # the port restores the reference's own 2x2 checkpoint
    ref_state, _, _ = tckpt.restore(str(tmp / "ref_ckpt"), tlike)
    for k, want in ranks._flat(ref_state["params"], "2x2/exact/1/params"
                               ).items():
        np.testing.assert_array_equal(want, runs["ref"][k], err_msg=k)


def test_launcher_under_torchrun_gives_the_reference_mesh_losses(runs):
    want = runs["ref_meta"]["launch_losses"]
    printed = [line for line in runs["cli"].splitlines()
               if line.startswith("step ")]
    # rank 0 alone prints: step 1 and the summary line
    assert len(printed) == 1, runs["cli"][-2000:]
    assert sum("done: first loss" in line
               for line in runs["cli"].splitlines()) == 1
    meta = runs["port_meta"][0]["launcher"]
    full = dict((s, l) for s, l in meta["full"])
    assert sorted(full) == list(range(1, ranks.LAUNCH_STEPS + 1))
    for s, w in enumerate(want, start=1):
        # the 10-bit operand grid is on: test_torch_train.py's 1e-4
        assert _rel(full[s], w) <= 1e-4, (s, full[s], w)
    first = float(printed[0].split()[3])
    assert abs(first - want[0]) <= 1e-3


def test_launcher_resumes_and_recovers_on_every_rank(runs):
    metas = [m["launcher"] for m in runs["port_meta"]]
    full = dict((s, l) for s, l in metas[0]["full"])
    for m in metas:
        assert m["recoveries"] == [[2, 2]]
        assert dict((s, l) for s, l in m["fail"]) == full
        assert m["resumed"] == [[ranks.LAUNCH_STEPS, full[ranks.LAUNCH_STEPS]]]


def test_launcher_ranks_hold_their_shards(runs):
    """``launch/train.py`` runs the FSDP ∘ TP layout: after the start,
    the recovered and the resumed run, each rank holds the shard shape
    of every parameter, ``m`` and ``v`` leaf on the (4, 1) mesh, which
    splits every leaf with an embed dimension four ways."""
    cfg = tsmoke(LAUNCH_ARCH).replace(param_dtype=torch.float32)
    specs = tlm.lm_param_specs(cfg)
    sh = param_shardings(specs, AbstractMesh((RANKS, 1), ("data", "model")))
    want = {"/".join(p): list(s.shard_shape(sp.shape)) for (p, s), (_, sp)
            in zip(_leaves(sh), _leaves(specs))}
    assert want["embed/table"] == [cfg.vocab, cfg.d_model // 4]
    for meta in runs["port_meta"]:
        for name in ("fail", "full", "resumed"):
            got = meta["launcher"][f"{name}_shapes"]
            for what in ("params", "m", "v"):
                assert {k[len(what) + 1:]: v for k, v in got.items()
                        if k.startswith(what + "/")} == want, (name, what)


@pytest.mark.parametrize("what", ["indivisible", "no_ef", "row_gather"])
def test_refusals_raise_value_error(runs, what):
    got = runs["port_meta"][0]["refusals"]
    assert what in got, got
    assert {"indivisible": "does not split", "no_ef": "error-feedback",
            "row_gather": "row gather"}[what] in got[what]


def test_world_of_one_is_the_single_device_step_bit_for_bit():
    cfg = tsmoke("qwen2-0.5b").replace(param_dtype=torch.float32,
                                       act_dtype=torch.float32,
                                       sc_backend="pallas_moment")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jmake_batch(
        JData(vocab=cfg.vocab, seq_len=16, global_batch=4), 0).items()}
    for micro in (1, 2):
        tt = TTrain(optimizer=TAdamW(**ranks.ADAM), microbatches=micro)
        out = []
        for mesh in (None, make_local_mesh(device="cpu")):
            state = ttrain_state_init(0, cfg, tt, device="cpu")
            step = tmake_train_step(cfg, tt, mesh)
            losses = []
            for _ in range(2):
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
            out.append((losses, ranks._flat(state, "s")))
        assert out[0][0] == out[1][0]
        for k, v in out[0][1].items():
            np.testing.assert_array_equal(out[1][1][k], v, err_msg=k)


def test_constrain_checks_the_rank_rows_and_changes_no_value():
    from repro_torch.train.step import make_constrain, make_param_constrain

    cfg = tsmoke("qwen2-0.5b")
    assert make_constrain(None) is None
    assert make_param_constrain(None, cfg) is None
    cst = make_constrain(AbstractMesh((2, 2), ("data", "model")))
    assert cst.axis_sizes == {"data": 2, "model": 2}
    v = torch.zeros(4, 3)
    assert cst(v, "batch", None) is v  # no rows set: no check
    cst.batch = 4
    assert cst(v, "batch", None) is v
    assert cst(torch.zeros(8, 3), None, "batch") is not None
    with pytest.raises(ValueError, match="rows of the batch"):
        cst(torch.zeros(8, 3), "batch", None)
    tree = {"w": v}
    assert make_param_constrain(AbstractMesh((2, 2), ("data", "model")),
                                cfg)(tree) is tree
