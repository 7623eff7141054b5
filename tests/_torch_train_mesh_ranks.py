"""Both sides of ``tests/test_torch_train_mesh.py``, run as subprocesses.

    python tests/_torch_train_mesh_ranks.py ref-steps INPUTS OUT CASE...
    python tests/_torch_train_mesh_ranks.py ref-misc INPUTS OUT
        the JAX reference on 4 host devices (the caller sets
        ``XLA_FLAGS=--xla_force_host_platform_device_count=4``), its
        meshes built with Auto axes here: ``make_train_step`` on a mesh
        inside ``sc.use_mesh`` for each CASE (the cases split over two
        processes, so they compile side by side); and the rest:
        ``compressed_grads`` on a gradient with no scan, the compressed
        LM step composed from reference functions, ``param_shardings``'
        shard shapes, and the launcher's mesh losses;
    torchrun --standalone --nproc-per-node 4 \\
        tests/_torch_train_mesh_ranks.py port INPUTS OUT
        the port on 4 gloo ranks of the CPU, each writing OUT.rank<r>.

``INPUTS`` is an ``.npz`` the test writes: the reference's
``init_params`` weights flattened as ``params/<path>``, the port's
launcher weights as ``launch/<path>``, the batches and the operands of
the scan-free gradient.  Each side imports only its own package: the
port side neither ``jax`` nor ``repro``.
"""

import contextlib
import json
import os
import sys

import numpy as np

# (mesh, backend, microbatches, 10-bit operand grid on)
STEP_CASES = {
    "2x2/exact/1": ("2x2", "exact", 1, True),
    "2x2/pallas_moment/1": ("2x2", "pallas_moment", 1, False),
    "2x2/pallas_moment/1/grid": ("2x2", "pallas_moment", 1, True),
    "4x1/exact/1": ("4x1", "exact", 1, True),
    "4x1/pallas_moment/1": ("4x1", "pallas_moment", 1, False),
    "pod/exact/1": ("pod", "exact", 1, True),
    "pod/pallas_moment/1": ("pod", "pallas_moment", 1, False),
    "2x2/exact/2": ("2x2", "exact", 2, True),
    "2x2/pallas_moment/2": ("2x2", "pallas_moment", 2, False),
}
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "pod": ((2, 1, 2), ("pod", "data", "model")),
          "pod2x2": ((2, 2, 1), ("pod", "data", "model"))}
STEPS = 3
BATCH, SEQ = 8, 16
ADAM = dict(lr=1e-3, warmup_steps=2, total_steps=100)
COMPRESS_STEPS = 2
# the scan-free gradient: integer operands, so every sum is exact
LSQ_ROWS, LSQ_K, LSQ_N = 4, 3, 4  # rows a pod
# the launcher's run: torchrun's 4 ranks on a (4, 1) mesh
LAUNCH_STEPS = 3
LAUNCH_ARGS = ["--arch", "qwen2-0.5b", "--smoke", "--steps",
               str(LAUNCH_STEPS), "--batch", str(BATCH), "--seq", str(SEQ),
               "--sc-backend", "pallas_moment", "--ckpt-every", "2"]
SHARD_ARCHS = ("qwen2-0.5b",)  # full width and smoke


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, leaf = path.split("/")
        for p in head:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _flat(tree, prefix: str) -> dict:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def load(path):
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}

    def sub(name):
        return _nest({k[len(name) + 1:]: v for k, v in data.items()
                      if k.startswith(name + "/")})

    return data, sub("params"), sub("launch")


def batches(data):
    return [{"inputs": data[f"batch{i}/inputs"],
             "labels": data[f"batch{i}/labels"]} for i in range(STEPS + 1)]


def lsq_batches(data):
    return [{"x": data[f"lsq{i}/x"], "y": data[f"lsq{i}/y"]}
            for i in range(3)]


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------


def _jmesh(name):
    import jax
    from jax.sharding import AxisType

    shape, names = MESHES[name]
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))


def _jcfg(backend, arch="qwen2-0.5b"):
    import jax.numpy as jnp

    from repro.configs import get_smoke_config

    return get_smoke_config(arch).replace(
        param_dtype=jnp.float32, act_dtype=jnp.float32, sc_backend=backend)


@contextlib.contextmanager
def _grid(on: bool, encoding):
    """The 10-bit operand grid of ``encoding`` (either package's module)
    on, or switched off (``quantize_grid`` the identity)."""
    orig = encoding.quantize_grid
    if not on:
        encoding.quantize_grid = lambda p, levels: p
    try:
        yield
    finally:
        encoding.quantize_grid = orig


def _ref_scope(mesh, backend):
    from repro import sc
    from repro.sharding import sc_shard_rules

    if backend == "exact":
        return contextlib.nullcontext()
    return sc.use_mesh(mesh, sc_shard_rules(mesh))


def _ref_grads(cfg, mesh, params, batch, rng, micro):
    """The mesh step's gradient as ``make_train_step``'s ``grads_of``
    takes it, under the step's constraints."""
    import jax
    import jax.numpy as jnp

    from repro.models import lm
    from repro.train.step import make_constrain, make_param_constrain

    cst, cstp = make_constrain(mesh), make_param_constrain(mesh, cfg)

    def loss(p, b, key):
        return lm.lm_loss(p, b, cfg, rng=key, constrain=cst,
                          constrain_params=cstp)

    def grads(p, b):
        if micro <= 1:
            return jax.value_and_grad(loss)(p, b, rng)
        tot, acc = 0.0, jax.tree.map(jnp.zeros_like, p)
        for i in range(micro):
            mb = jax.tree.map(lambda v: v.reshape(
                (micro, v.shape[0] // micro) + v.shape[1:])[i], b)
            key = None if rng is None else jax.random.fold_in(rng, i)
            li, gi = jax.value_and_grad(loss)(p, mb, key)
            tot, acc = tot + li, jax.tree.map(jnp.add, acc, gi)
        return tot / micro, jax.tree.map(lambda g: g / micro, acc)

    return jax.jit(grads)(params, batch)


def ref_case(name, params, data, ckpt_dir=None):
    import jax
    import jax.numpy as jnp

    from repro import checkpoint
    from repro.optim import AdamWConfig, adamw_init
    from repro.sc import encoding
    from repro.train import TrainConfig, make_train_step
    from repro.train.step import make_eval_step

    mesh_name, backend, micro, grid = STEP_CASES[name]
    cfg = _jcfg(backend)
    mesh = _jmesh(mesh_name)
    tcfg = TrainConfig(optimizer=AdamWConfig(**ADAM), microbatches=micro)
    params = jax.tree.map(jnp.asarray, params)
    state = {"params": params, "opt": adamw_init(params, tcfg.optimizer)}
    bs = batches(data)
    out = {}
    if backend == "exact":  # the eval step draws no key
        out[f"{name}/eval"] = jax.jit(make_eval_step(cfg, mesh))(params,
                                                                 bs[0])
    with _grid(grid, encoding), _ref_scope(mesh, backend):
        rng = None if backend == "exact" else jax.random.fold_in(
            jax.random.PRNGKey(0), 0)
        loss0, g0 = _ref_grads(cfg, mesh, params, bs[0], rng, micro)
        out[f"{name}/grad_loss"] = loss0
        out.update(_flat(g0, f"{name}/grads"))
        step = jax.jit(make_train_step(cfg, tcfg, mesh))
        losses = []
        for i in range(STEPS):
            state, m = step(state, bs[i])
            losses.append(float(m["loss"]))
    out[f"{name}/losses"] = np.asarray(losses)
    out.update(_flat(state["params"], f"{name}/params"))
    if ckpt_dir is not None:
        checkpoint.save(ckpt_dir, STEPS, state, extra={"data_step": STEPS})
    return out


def run_ref_steps(inputs, out, *names):
    import jax

    assert len(jax.devices()) == 4, jax.devices()
    data, params, _ = load(inputs)
    res = {}
    for name in names:
        ckpt = os.environ.get("REF_CKPT") if name == "2x2/exact/1" else None
        res.update(ref_case(name, params, data, ckpt))
    np.savez(out, **res)


def ref_compressed_lsq(data):
    """``compressed_grads`` around a least-squares gradient (no scan) on
    pod 2 x data 2: 3 steps of error feedback.  The gradient is taken
    w.r.t. the parameters cast to pod-varying, so it is the pod's own as
    the wrapper's contract says: differentiating the replicated input
    itself, jax 0.9.0 transposes its implicit broadcast into a ``psum``
    over ``pod``, and every pod would quantize the pods' SUM."""
    import jax
    import jax.numpy as jnp

    from repro.distributed import compression

    mesh = _jmesh("pod2x2")
    w = jnp.asarray(data["lsq/w"])

    def grad_fn(params, batch):
        params = jax.tree.map(
            lambda v: jax.lax.pcast(v, ("pod",), to="varying"), params)

        def loss(p):
            r = batch["x"] @ p["w"] - batch["y"]
            return jnp.mean(r * r)
        return jax.value_and_grad(loss)(params)

    fn = jax.jit(compression.compressed_grads(grad_fn, mesh))
    ef = compression.init_error_feedback({"w": w}, 2)
    out = {}
    for i, b in enumerate(lsq_batches(data)):
        loss, g, ef = fn({"w": w}, jax.tree.map(jnp.asarray, b), ef)
        out[f"lsq/{i}/loss"] = loss
        out[f"lsq/{i}/grad"] = g["w"]
        out[f"lsq/{i}/ef"] = ef["w"]
    return out


def ref_compressed_lm(params, data):
    """The compressed LM step on ``exact`` over 2 pods, composed from the
    reference's functions: each pod's ``value_and_grad(lm_loss)`` on its
    rows, ``_quantize`` with the residual, the mean over the pods,
    ``adamw_update``."""
    import jax
    import jax.numpy as jnp

    from repro.distributed import compression
    from repro.models import lm
    from repro.optim import AdamWConfig, adamw_init, adamw_update

    cfg = _jcfg("exact")
    adam = AdamWConfig(**ADAM)
    params = jax.tree.map(jnp.asarray, params)
    opt = adamw_init(params, adam)
    ef = compression.init_error_feedback(params, 2)
    vg = jax.jit(jax.value_and_grad(lambda p, b: lm.lm_loss(p, b, cfg)))
    half = BATCH // 2
    out = {}
    for i, b in enumerate(batches(data)[:COMPRESS_STEPS]):
        pods = [vg(params, {k: v[p * half:(p + 1) * half]
                            for k, v in b.items()}) for p in range(2)]
        leaves, treedef = jax.tree.flatten(params)
        new_ef, deqs, scales = [], [], []
        for p, (_, g) in enumerate(pods):
            gl = [gg.astype(jnp.float32) + r[p] for gg, r in zip(
                jax.tree.leaves(g), jax.tree.leaves(ef))]
            qs = [compression._quantize(gg) for gg in gl]
            deq = [q.astype(jnp.float32) * s for q, s in qs]
            deqs.append(deq)
            scales.append([s for _, s in qs])
            new_ef.append([gg - d for gg, d in zip(gl, deq)])
        grads = [(a + b_) / 2 for a, b_ in zip(*deqs)]
        ef = jax.tree.unflatten(treedef, [jnp.stack(rows) for rows in
                                          zip(*new_ef)])
        loss = (pods[0][0] + pods[1][0]) / 2
        params, opt, _ = adamw_update(jax.tree.unflatten(treedef, grads),
                                      opt, params, adam)
        out[f"clm/{i}/loss"] = loss
        out.update(_flat(ef, f"clm/{i}/ef"))
        out.update(_flat(jax.tree.unflatten(
            treedef, [jnp.stack(s) for s in zip(*scales)]),
            f"clm/{i}/scale"))
    out.update(_flat(params, "clm/params"))
    return out


def ref_shard_shapes():
    """``NamedSharding(mesh, spec).shard_shape`` of every parameter leaf
    on the 2x2 and the pod meshes, full width and smoke."""
    import jax

    from repro.configs import get_config, get_smoke_config
    from repro.models import lm
    from repro.sharding.rules import param_shardings

    out = {}
    for arch in SHARD_ARCHS:
        for tag, cfg in (("full", get_config(arch)),
                         ("smoke", get_smoke_config(arch))):
            specs = lm.lm_param_specs(cfg)
            for mesh_name in ("2x2", "pod"):
                sh = param_shardings(specs, _jmesh(mesh_name))
                flat_sh = jax.tree.leaves(
                    sh, is_leaf=lambda x: hasattr(x, "shard_shape"))
                flat_sp = jax.tree.leaves(
                    specs, is_leaf=lambda x: hasattr(x, "axes"))
                out[f"{arch}/{tag}/{mesh_name}"] = [
                    list(s.shard_shape(p.shape))
                    for s, p in zip(flat_sh, flat_sp)]
    return out


def ref_launch_losses(launch_params, data):
    """The launcher's run as the reference's mesh step gives it: a
    (4, 1) Auto mesh, the launcher's config, optimizer and batches, and
    the port launcher's initial weights."""
    import jax
    import jax.numpy as jnp

    from repro.data import SyntheticLMData, make_batch
    from repro.optim import AdamWConfig, adamw_init
    from repro.train import TrainConfig, make_train_step

    cfg = _jcfg("pallas_moment")
    mesh = _jmesh("4x1")
    steps = LAUNCH_STEPS
    tcfg = TrainConfig(optimizer=AdamWConfig(
        lr=1e-3, total_steps=steps, warmup_steps=max(steps // 10, 1)))
    params = jax.tree.map(jnp.asarray, launch_params)
    state = {"params": params, "opt": adamw_init(params, tcfg.optimizer)}
    ds = SyntheticLMData(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)
    losses = []
    with _ref_scope(mesh, "pallas_moment"):
        step = jax.jit(make_train_step(cfg, tcfg, mesh))
        for i in range(steps):
            state, m = step(state, make_batch(ds, i))
            losses.append(float(m["loss"]))
    return losses


def run_ref_misc(inputs, out):
    import jax

    assert len(jax.devices()) == 4, jax.devices()
    data, params, launch = load(inputs)
    res = ref_compressed_lsq(data)
    res.update(ref_compressed_lm(params, data))
    meta = {"shard_shapes": ref_shard_shapes(),
            "launch_losses": ref_launch_losses(launch, data)}
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()},
             meta=json.dumps(meta))


# ---------------------------------------------------------------------------
# The port, on 4 gloo ranks
# ---------------------------------------------------------------------------


def _tmesh(name):
    from repro_torch.launch.mesh import DeviceMesh

    shape, names = MESHES[name]
    return DeviceMesh(shape, names, device="cpu")


def _tstate(params, tcfg):
    from repro_torch.models.params import params_from_numpy
    from repro_torch.optim import adamw_init

    p = params_from_numpy(params, device="cpu")
    return {"params": p, "opt": adamw_init(p, tcfg.optimizer)}


def _tcfg(backend, arch="qwen2-0.5b"):
    import torch

    from repro_torch.configs import get_smoke_config

    return get_smoke_config(arch).replace(
        param_dtype=torch.float32, act_dtype=torch.float32,
        sc_backend=backend)


def port_case(name, meshes, params, data):
    from repro_torch.optim import AdamWConfig
    from repro_torch.sc import encoding
    from repro_torch.train import TrainConfig, make_eval_step, make_train_step

    mesh_name, backend, micro, grid = STEP_CASES[name]
    cfg = _tcfg(backend)
    mesh = meshes[mesh_name]
    tcfg = TrainConfig(optimizer=AdamWConfig(**ADAM), microbatches=micro)
    state = _tstate(params, tcfg)
    bs = batches(data)
    out = {}
    if backend == "exact":
        out[f"{name}/eval"] = make_eval_step(cfg, mesh)(state["params"],
                                                        bs[0])
    with _grid(grid, encoding):
        step = make_train_step(cfg, tcfg, mesh)
        loss0, g0, _ = step.loss_and_grads(state, bs[0])
        out[f"{name}/grad_loss"] = loss0
        out.update(_flat(g0, f"{name}/grads"))
        losses = []
        for i in range(STEPS):
            state, m = step(state, bs[i])
            losses.append(float(m["loss"]))
    out[f"{name}/losses"] = np.asarray(losses)
    out.update(_flat(state["params"], f"{name}/params"))
    out.update(_flat(state["opt"], f"{name}/opt"))
    return out, state


def port_compressed_lsq(mesh, data):
    import torch

    from repro_torch.distributed import compressed_grads, init_error_feedback

    w = torch.from_numpy(data["lsq/w"])
    pod = mesh.coords["pod"]

    def grad_fn(params, batch):
        x, y = batch["x"], batch["y"]
        r = x @ params["w"] - y
        return (r * r).mean(), {"w": 2 * x.T @ r / r.numel()}

    fn = compressed_grads(grad_fn, mesh)
    ef = init_error_feedback({"w": w}, mesh.shape["pod"])
    out = {}
    for i, b in enumerate(lsq_batches(data)):
        rows = {k: torch.from_numpy(v[pod * LSQ_ROWS:(pod + 1) * LSQ_ROWS])
                for k, v in b.items()}
        loss, g, ef = fn({"w": w}, rows, ef)
        out[f"lsq/{i}/loss"] = loss
        out[f"lsq/{i}/grad"] = g["w"]
        out[f"lsq/{i}/ef"] = ef["w"]
    return out


def port_compressed_lm(mesh, params, data):
    from repro_torch.distributed import init_error_feedback
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, make_train_step

    tcfg = TrainConfig(optimizer=AdamWConfig(**ADAM), cross_pod_compress=True)
    state = _tstate(params, tcfg)
    step = make_train_step(_tcfg("exact"), tcfg, mesh)
    state["ef"] = init_error_feedback(state["params"], mesh.shape["pod"])
    out = {}
    for i, b in enumerate(batches(data)[:COMPRESS_STEPS]):
        state, m = step(state, b)
        out[f"clm/{i}/loss"] = m["loss"]
        out.update(_flat(state["ef"], f"clm/{i}/ef"))
    out.update(_flat(state["params"], "clm/params"))
    out.update(_flat(state["opt"], "clm/opt"))
    return out


def port_refusals(meshes, params, data):
    """The three refusals, each a ``ValueError`` naming its cause."""
    import torch

    from repro_torch import sc
    from repro_torch.optim import AdamWConfig
    from repro_torch.sc import ctr_rng
    from repro_torch.train import TrainConfig, make_train_step

    got = {}
    tcfg = TrainConfig(optimizer=AdamWConfig(**ADAM), microbatches=3)
    state = _tstate(params, tcfg)
    try:  # 8 rows into 3 microbatches over 2 data ranks
        make_train_step(_tcfg("exact"), tcfg, meshes["2x2"])(
            state, batches(data)[0])
    except ValueError as e:
        got["indivisible"] = str(e)
    tcfg = TrainConfig(optimizer=AdamWConfig(**ADAM), cross_pod_compress=True)
    try:
        make_train_step(_tcfg("exact"), tcfg, meshes["pod2x2"])(
            _tstate(params, tcfg), batches(data)[0])
    except ValueError as e:
        got["no_ef"] = str(e)
    rules = sc.ScShardRules(batch=(), contract=("model",), local_rows=True)
    x, w = torch.ones(4, 8), torch.ones(8, 2)
    try:
        sc.sc_dot_sharded(ctr_rng.prng_key(0), x, w,
                          sc.ScConfig(backend="moment"),
                          mesh=meshes["2x2"], rules=rules)
    except ValueError as e:
        got["row_gather"] = str(e)
    return got


def port_restore(ckpt_dir, state_2x2, meshes, data):
    """Rank 0 saves the 2x2 case's state after its steps; every rank
    restores it on the 4x1 mesh and takes the next step there."""
    from repro_torch import checkpoint
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding import param_shardings
    from repro_torch.train import TrainConfig, make_train_step

    checkpoint.save(ckpt_dir, STEPS, state_2x2, extra={"data_step": STEPS})
    cfg = _tcfg("exact")
    tcfg = TrainConfig(optimizer=AdamWConfig(**ADAM))
    mesh = meshes["4x1"]
    sh = {"params": param_shardings(lm.lm_param_specs(cfg), mesh)}
    state, extra, step_no = checkpoint.restore_resharded(
        ckpt_dir, state_2x2, sh)
    state, m = make_train_step(cfg, tcfg, mesh)(state,
                                                batches(data)[STEPS])
    out = {"restore/loss": m["loss"], "restore/step": step_no}
    out.update(_flat(state["params"], "restore/params"))
    return out


def port_launcher(ckpt_dir):
    """``launch/train.py``'s ``main`` in the torchrun world: a run with a
    failure injected before step index 2 (recovered from rank 0's step-2
    checkpoint), an uninterrupted run, and ``--resume`` of the latter's
    step-2 checkpoint (one step more)."""
    from repro_torch.launch import train as launch_train

    from repro_torch.models.params import _leaves

    args = LAUNCH_ARGS + ["--device", "cpu", "--ckpt-dir"]
    runs = {}
    for name, extra in (("fail", ["/fail", "--inject-failure-at", "2"]),
                        ("full", ["/full"]),
                        ("resumed", ["/full", "--resume"])):
        state, hist = launch_train.main(
            args + [ckpt_dir + extra[0]] + extra[1:])
        runs[name] = [[r["step"], r["loss"]] for r in hist["steps"]]
        if name == "fail":
            runs["recoveries"] = hist["recoveries"]
        # the shapes of what the rank holds after the run
        runs[f"{name}_shapes"] = {
            "/".join(p): list(t.shape) for p, t in _leaves(
                {"params": state["params"], "m": state["opt"]["m"],
                 "v": state["opt"]["v"]})}
    return runs


def run_port(inputs, out):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    data, params, _ = load(inputs)
    meshes = {name: _tmesh(name) for name in MESHES}
    rank = meshes["2x2"].rank
    res = {}
    meta = {}
    for name in STEP_CASES:
        got, state = port_case(name, meshes, params, data)
        res.update(got)
        if name == "2x2/exact/1":
            res.update(port_restore(os.environ["PORT_CKPT"], state, meshes,
                                    data))
    res.update(port_compressed_lsq(meshes["pod2x2"], data))
    res.update(port_compressed_lm(meshes["pod2x2"], params, data))
    meta["refusals"] = port_refusals(meshes, params, data)
    meta["launcher"] = port_launcher(os.environ["PORT_CKPT"] + "_launch")
    np.savez(f"{out}.rank{rank}",
             **{k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for k, v in res.items()},
             meta=json.dumps(meta))
    dist.barrier()


if __name__ == "__main__":
    side, inputs, out, *rest = sys.argv[1:]
    {"ref-steps": run_ref_steps, "ref-misc": run_ref_misc,
     "port": run_port}[side](inputs, out, *rest)
