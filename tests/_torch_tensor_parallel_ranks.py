"""Both sides of ``tests/test_torch_tensor_parallel.py``, run as
subprocesses.

    python tests/_torch_tensor_parallel_ranks.py ref INPUTS OUT
        the JAX reference on 4 host devices (the caller sets
        ``XLA_FLAGS=--xla_force_host_platform_device_count=4``): each
        train case's mesh step ``make_train_step(cfg, tcfg, mesh)`` on
        ``exact`` under its shipped ``ACT_RULES`` (heads / kv_heads /
        mlp / vocab / ssm_inner over ``model``, the context-parallel
        branch where the heads do not divide), on a mesh built with Auto
        axes, ``STEPS`` steps; and ``lm.decode_step`` unsharded over each
        decode case's teacher-forced steps;
    torchrun --standalone --nproc-per-node 4 \\
        tests/_torch_tensor_parallel_ranks.py port INPUTS OUT
        the port on 4 gloo ranks of the CPU, each writing OUT.rank<r>:
        every train case with and without the in-layer layout
        (``make_constrain(..., tensor_parallel=False)``), on the
        replicated and FSDP layouts, on ``exact`` and ``pallas_moment``:
        the step-1 loss and gradient, the step-2 loss, the encoder's
        output (replicated); and each decode case on the rank's heads
        block (a whole cache) or its SSM state block
        (``cst.lay_out_cache``).

``INPUTS`` is an ``.npz`` the test writes: each config's reference
weights (``<name>/params/<path>``), the token batches, and each decode
case's cache, tokens and lengths.  Each side imports only its own
package.
"""

import contextlib
import json
import sys
import time

import numpy as np

from _torch_train_mesh_ranks import ADAM, _flat, _nest

# name -> (arch, config overrides); "dense_cp" has 6 heads of 16 (2 kv
# heads): 6 % 4 != 0 takes the context-parallel branch on model 4
CONFIGS = {
    "dense": ("qwen2-0.5b", {}),
    "ssm": ("mamba2-370m", {}),
    "hybrid": ("zamba2-7b", {}),
    "dense_cp": ("qwen2-0.5b", {"n_heads": 6, "head_dim": 16}),
}
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
# train cases: (config, mesh)
TRAIN = (("dense", "2x2"), ("ssm", "2x2"), ("hybrid", "2x2"),
         ("dense_cp", "1x4"))
BACKENDS = ("exact", "pallas_moment")
LAYOUTS = ("replicated", "fsdp")
BATCH, SEQ, STEPS = 4, 16, 2
# decode cases on 2 x 2: (config, global batch, max_len, fills, steps,
# layout): "heads" decodes on a whole cache (the attention on the rank's
# heads block), "state" lays the cache out (``lay_out_cache``: the SSM
# state's heads block, the shared attention's K/V sequence block)
DECODE = {
    "dense/heads": ("dense", 4, 32, (13, 5, 15, 9), 4, "heads"),
    "ssm/state": ("ssm", 4, 32, (13, 5, 15, 9), 4, "state"),
    "hybrid/state": ("hybrid", 4, 32, (13, 5, 15, 9), 4, "state"),
}


def _case(name, mesh, layout, backend, tp):
    return f"{name}/{mesh}/{layout}/{backend}/{'tp' if tp else 'whole'}"


def batches(data):
    return [{"inputs": data[f"batch{i}/inputs"],
             "labels": data[f"batch{i}/labels"]} for i in range(STEPS)]


def _sub(data, prefix):
    return _nest({k[len(prefix) + 1:]: v for k, v in data.items()
                  if k.startswith(prefix + "/")})


def load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------


def jax_cfg(name, **kw):
    import jax.numpy as jnp

    from repro.configs import get_smoke_config

    arch, over = CONFIGS[name]
    return get_smoke_config(arch).replace(
        param_dtype=jnp.float32, act_dtype=jnp.float32, **over, **kw)


def run_ref(inputs, out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.models import lm
    from repro.optim import AdamWConfig, adamw_init
    from repro.train import TrainConfig, make_train_step

    assert len(jax.devices()) == 4, jax.devices()
    data = load(inputs)
    res = {}
    tcfg = TrainConfig(optimizer=AdamWConfig(**ADAM))
    for name, mesh_tag in TRAIN:
        t0 = time.perf_counter()
        mesh = jax.make_mesh(MESHES[mesh_tag], ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        cfg = jax_cfg(name, sc_backend="exact", remat="full")
        params = jax.tree.map(jnp.asarray, _sub(data, f"{name}/params"))
        state = {"params": params, "opt": adamw_init(params, tcfg.optimizer)}
        step = jax.jit(make_train_step(cfg, tcfg, mesh))
        losses = []
        for b in batches(data):
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        res[f"train/{name}/{mesh_tag}/losses"] = np.asarray(losses)
        res[f"train/{name}/{mesh_tag}/seconds"] = time.perf_counter() - t0
    for case, (name, _, _, _, steps, _) in DECODE.items():
        cfg = jax_cfg(name, sc_backend="exact")
        params = jax.tree.map(jnp.asarray, _sub(data, f"{name}/params"))
        cache = jax.tree.map(jnp.asarray, _sub(data, f"{case}/cache"))
        lengths = jnp.asarray(data[f"{case}/lengths"])
        fn = jax.jit(lambda p, c, t, n: lm.decode_step(p, c, t, n, cfg))
        for i in range(steps):
            logits, cache = fn(params, cache,
                               jnp.asarray(data[f"{case}/tokens"][i]),
                               lengths)
            res[f"decode/{case}/logits{i}"] = np.asarray(logits)
            lengths = lengths + 1
    np.savez(out, **res)


# ---------------------------------------------------------------------------
# The port, on 4 gloo ranks
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def layout(tensor_parallel: bool):
    """``make_train_step`` built with ``make_constrain(...,
    tensor_parallel=tensor_parallel)``."""
    import functools

    from repro_torch.train import step as step_mod

    orig = step_mod.make_constrain
    step_mod.make_constrain = functools.partial(
        orig, tensor_parallel=tensor_parallel)
    try:
        yield
    finally:
        step_mod.make_constrain = orig


def torch_cfg(name, **kw):
    import torch

    from repro_torch.configs import get_smoke_config

    arch, over = CONFIGS[name]
    return get_smoke_config(arch).replace(
        param_dtype=torch.float32, act_dtype=torch.float32, **over, **kw)


def _encode(mesh, cfg, params, batch, tp):
    """The encoder's output of this rank's rows of ``batch`` under the
    mesh step's constraint and SC scope (the step's rng for step 0)."""
    import dataclasses

    import torch

    from repro_torch import sc
    from repro_torch.models import lm
    from repro_torch.sc import ctr_rng
    from repro_torch.sharding import sc_shard_rules
    from repro_torch.train.step import make_constrain, shard_batch

    cst = make_constrain(mesh, tensor_parallel=tp)
    rows = shard_batch(batch, mesh)
    cst.batch = rows["inputs"].shape[0]
    rng = ctr_rng.fold_in(ctr_rng.prng_key(0), 0)
    rules = dataclasses.replace(sc_shard_rules(mesh), local_rows=True)
    with sc.use_mesh(mesh, rules), torch.no_grad():
        return lm.encode(params, torch.as_tensor(rows["inputs"]), cfg,
                         rng=rng, constrain=cst)


def port_train(meshes, data, res, meta):
    from repro_torch.models import lm
    from repro_torch.models.params import params_from_numpy
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.sharding import fsdp, param_shardings
    from repro_torch.train import TrainConfig, make_train_step

    bs = batches(data)
    for name, mesh_tag in TRAIN:
        mesh = meshes[mesh_tag]
        whole = params_from_numpy(_sub(data, f"{name}/params"), device="cpu")
        for backend in BACKENDS:
            cfg = torch_cfg(name, sc_backend=backend, remat="full")
            for lay in LAYOUTS:
                tcfg = TrainConfig(optimizer=AdamWConfig(**ADAM),
                                   fsdp=lay == "fsdp")
                params = whole
                if tcfg.fsdp:
                    params = fsdp.shard_tree(whole, param_shardings(
                        lm.lm_param_specs(cfg), mesh))
                for tp in (False, True):
                    t0 = time.perf_counter()
                    state = {"params": params,
                             "opt": adamw_init(params, tcfg.optimizer)}
                    with layout(tp):
                        step = make_train_step(cfg, tcfg, mesh)
                    # step 1 in its two parts, to keep its gradient
                    loss, grads, ef = step.loss_and_grads(state, bs[0])
                    state, _ = step.apply(state, grads, ef)
                    _, m = step(state, bs[1])
                    case = _case(name, mesh_tag, lay, backend, tp)
                    res[f"{case}/losses"] = np.asarray(
                        [float(loss), float(m["loss"])])
                    res.update(_flat(grads, f"{case}/grads"))
                    if lay == "replicated":
                        res.update(_flat(state["params"], f"{case}/params1"))
                        if backend != "exact":
                            res[f"{case}/encode"] = _encode(
                                mesh, cfg, whole, bs[0], tp)
                    meta[f"{case}/seconds"] = time.perf_counter() - t0


def _cut_cache(whole, rows, blk, hb, ib):
    """This rank's rows of a whole decode cache; the K/V sequence cut to
    ``blk`` and the SSM state / ``conv_x`` to the heads / ``d_inner``
    blocks ``hb`` / ``ib`` where given."""
    import torch

    def cut(path, v):
        v = torch.from_numpy(np.ascontiguousarray(v))[:, rows]
        if blk is not None and path[0] in ("k", "v", "shared_k",
                                           "shared_v"):
            v = v[:, :, blk.start:blk.stop]
        if hb is not None and path[-1] == "state":
            v = v[:, :, hb.start:hb.stop]
        if ib is not None and path[-1] == "conv_x":
            v = v[..., ib.start:ib.stop]
        return v.clone()

    return {k: ({kk: cut((k, kk), vv) for kk, vv in v.items()}
                if isinstance(v, dict) else cut((k,), v))
            for k, v in whole.items()}


def port_decode(mesh, data, res, meta):
    import torch

    from repro_torch.models import lm
    from repro_torch.models.params import params_from_numpy
    from repro_torch.train.step import make_constrain

    for case, (name, batch, max_len, _, steps, lay) in DECODE.items():
        cfg = torch_cfg(name, sc_backend="exact")
        params = params_from_numpy(_sub(data, f"{name}/params"),
                                   device="cpu")
        cst = make_constrain(mesh)
        blk = cst.lay_out_cache(batch, max_len) if lay == "state" else None
        hb = ib = None
        if lay == "state":
            hb = cst.state.block(cfg.ssm_heads)
            ib = cst.state.block(cfg.d_inner)
        dp = mesh.shape["data"]
        d = mesh.coords["data"]
        rows = slice(d * batch // dp, (d + 1) * batch // dp)
        cst.batch = rows.stop - rows.start
        cache = _cut_cache(_sub(data, f"{case}/cache"), rows, blk, hb, ib)
        meta[f"decode/{case}/rows"] = [rows.start, rows.stop]
        if "ssm" in cache:
            meta[f"decode/{case}/state_bytes"] = sum(
                t.numel() * t.element_size() for t in cache["ssm"].values())
        lengths = torch.from_numpy(data[f"{case}/lengths"][rows])
        with torch.no_grad():
            for i in range(steps):
                tokens = torch.from_numpy(data[f"{case}/tokens"][i][rows])
                logits, cache = lm.decode_step(params, cache, tokens,
                                               lengths, cfg, constrain=cst)
                res[f"decode/{case}/logits{i}"] = logits
                lengths = lengths + 1


def run_port(inputs, out):
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import DeviceMesh

    torch.set_num_threads(1)
    data = load(inputs)
    meshes = {tag: DeviceMesh(shape, ("data", "model"), device="cpu")
              for tag, shape in MESHES.items()}
    mesh = meshes["2x2"]
    res, meta = {}, {"coords": {t: m.coords for t, m in meshes.items()}}
    t0 = time.perf_counter()
    port_train(meshes, data, res, meta)
    meta["train_s"] = time.perf_counter() - t0
    port_decode(mesh, data, res, meta)
    np.savez(f"{out}.rank{mesh.rank}",
             **{k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for k, v in res.items()},
             meta=json.dumps(meta))
    dist.barrier()


if __name__ == "__main__":
    side, inputs, out = sys.argv[1:]
    {"ref": run_ref, "port": run_port}[side](inputs, out)
