"""Both sides of ``tests/test_torch_train_fsdp.py``, run as subprocesses.

    python tests/_torch_train_fsdp_ranks.py ref INPUTS OUT CASE...
        the JAX reference on 4 host devices (the caller sets
        ``XLA_FLAGS=--xla_force_host_platform_device_count=4``), its
        meshes built with Auto axes: for each CASE the mesh train step
        jitted with the state's FSDP ∘ TP shardings as in and out
        shardings (``launch/dryrun.py``'s jit), 3 steps, every device's
        ``addressable_shards`` of ``params``, ``m`` and ``v`` kept by the
        rank at that device's mesh coordinates; the 2x2 ``exact`` case
        also saves its checkpoint (``REF_CKPT``) and takes a fourth step;
    torchrun --standalone --nproc-per-node 4 \\
        tests/_torch_train_fsdp_ranks.py port INPUTS OUT
        the port on 4 gloo ranks of the CPU, each writing OUT.rank<r>:
        the same cases with ``TrainConfig(fsdp=True)``, the gather /
        reduce-scatter gradients of a leaf tree with every kind of
        placement, the int8 state and the compressed gradient against
        the replicated step, a sharded checkpoint (``PORT_CKPT``) and the
        reference's checkpoint restored into shards.

``INPUTS`` is ``tests/test_torch_train_mesh.py``'s ``.npz``: the
reference's ``init_params`` weights as ``params/<path>`` and the
batches.  Each side imports only its own package.
"""

import json
import os
import sys
import time

import numpy as np

import _torch_train_mesh_ranks as base

# (mesh, backend): 3 steps each; the 10-bit operand grid off on the
# stochastic backend (as tests/test_torch_train_mesh.py holds it)
CASES = {
    "2x2/exact": ("2x2", "exact"),
    "2x2/pallas_moment": ("2x2", "pallas_moment"),
    "4x1/exact": ("4x1", "exact"),
    "4x1/pallas_moment": ("4x1", "pallas_moment"),
    "pod/exact": ("pod", "exact"),
    "pod/pallas_moment": ("pod", "pallas_moment"),
}
MESHES = dict(base.MESHES, **{"1x4": ((1, 4), ("data", "model"))})
STEPS = base.STEPS
CKPT_CASE = "2x2/exact"
CKPT_WAIT_S = 300  # how long the ranks wait for the reference checkpoint
# the gather / reduce-scatter leaves: (shape, logical axes); the 2-head
# K/V projection does not split over model = 4 (replicated there)
GRAD_SPECS = {
    "wi": ((8, 16), ("embed", "mlp")),
    "wo": ((16, 8), ("mlp", "embed")),
    "norm": ((8,), ("embed",)),
    "bias": ((16,), ("mlp",)),
    "wk": ((8, 2, 4), ("embed", "kv_heads", "head_dim")),
    "q_norm": ((4,), (None,)),
}
GRAD_MESHES = ("2x2", "1x4", "4x1", "pod")
GRAD_ROWS = 8


def _leaves_of(tree):
    """(path, leaf) pairs of a dict tree in sorted-key order."""
    if not isinstance(tree, dict):
        return [((), tree)]
    return [((k,) + p, v) for k in sorted(tree)
            for p, v in _leaves_of(tree[k])]


def _grid_on(name):
    return CASES[name][1] == "exact"  # the operand grid: on for exact


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------


def _rank_of(mesh, device) -> int:
    """The port's rank at ``device``'s coordinates of ``mesh`` (both lay
    ranks out row-major over the same axes)."""
    coords = np.argwhere(mesh.devices == device)[0]
    return int(np.ravel_multi_index(tuple(coords), mesh.devices.shape))


def _shards(tree, mesh, prefix, out):
    import jax

    from repro.compat import tree_flatten_with_path

    flat, _ = tree_flatten_with_path(tree)
    for path, leaf in flat:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        for s in leaf.addressable_shards:
            r = _rank_of(mesh, s.device)
            out[f"{prefix}/rank{r}/{key}"] = np.asarray(jax.device_get(
                s.data))


def ref_case(name, params, data, out):
    import jax
    import jax.numpy as jnp

    from repro import checkpoint
    from repro.launch import specs as S
    from repro.optim import AdamWConfig, adamw_init
    from repro.sc import encoding
    from repro.train import TrainConfig, make_train_step
    from repro.train.step import make_eval_step

    mesh_name, backend = CASES[name]
    cfg = base._jcfg(backend)
    mesh = base._jmesh(mesh_name)
    tcfg = TrainConfig(optimizer=AdamWConfig(**base.ADAM))
    p_sh = S.param_shardings(cfg, mesh)
    state_sh = {"params": p_sh, "opt": S.opt_shardings(cfg, mesh, p_sh)}
    batch_sh = S.batch_shardings(cfg, mesh, base.BATCH)
    metrics_sh = {"loss": S.replicated(mesh), "grad_norm": S.replicated(mesh),
                  "lr": S.replicated(mesh)}
    params = jax.tree.map(jnp.asarray, params)
    state = jax.device_put(
        {"params": params, "opt": adamw_init(params, tcfg.optimizer)},
        state_sh)
    bs = base.batches(data)
    if backend == "exact":
        out[f"{name}/eval"] = jax.jit(make_eval_step(cfg, mesh))(params,
                                                                 bs[0])
    with base._grid(_grid_on(name), encoding), \
            base._ref_scope(mesh, backend):
        step = jax.jit(make_train_step(cfg, tcfg, mesh),
                       in_shardings=(state_sh, batch_sh),
                       out_shardings=(state_sh, metrics_sh))
        losses = []
        for i in range(STEPS):
            state, m = step(state, bs[i])
            losses.append(float(m["loss"]))
            if i == 0:  # (1 - b1) x the step-1 gradient
                _shards(state["opt"]["m"], mesh, f"{name}/m1", out)
        out[f"{name}/losses"] = np.asarray(losses)
        _shards(state["params"], mesh, f"{name}/params", out)
        _shards(state["opt"]["m"], mesh, f"{name}/m", out)
        _shards(state["opt"]["v"], mesh, f"{name}/v", out)
        if name == CKPT_CASE:
            checkpoint.save(os.environ["REF_CKPT"], STEPS, state,
                            extra={"data_step": STEPS})
            state, m = step(state, bs[STEPS])
            out[f"{name}/next/loss"] = float(m["loss"])
            _shards(state["params"], mesh, f"{name}/next/params", out)


def run_ref(inputs, out, *names):
    import jax

    assert len(jax.devices()) == 4, jax.devices()
    data, params, _ = base.load(inputs)
    res = {}
    for name in names:
        t0 = time.perf_counter()
        ref_case(name, params, data, res)
        res[f"{name}/seconds"] = time.perf_counter() - t0
    np.savez(out, **res)


# ---------------------------------------------------------------------------
# The port, on 4 gloo ranks
# ---------------------------------------------------------------------------


def _placements(cfg, mesh):
    from repro_torch.models import lm
    from repro_torch.sharding import param_shardings

    return param_shardings(lm.lm_param_specs(cfg), mesh)


def _sharded_state(params, cfg, tcfg, mesh):
    """The reference's weights cut to this rank's shards, AdamW state on
    them."""
    from repro_torch.models.params import params_from_numpy
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.fsdp import shard_tree

    p = shard_tree(params_from_numpy(params, device="cpu"),
                   _placements(cfg, mesh))
    return {"params": p, "opt": adamw_init(p, tcfg.optimizer)}


def _nbytes(tree) -> int:
    from repro_torch.models.params import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def port_case(name, meshes, params, data, out, meta):
    from repro_torch import checkpoint
    from repro_torch.optim import AdamWConfig
    from repro_torch.sc import encoding
    from repro_torch.sharding.fsdp import state_placements
    from repro_torch.train import TrainConfig, make_eval_step, make_train_step

    mesh_name, backend = CASES[name]
    cfg = base._tcfg(backend)
    mesh = meshes[mesh_name]
    tcfg = TrainConfig(optimizer=AdamWConfig(**base.ADAM), fsdp=True)
    state = _sharded_state(params, cfg, tcfg, mesh)
    meta[f"{name}/shapes"] = {
        "/".join(p): list(t.shape) for p, t in
        _leaves_of(state["params"])}
    meta[f"{name}/state_bytes"] = _nbytes(state)
    bs = base.batches(data)
    if backend == "exact":
        out[f"{name}/eval"] = make_eval_step(cfg, mesh, fsdp=True)(
            state["params"], bs[0])
    with base._grid(_grid_on(name), encoding):
        step = make_train_step(cfg, tcfg, mesh)
        losses = []
        for i in range(STEPS):
            state, m = step(state, bs[i])
            losses.append(float(m["loss"]))
    out[f"{name}/losses"] = np.asarray(losses)
    out.update(base._flat(state["params"], f"{name}/params"))
    out.update(base._flat(state["opt"]["m"], f"{name}/m"))
    out.update(base._flat(state["opt"]["v"], f"{name}/v"))
    if name == CKPT_CASE:
        checkpoint.save(os.environ["PORT_CKPT"], STEPS, state,
                        extra={"data_step": STEPS},
                        shardings=state_placements(state,
                                                   _placements(cfg, mesh)))
    return state


def port_restore_reference(meshes, params, data, out):
    """The reference's 2x2 checkpoint (written by the ``ref`` process
    the test starts beside this one) restored into this rank's shards,
    and the fourth step from it."""
    from repro_torch import checkpoint
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding.fsdp import state_placements
    from repro_torch.train import TrainConfig, make_train_step

    mesh_name, backend = CASES[CKPT_CASE]
    cfg, mesh = base._tcfg(backend), meshes[mesh_name]
    tcfg = TrainConfig(optimizer=AdamWConfig(**base.ADAM), fsdp=True)
    like = _sharded_state(params, cfg, tcfg, mesh)
    ckpt = os.environ["REF_CKPT"]
    deadline = time.monotonic() + CKPT_WAIT_S
    while checkpoint.latest_step(ckpt) is None:
        if time.monotonic() > deadline:
            raise TimeoutError(f"no reference checkpoint in {ckpt} after "
                               f"{CKPT_WAIT_S} s")
        time.sleep(0.5)
    state, extra, step_no = checkpoint.restore_resharded(
        ckpt, like, state_placements(like, _placements(cfg, mesh)))
    out["restore/step"] = step_no
    out.update(base._flat(state["params"], "restore/shards"))
    state, m = make_train_step(cfg, tcfg, mesh)(
        state, base.batches(data)[extra["data_step"]])
    out["restore/loss"] = m["loss"]
    out.update(base._flat(state["params"], "restore/params"))


def port_gather_grads(meshes, out):
    """``GatherParam``'s gradients against the whole-leaf mean gradient,
    on integer data (every sum exact): the loss of row ``r`` is
    ``sum(x_r * leaf)`` over each leaf, whose gradient of the batch mean
    is the rows' mean; each rank takes its rows of the global batch."""
    import torch

    from repro_torch.launch.mesh import batch_axes
    from repro_torch.models.params import ParamSpec, tree_map
    from repro_torch.sharding import fsdp, param_shardings

    specs = {k: ParamSpec(shape, axes) for k, (shape, axes)
             in GRAD_SPECS.items()}
    gen = torch.Generator().manual_seed(0)
    whole = {k: torch.randint(-4, 5, s.shape, generator=gen).float()
             for k, s in specs.items()}
    rows = {k: torch.randint(-4, 5, (GRAD_ROWS,) + s.shape,
                             generator=gen).float()
            for k, s in specs.items()}
    for mesh_name in GRAD_MESHES:
        mesh = meshes[mesh_name]
        axes = batch_axes(mesh)
        pl = param_shardings(specs, mesh)
        shards = tree_map(
            lambda t, p: p.shard(t).detach().clone().requires_grad_(True),
            whole, pl)
        gathered = fsdp.gather_tree(shards, pl, axes)
        span, d = 1, 0
        for a in axes:
            span, d = span * mesh.shape[a], d * mesh.shape[a] + mesh.coords[a]
        n = GRAD_ROWS // span
        loss = sum((rows[k][d * n:(d + 1) * n] * gathered[k]).sum()
                   for k in specs) / n
        loss.backward()
        for k, p in pl.items():
            want = p.shard(rows[k].mean(0))
            out[f"grad/{mesh_name}/{k}/got"] = shards[k].grad
            out[f"grad/{mesh_name}/{k}/want"] = want
            out[f"grad/{mesh_name}/{k}/gathered"] = gathered[k].detach()


def port_int8_compressed(meshes, params, data, out, meta):
    """pod 2 x data 2 x model 1 with the cross-pod compression and int8
    AdamW state, 2 steps, sharded against replicated: every leaf's int8
    payload, scale and compressed gradient, and whether a leaf's absmax
    lay on one shard (its local absmax below the leaf's on some rank)."""
    import torch

    from repro_torch.distributed import init_error_feedback
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, make_train_step

    mesh = meshes["pod2x2"]
    cfg = base._tcfg("exact")
    pl = _placements(cfg, mesh)
    adam = AdamWConfig(**base.ADAM, state_dtype="int8")
    runs = {}
    for fs in (False, True):
        tcfg = TrainConfig(optimizer=adam, cross_pod_compress=True, fsdp=fs)
        if fs:
            state = _sharded_state(params, cfg, tcfg, mesh)
        else:
            state = base._tstate(params, tcfg)
        state["ef"] = init_error_feedback(state["params"], 2)
        step = make_train_step(cfg, tcfg, mesh)
        grads = []
        for i in range(2):
            _, g, _ = step.loss_and_grads(state, base.batches(data)[i])
            grads.append(g)
            state, _ = step(state, base.batches(data)[i])
        runs[fs] = (state, grads)
    (rstate, rgrads), (sstate, sgrads) = runs[False], runs[True]

    def node(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    local_below = {}
    for path, p in _leaves_of(pl):
        key = "/".join(path)
        for name in ("m", "v"):
            whole, shard = (node(st["opt"][name], path)
                            for st in (rstate, sstate))
            out[f"int8/{key}/{name}/q/got"] = shard["q"]
            out[f"int8/{key}/{name}/q/want"] = p.shard(whole["q"])
            out[f"int8/{key}/{name}/scale/got"] = shard["scale"]
            out[f"int8/{key}/{name}/scale/want"] = whole["scale"]
        for i, (gr, gs) in enumerate(zip(rgrads, sgrads)):
            out[f"int8/{key}/grad{i}/got"] = node(gs, path)
            out[f"int8/{key}/grad{i}/want"] = p.shard(node(gr, path))
        g0 = node(rgrads[0], path)
        local_below[key] = bool(
            torch.abs(node(sgrads[0], path)).max() < torch.abs(g0).max())
    meta["int8_local_below"] = local_below


def run_port(inputs, out):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    data, params, _ = base.load(inputs)
    meshes = {name: _tmesh(name) for name in MESHES}
    rank = meshes["2x2"].rank
    res, meta = {}, {}
    t0 = time.perf_counter()
    for name in CASES:
        port_case(name, meshes, params, data, res, meta)
    meta["cases_s"] = time.perf_counter() - t0
    port_gather_grads(meshes, res)
    port_int8_compressed(meshes, params, data, res, meta)
    port_restore_reference(meshes, params, data, res)
    np.savez(f"{out}.rank{rank}",
             **{k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for k, v in res.items()},
             meta=json.dumps(meta))
    dist.barrier()


def _tmesh(name):
    from repro_torch.launch.mesh import DeviceMesh

    shape, names = MESHES[name]
    return DeviceMesh(shape, names, device="cpu")


if __name__ == "__main__":
    side, inputs, out, *rest = sys.argv[1:]
    {"ref": run_ref, "port": run_port}[side](inputs, out, *rest)
