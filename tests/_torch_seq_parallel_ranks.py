"""Both sides of ``tests/test_torch_seq_parallel.py``, run as subprocesses.

    python tests/_torch_seq_parallel_ranks.py ref INPUTS OUT
        the JAX reference on 4 host devices (the caller sets
        ``XLA_FLAGS=--xla_force_host_platform_device_count=4``): for
        each family the mesh train step ``make_train_step(cfg, tcfg,
        mesh)`` on a data 2 x model 2 mesh built with Auto axes (its
        ``make_constrain`` lays the residual sequence over ``model``),
        ``STEPS`` steps on ``exact``, and the same with
        ``ACT_RULES["resid_seq"]`` None (the sequence whole between
        layers); and ``lm.decode_step`` unsharded
        over each decode case's teacher-forced steps;
    torchrun --standalone --nproc-per-node 4 \\
        tests/_torch_seq_parallel_ranks.py port INPUTS OUT
        the port on 4 gloo ranks of the CPU, each writing OUT.rank<r>:
        every family's mesh train step with and without the sequence
        layout (``make_constrain(..., seq_parallel=False)``; both with
        ``tensor_parallel=False``, every in-layer tensor whole), on the
        replicated and FSDP layouts, on ``exact`` and ``pallas_moment``;
        and each decode case on the rank's block of the cache.

``INPUTS`` is an ``.npz`` the test writes: each family's reference
weights (``<arch>/params/<path>``), the token batches, and each decode
case's cache, tokens and lengths.  Each side imports only its own
package.
"""

import contextlib
import json
import sys
import time

import numpy as np

from _torch_train_mesh_ranks import ADAM, _flat, _nest

ARCHS = ("qwen2-0.5b", "mamba2-370m", "zamba2-7b")
BACKENDS = ("exact", "pallas_moment")
LAYOUTS = ("replicated", "fsdp")
MESH = ((2, 2), ("data", "model"))
BATCH, SEQ, STEPS = 4, 16, 2
# decode cases: (arch, global batch, max_len, fills, steps); on 2 x 2 a
# batch of 4 keeps its rows over data and its sequence over model (two
# blocks of 16: row 0 and 2 cross 16, row 1 never reaches block 1); a
# batch of 1 leaves data unused and its sequence splits over data x
# model (four blocks of 8: 6 -> 10 crosses 8, blocks 2 and 3 stay empty)
DECODE = {
    "dense/2x2": ("qwen2-0.5b", 4, 32, (13, 5, 15, 9), 4),
    "dense/b1": ("qwen2-0.5b", 1, 32, (6,), 4),
    "hybrid/2x2": ("zamba2-7b", 4, 32, (13, 5, 15, 9), 4),
}


def decode_cfg_kw(arch):
    return dict(sc_backend="exact")


def train_cfg_kw(backend):
    return dict(sc_backend=backend, remat="full")


def _case(arch, layout, backend, sp):
    return f"{arch}/{layout}/{backend}/{'sp' if sp else 'whole'}"


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


def _jcfg(arch, **kw):
    import jax.numpy as jnp

    from repro.configs import get_smoke_config

    return get_smoke_config(arch).replace(
        param_dtype=jnp.float32, act_dtype=jnp.float32, **kw)


@contextlib.contextmanager
def _resid_seq(on: bool):
    """The reference's ``ACT_RULES["resid_seq"]`` as it ships
    (``model``) while ``on``, else None: its mesh step with the residual
    sequence whole between layers (the rule its ``make_constrain``
    reads at trace time)."""
    from repro.sharding import rules

    orig = rules.ACT_RULES["resid_seq"]
    rules.ACT_RULES["resid_seq"] = orig if on else None
    try:
        yield
    finally:
        rules.ACT_RULES["resid_seq"] = orig


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
    mesh = jax.make_mesh(*MESH, axis_types=(AxisType.Auto,) * 2)
    tcfg = TrainConfig(optimizer=AdamWConfig(**ADAM))
    for arch, sp in ((a, sp) for a in ARCHS for sp in (True, False)):
        t0 = time.perf_counter()
        cfg = _jcfg(arch, **train_cfg_kw("exact"))
        params = jax.tree.map(jnp.asarray, _sub(data, f"{arch}/params"))
        state = {"params": params, "opt": adamw_init(params, tcfg.optimizer)}
        with _resid_seq(sp):
            step = jax.jit(make_train_step(cfg, tcfg, mesh))
            losses = []
            for b in batches(data):
                state, m = step(state, b)
                losses.append(float(m["loss"]))
        tag = "sp" if sp else "whole"
        res[f"train/{arch}/{tag}/losses"] = np.asarray(losses)
        res[f"train/{arch}/{tag}/seconds"] = time.perf_counter() - t0
    for name, (arch, _, _, _, steps) in DECODE.items():
        cfg = _jcfg(arch, **decode_cfg_kw(arch))
        params = jax.tree.map(jnp.asarray, _sub(data, f"{arch}/params"))
        cache = jax.tree.map(jnp.asarray, _sub(data, f"{name}/cache"))
        lengths = jnp.asarray(data[f"{name}/lengths"])
        fn = jax.jit(lambda p, c, t, n: lm.decode_step(p, c, t, n, cfg))
        for i in range(steps):
            logits, cache = fn(params, cache,
                               jnp.asarray(data[f"{name}/tokens"][i]),
                               lengths)
            res[f"decode/{name}/logits{i}"] = np.asarray(logits)
            lengths = lengths + 1
    np.savez(out, **res)


# ---------------------------------------------------------------------------
# The port, on 4 gloo ranks
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def whole_sequence(on: bool):
    """``make_train_step`` built with ``make_constrain(...,
    seq_parallel=False)`` (the sequence whole between layers) while
    ``on``; either way with ``tensor_parallel=False``: the sequence
    layouts are held with every in-layer tensor whole (the layout they
    came with; the in-layer layout is
    ``tests/test_torch_tensor_parallel.py``'s)."""
    import functools

    from repro_torch.train import step as step_mod

    orig = step_mod.make_constrain
    step_mod.make_constrain = functools.partial(
        orig, seq_parallel=not on, tensor_parallel=False)
    try:
        yield
    finally:
        step_mod.make_constrain = orig


def _tcfg(arch, **kw):
    import torch

    from repro_torch.configs import get_smoke_config

    return get_smoke_config(arch).replace(
        param_dtype=torch.float32, act_dtype=torch.float32, **kw)


def port_train(mesh, data, res, meta):
    from repro_torch.models import lm
    from repro_torch.models.params import params_from_numpy
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.sharding import fsdp, param_shardings
    from repro_torch.train import TrainConfig, make_train_step

    for arch in ARCHS:
        whole = params_from_numpy(_sub(data, f"{arch}/params"), device="cpu")
        for backend in BACKENDS:
            cfg = _tcfg(arch, **train_cfg_kw(backend))
            for layout in LAYOUTS:
                tcfg = TrainConfig(optimizer=AdamWConfig(**ADAM),
                                   fsdp=layout == "fsdp")
                for sp in (False, True):
                    t0 = time.perf_counter()
                    params = whole
                    if tcfg.fsdp:
                        params = fsdp.shard_tree(whole, param_shardings(
                            lm.lm_param_specs(cfg), mesh))
                    state = {"params": params,
                             "opt": adamw_init(params, tcfg.optimizer)}
                    with whole_sequence(not sp):
                        step = make_train_step(cfg, tcfg, mesh)
                    losses = []
                    for b in batches(data):
                        state, m = step(state, b)
                        losses.append(float(m["loss"]))
                    name = _case(arch, layout, backend, sp)
                    res[f"{name}/losses"] = np.asarray(losses)
                    res.update(_flat(state, f"{name}/state"))
                    meta[f"{name}/seconds"] = time.perf_counter() - t0


def port_decode(mesh, data, res, meta):
    import torch

    from repro_torch.models import lm
    from repro_torch.models.params import params_from_numpy
    from repro_torch.train.step import make_constrain

    for name, (arch, batch, max_len, _, steps) in DECODE.items():
        cfg = _tcfg(arch, **decode_cfg_kw(arch))
        params = params_from_numpy(_sub(data, f"{arch}/params"),
                                   device="cpu")
        cst = make_constrain(mesh, tensor_parallel=False)
        blk = cst.lay_out_cache(batch, max_len)
        dp = mesh.shape["data"] if batch % mesh.shape["data"] == 0 else 1
        rows = slice(mesh.coords["data"] * batch // dp,
                     (mesh.coords["data"] + 1) * batch // dp) \
            if dp > 1 else slice(0, batch)
        cst.batch = rows.stop - rows.start
        whole = _sub(data, f"{name}/cache")

        def cut(path, v):
            v = torch.from_numpy(np.ascontiguousarray(v))[:, rows]
            if path[0] in ("k", "v", "shared_k", "shared_v"):
                v = v[:, :, blk.start:blk.stop]
            return v.clone()

        cache = {k: ({kk: cut((k, kk), vv) for kk, vv in v.items()}
                     if isinstance(v, dict) else cut((k,), v))
                 for k, v in whole.items()}
        lengths = torch.from_numpy(data[f"{name}/lengths"][rows])
        meta[f"decode/{name}/block"] = [blk.start, blk.stop, list(blk.axes)]
        meta[f"decode/{name}/rows"] = [rows.start, rows.stop]
        with torch.no_grad():
            for i in range(steps):
                tokens = torch.from_numpy(data[f"{name}/tokens"][i][rows])
                logits, cache = lm.decode_step(params, cache, tokens,
                                               lengths, cfg, constrain=cst)
                res[f"decode/{name}/logits{i}"] = logits
                lengths = lengths + 1


def run_port(inputs, out):
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import DeviceMesh

    torch.set_num_threads(1)
    data = load(inputs)
    mesh = DeviceMesh(*MESH, device="cpu")
    res, meta = {}, {"coords": mesh.coords}
    t0 = time.perf_counter()
    port_train(mesh, data, res, meta)
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
