"""Both sides of ``tests/test_torch_expert_parallel.py``, run as
subprocesses.

    python tests/_torch_expert_parallel_ranks.py ref INPUTS OUT
        the JAX reference on 4 host devices (the caller sets
        ``XLA_FLAGS=--xla_force_host_platform_device_count=4``): each
        MoE smoke config's mesh step ``make_train_step(cfg, tcfg, mesh)``
        on ``exact`` under its shipped rules (``"experts"`` over
        ``model``, the capacity buffers constrained to ``("batch",
        "experts", ...)``), on a data 2 x model 2 mesh built with Auto
        axes, ``STEPS`` steps;
    torchrun --standalone --nproc-per-node 4 \\
        tests/_torch_expert_parallel_ranks.py port INPUTS OUT
        the port on 4 gloo ranks of the CPU, each writing OUT.rank<r>:
        every config's mesh step with and without the expert-parallel
        layout (``make_constrain(..., tensor_parallel=False)``), on the
        replicated and FSDP layouts, on ``exact`` and ``pallas_moment``:
        the step-1 loss and gradient, the step-2 loss, the parameters
        after step 1 and the encoder's output (replicated); and a
        ``pallas_bitexact`` prefill of the rank's rows and greedy
        ``decode_step`` under the layout and with it off.

``INPUTS`` is an ``.npz`` the test writes: each config's reference
weights (``<name>/params/<path>``), the token batches and the prompts.
Each side imports only its own package.
"""

import json
import sys
import time

import numpy as np

from _torch_tensor_parallel_ranks import (
    _case,
    _encode,
    _sub,
    batches,
    layout,
    load,
)
from _torch_train_mesh_ranks import ADAM, _flat

# name -> arch: moonshot's smoke config (8 experts, top-2) and
# llama4-maverick's (8 experts, top-1, a shared expert)
CONFIGS = {"moonshot": "moonshot-v1-16b-a3b",
           "maverick": "llama4-maverick-400b-a17b"}
MESH = (2, 2)
BACKENDS = ("exact", "pallas_moment")
LAYOUTS = ("replicated", "fsdp")
BATCH, SEQ, STEPS = 4, 16, 2
# the pallas_bitexact serving case: one layer, nbit 32 (the plain
# version's Threefry bits are the CPU's cost; the layouts' bits agree at
# any nbit), SERVE_ROWS rows a data rank, a prompt of SERVE_PROMPT tokens
# and SERVE_STEPS greedy decode steps
SERVE_LAYERS, SERVE_NBIT = 1, 32
SERVE_ROWS, SERVE_PROMPT, SERVE_STEPS = 1, 4, 2
SERVE_SEED = 5


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------


def jax_cfg(name, **kw):
    import jax.numpy as jnp

    from repro.configs import get_smoke_config

    return get_smoke_config(CONFIGS[name]).replace(
        param_dtype=jnp.float32, act_dtype=jnp.float32, **kw)


def run_ref(inputs, out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.optim import AdamWConfig, adamw_init
    from repro.train import TrainConfig, make_train_step

    assert len(jax.devices()) == 4, jax.devices()
    data = load(inputs)
    res = {}
    tcfg = TrainConfig(optimizer=AdamWConfig(**ADAM))
    mesh = jax.make_mesh(MESH, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    for name in CONFIGS:
        t0 = time.perf_counter()
        cfg = jax_cfg(name, sc_backend="exact", remat="full")
        params = jax.tree.map(jnp.asarray, _sub(data, f"{name}/params"))
        state = {"params": params, "opt": adamw_init(params, tcfg.optimizer)}
        step = jax.jit(make_train_step(cfg, tcfg, mesh))
        losses = []
        for b in batches(data):
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        res[f"train/{name}/losses"] = np.asarray(losses)
        res[f"train/{name}/seconds"] = time.perf_counter() - t0
    np.savez(out, **res)


# ---------------------------------------------------------------------------
# The port, on 4 gloo ranks
# ---------------------------------------------------------------------------


def torch_cfg(name, **kw):
    import torch

    from repro_torch.configs import get_smoke_config

    return get_smoke_config(CONFIGS[name]).replace(
        param_dtype=torch.float32, act_dtype=torch.float32, **kw)


def case(name, lay, backend, ep):
    return _case(name, "2x2", lay, backend, ep)


def port_train(mesh, data, res, meta):
    from repro_torch.models import lm
    from repro_torch.models.params import params_from_numpy
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.sharding import fsdp, param_shardings
    from repro_torch.train import TrainConfig, make_train_step

    bs = batches(data)
    for name in CONFIGS:
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
                for ep in (False, True):
                    t0 = time.perf_counter()
                    state = {"params": params,
                             "opt": adamw_init(params, tcfg.optimizer)}
                    with layout(ep):
                        step = make_train_step(cfg, tcfg, mesh)
                    loss, grads, ef = step.loss_and_grads(state, bs[0])
                    state, _ = step.apply(state, grads, ef)
                    _, m = step(state, bs[1])
                    c = case(name, lay, backend, ep)
                    res[f"{c}/losses"] = np.asarray(
                        [float(loss), float(m["loss"])])
                    res.update(_flat(grads, f"{c}/grads"))
                    if lay == "replicated":
                        res.update(_flat(state["params"], f"{c}/params1"))
                        if backend != "exact":
                            res[f"{c}/encode"] = _encode(
                                mesh, cfg, whole, bs[0], ep)
                    meta[f"{c}/seconds"] = time.perf_counter() - t0


def port_serve(mesh, data, res, meta):
    """``pallas_bitexact`` prefill of the rank's rows and greedy decode,
    under ``sc.use_mesh`` as the mesh engine serves, with the layout on
    and off."""
    import dataclasses

    import torch

    from repro_torch import sc
    from repro_torch.models import lm
    from repro_torch.models.params import params_from_numpy
    from repro_torch.sc import ctr_rng
    from repro_torch.sharding import sc_shard_rules
    from repro_torch.train.step import make_constrain

    d = mesh.coords["data"]
    rows = slice(d * SERVE_ROWS, (d + 1) * SERVE_ROWS)
    max_len = SERVE_PROMPT + SERVE_STEPS
    rules = dataclasses.replace(sc_shard_rules(mesh), local_rows=True)
    for name in CONFIGS:
        cfg = torch_cfg(name, sc_backend="pallas_bitexact",
                        sc_nbit=SERVE_NBIT, n_layers=SERVE_LAYERS)
        params = params_from_numpy(_sub(data, f"{name}/params"),
                                   device="cpu")
        params["blocks"] = _layer_cut(params["blocks"], SERVE_LAYERS)
        prompt = torch.from_numpy(data[f"serve/{name}/prompt"][rows])
        for ep in (False, True):
            t0 = time.perf_counter()
            cst = make_constrain(mesh, tensor_parallel=ep)
            cst.batch = SERVE_ROWS
            tag = f"serve/{name}/{'ep' if ep else 'whole'}"
            with sc.use_mesh(mesh, rules), torch.no_grad():
                logits, cache, lengths = lm.prefill(
                    params, prompt, cfg, max_len,
                    rng=ctr_rng.prng_key(SERVE_SEED), constrain=cst)
                res[f"{tag}/prefill"] = logits
                for i in range(SERVE_STEPS):
                    tok = logits.argmax(-1)
                    res[f"{tag}/tokens{i}"] = tok
                    logits, cache = lm.decode_step(
                        params, cache, tok, lengths, cfg,
                        rng=ctr_rng.prng_key(SERVE_SEED + 1 + i),
                        constrain=cst)
                    res[f"{tag}/logits{i}"] = logits
                    lengths = lengths + 1
            meta[f"{tag}/seconds"] = time.perf_counter() - t0


def _layer_cut(tree, n):
    if isinstance(tree, dict):
        return {k: _layer_cut(v, n) for k, v in tree.items()}
    return tree[:n]


def run_port(inputs, out):
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import DeviceMesh

    torch.set_num_threads(1)
    data = load(inputs)
    mesh = DeviceMesh(MESH, ("data", "model"), device="cpu")
    res, meta = {}, {"coords": mesh.coords}
    t0 = time.perf_counter()
    port_train(mesh, data, res, meta)
    meta["train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    port_serve(mesh, data, res, meta)
    meta["serve_s"] = time.perf_counter() - t0
    np.savez(f"{out}.rank{mesh.rank}",
             **{k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for k, v in res.items()},
             meta=json.dumps(meta))
    dist.barrier()


if __name__ == "__main__":
    side, inputs, out = sys.argv[1:]
    {"ref": run_ref, "port": run_port}[side](inputs, out)
