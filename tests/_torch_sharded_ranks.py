"""Both sides of ``tests/test_torch_sharded_mesh.py``, run as subprocesses.

    python tests/_torch_sharded_ranks.py ref INPUTS OUT
    python tests/_torch_sharded_ranks.py ref-engine INPUTS OUT
        the JAX reference on 4 host devices (the caller sets
        ``XLA_FLAGS=--xla_force_host_platform_device_count=4``), its
        meshes built with Auto axes here: the ``sc_dot_sharded`` cases,
        and the mesh engine on ``pallas_bitexact`` (two processes, so
        they compile side by side);
    torchrun --standalone --nproc-per-node 4 \\
        tests/_torch_sharded_ranks.py port INPUTS OUT
        the port on 4 gloo ranks of the CPU, each writing OUT.rank<r>.

``INPUTS`` is an ``.npz`` the test writes: the operands, and the
reference's ``init_params`` weights flattened as ``params/<path>``.
Both sides compute the same cases, named alike: ``sc_dot_sharded`` on
the 2x2, 4x1 and 1x4 meshes (``pallas_fused``, ``moment`` twice,
``pallas_bitexact``), rules naming no live axis, the straight-through
gradients, one ``array`` call's record and fault census, and the greedy
tokens of the mesh ``ServingEngine`` at data 2 x model 2 with 4 slots on
``pallas_bitexact`` and ``exact`` (the reference's ``exact`` engine
enters no mesh scope, so the test runs it in its own process).  Each side imports only its own
package: the port side neither ``jax`` nor ``repro``.
"""

import json
import sys

import numpy as np

MESHES = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}
ENGINE_BACKENDS = ("pallas_bitexact", "exact")
# At d_model 32 (4 heads of 8, 2 KV heads) every dense call of the
# 2x2-mesh engine takes one of three per-rank (K, N) shapes, (16, 16),
# (16, 32) and (16, 64), and 4-token prompts shard their rows as a
# 4-slot decode step does: so the reference traces four interpret-mode
# kernels, not nine.
SMALL = dict(d_model=32, d_ff=32, vocab=64)
PROMPT = 4
FAULT_PROFILE = "tiny"


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, leaf = path.split("/")
        for p in head:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _load(path):
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    params = _nest({k[len("params/"):]: v for k, v in data.items()
                    if k.startswith("params/")})
    return data, params


def _requests(data):
    return [dict(rid=i, prompt=p.tolist(), max_new_tokens=3)
            for i, p in enumerate(data["prompts"])]


def run_ref(inputs, out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro import arch, obs, sc
    from repro.arch.accounting import report_dict
    from repro.core import physics

    assert len(jax.devices()) == 4, jax.devices()
    data, params = _load(inputs)
    key = jax.random.PRNGKey(0)
    x, w = jnp.asarray(data["x"]), jnp.asarray(data["w"])
    meshes = {
        name: jax.make_mesh(shape, ("data", "model"),
                            axis_types=(AxisType.Auto, AxisType.Auto))
        for name, shape in MESHES.items()
    }
    res = {}
    for name, mesh in meshes.items():
        for backend, nbit in (("pallas_fused", 64), ("moment", 1 << 16)):
            cfg = sc.ScConfig(backend=backend, nbit=nbit)
            res[f"{backend}/{name}"] = sc.sc_dot_sharded(key, x, w, cfg,
                                                         mesh=mesh)
    trivial = sc.ScShardRules(batch=("data",), contract=())
    for backend, nbit in (("pallas_fused", 64), ("moment", 1 << 16)):
        cfg = sc.ScConfig(backend=backend, nbit=nbit)
        res[f"trivial/{backend}"] = sc.sc_dot_sharded(
            key, x, w, cfg, mesh=meshes["1x4"], rules=trivial)
    cfg_m = sc.ScConfig(backend="moment", nbit=1 << 16)

    def loss(x, w):
        return sc.sc_dot_sharded(key, x, w, cfg_m, mesh=meshes["2x2"]).sum()

    res["grad/x"], res["grad/w"] = jax.grad(loss, (0, 1))(x, w)

    prof = physics.resolve_profile(FAULT_PROFILE)
    # the census reads the profile's cell maps, which cannot be built
    # from inside the shard_map trace: build (and cache) them first
    physics.cell_maps(prof)
    cfg_a = sc.ScConfig(backend="array", nbit=1024, device=prof)
    reg = obs.enable()
    with arch.collect() as recs:
        sc.sc_dot_sharded(key, jnp.asarray(data["xa"]),
                          jnp.asarray(data["wa"]), cfg_a,
                          mesh=meshes["2x2"])
    (rec,) = recs
    census = {k: reg.value("arch_bit_errors_total", kind=k,
                           shard=str(rec.shards))
              for k in ("stuck0", "stuck1", "retention")}
    obs.disable()
    meta = {"record": {"shards": rec.shards, "shape": list(rec.shape),
                       "report": report_dict(rec.report),
                       "effective": report_dict(rec.effective_report)},
            "census": census}
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()},
             meta=json.dumps(meta))


def ref_engine_tokens(params, data, backend, mesh):
    """The reference's mesh ``ServingEngine`` on ``backend``: greedy
    tokens by request id.  (On ``exact`` the engine enters no mesh
    scope, so an ``AbstractMesh`` serves in the caller's process.)"""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config
    from repro.serve import Request, ServeOptions, build_engine
    from repro.sharding import sc_shard_rules

    cfg = get_smoke_config("qwen2-0.5b").replace(
        param_dtype=jnp.float32, act_dtype=jnp.float32,
        sc_backend=backend, sc_nbit=32, **SMALL)
    eng = build_engine(
        jax.tree.map(jnp.asarray, params), cfg,
        ServeOptions(mesh=True, slots=4, max_len=24),
        mesh=mesh, shard_rules=sc_shard_rules(mesh))
    for r in _requests(data):
        eng.submit(Request(**r))
    return {str(r.rid): list(r.generated) for r in eng.run_until_drained()}


def run_ref_engine(inputs, out):
    import jax
    from jax.sharding import AxisType

    assert len(jax.devices()) == 4, jax.devices()
    data, params = _load(inputs)
    mesh = jax.make_mesh(MESHES["2x2"], ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    tokens = ref_engine_tokens(params, data, "pallas_bitexact", mesh)
    with open(out, "w") as f:
        json.dump(tokens, f)


def run_port(inputs, out):
    import torch

    from repro_torch import arch, obs, sc
    from repro_torch.arch.accounting import report_dict
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import physics
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.params import params_from_numpy
    from repro_torch.sc import ctr_rng
    from repro_torch.serve import Request, ServeOptions, build_engine
    from repro_torch.sharding import sc_shard_rules

    torch.set_num_threads(1)
    data, params = _load(inputs)
    key = ctr_rng.prng_key(0)
    x, w = torch.from_numpy(data["x"]), torch.from_numpy(data["w"])
    meshes = {name: make_local_mesh(shape[1], device="cpu")
              for name, shape in MESHES.items()}
    rank = meshes["2x2"].rank
    res = {}
    for name, mesh in meshes.items():
        for backend, nbit in (("pallas_fused", 64), ("moment", 1 << 16),
                              ("pallas_bitexact", 64)):
            cfg = sc.ScConfig(backend=backend, nbit=nbit)
            res[f"{backend}/{name}"] = sc.sc_dot_sharded(key, x, w, cfg,
                                                         mesh=mesh)
        cfg = sc.ScConfig(backend="moment", nbit=1 << 16)
        res[f"moment_again/{name}"] = sc.sc_dot_sharded(key, x, w, cfg,
                                                        mesh=mesh)
    trivial = sc.ScShardRules(batch=("data",), contract=())
    for backend, nbit in (("pallas_fused", 64), ("moment", 1 << 16)):
        cfg = sc.ScConfig(backend=backend, nbit=nbit)
        res[f"trivial/{backend}"] = sc.sc_dot_sharded(
            key, x, w, cfg, mesh=meshes["1x4"], rules=trivial)
        res[f"single/{backend}"] = sc.sc_dot(key, x, w, cfg)

    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    cfg_m = sc.ScConfig(backend="moment", nbit=1 << 16)
    sc.sc_dot_sharded(key, xg, wg, cfg_m, mesh=meshes["2x2"]).sum().backward()
    res["grad/x"], res["grad/w"] = xg.grad, wg.grad

    prof = physics.resolve_profile(FAULT_PROFILE)
    cfg_a = sc.ScConfig(backend="array", nbit=1024, device=prof)
    reg = obs.enable()
    with arch.collect() as recs:
        sc.sc_dot_sharded(key, torch.from_numpy(data["xa"]),
                          torch.from_numpy(data["wa"]), cfg_a,
                          mesh=meshes["2x2"])
    (rec,) = recs
    census = {k: reg.value("arch_bit_errors_total", kind=k,
                           shard=str(rec.shards))
              for k in ("stuck0", "stuck1", "retention")}
    obs.disable()
    meta = {"record": {"shards": rec.shards, "shape": list(rec.shape),
                       "report": report_dict(rec.report),
                       "effective": report_dict(rec.effective_report)},
            "census": census, "tokens": {}}

    mesh = meshes["2x2"]
    tp = params_from_numpy(params, device="cpu")
    for backend in ENGINE_BACKENDS:
        cfg = get_smoke_config("qwen2-0.5b").replace(
            param_dtype=torch.float32, act_dtype=torch.float32,
            sc_backend=backend, sc_nbit=32, **SMALL)
        eng = build_engine(
            tp, cfg, ServeOptions(mesh=True, slots=4, max_len=24),
            device="cpu", mesh=mesh, shard_rules=sc_shard_rules(mesh))
        for r in _requests(data):
            eng.submit(Request(**r))
        meta["tokens"][backend] = {
            str(r.rid): list(r.generated) for r in eng.run_until_drained()}
    np.savez(f"{out}.rank{rank}",
             **{k: v.detach().numpy() for k, v in res.items()},
             meta=json.dumps(meta))


if __name__ == "__main__":
    side, inputs, out = sys.argv[1:4]
    {"ref": run_ref, "ref-engine": run_ref_engine,
     "port": run_port}[side](inputs, out)
