"""PyTorch port vs JAX reference: the mesh-sharded SC substrate's pure
functions and scopes, in one process.

The rules (``resolve_rules``, ``shard_counts``, ``sc_shard_rules``,
``logical_rules``, ``act_spec``, ``param_partition_specs`` /
``partition_specs``) and the sharded workload pricing (``shard_site``,
``price_workload_sharded``) against the reference's over a grid of mesh
sizes and shapes: the reference reads ``jax.sharding.AbstractMesh``
(sizes without devices), the port its own ``AbstractMesh``; a
reference ``PartitionSpec`` is held as the tuple of its entries.  Then
the ``use_mesh`` / ``shard_scope`` stacks, the ``array`` backend's
shard stamp and census inside a shard scope, the trivial mesh of a
world of one (exactly ``sc_dot``, and the engine's tokens unchanged),
and the serve options and slot checks.  The multi-rank path is
``tests/test_torch_sharded_mesh.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro import arch as jarch
from repro import obs as jobs
from repro import sc as jsc
from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.core import physics as jphysics
from repro.launch import mesh as jmesh
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.serve import ServeOptions as JaxOptions
from repro.sharding import rules as jrules
from repro_torch import arch as tarch
from repro_torch import obs as tobs
from repro_torch import sc as tsc
from repro_torch.configs import get_config as torch_config
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core import physics as tphysics
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams
from repro_torch.sc import ctr_rng
from repro_torch.serve import Request, ServeOptions, build_engine
from repro_torch.sharding import rules as trules

MESHES = [
    ((1, 1), ("data", "model")),
    ((2, 2), ("data", "model")),
    ((4, 1), ("data", "model")),
    ((1, 4), ("data", "model")),
    ((2, 4), ("data", "model")),
    ((16, 16), ("data", "model")),
    ((2, 16, 16), ("pod", "data", "model")),
    ((2, 1, 4), ("pod", "data", "model")),
    ((3, 2), ("pod", "model")),
]


def _meshes(sizes, names):
    return JaxAbstractMesh(sizes, names), tmesh.AbstractMesh(sizes, names)


def _ids(meshes):
    return ["x".join(map(str, s)) + "-" + "".join(n[0] for n in a)
            for s, a in meshes]


@pytest.mark.parametrize("sizes, names", MESHES, ids=_ids(MESHES))
def test_resolve_rules_and_shard_counts_equal_reference(sizes, names):
    jm, tm = _meshes(sizes, names)
    rules = [
        None,
        (("data",), ()),
        (("pod", "data"), ("model",)),
        (("model",), ("data",)),
        (("nope",), ("missing", "model")),
        (("data", "pod"), ("model", "data")),
    ]
    for m in (1, 2, 3, 4, 6, 8, 12, 32, 64):
        for k in (1, 4, 6, 16, 896, 4864):
            for r in rules:
                jr = tr = None
                if r is not None:
                    jr = jsc.ScShardRules(batch=r[0], contract=r[1])
                    tr = tsc.ScShardRules(batch=r[0], contract=r[1])
                want = jsc.resolve_rules(jm, m, k, jr)
                got = tsc.resolve_rules(tm, m, k, tr)
                assert (got.batch, got.contract) == (
                    want.batch, want.contract), (m, k, r)
                assert tsc.shard_counts(tm, m, k, tr) == jsc.shard_counts(
                    jm, m, k, jr)


@pytest.mark.parametrize("sizes, names", MESHES, ids=_ids(MESHES))
def test_sc_shard_rules_and_mesh_sizes_equal_reference(sizes, names):
    jm, tm = _meshes(sizes, names)
    for kw in ({}, dict(batch=("data",)), dict(contract=("data", "model")),
               dict(batch=("pod", "data", "x"), contract=())):
        want = jrules.sc_shard_rules(jm, **kw)
        got = trules.sc_shard_rules(tm, **kw)
        assert (got.batch, got.contract) == (want.batch, want.contract)
    assert tmesh.mesh_axis_sizes(tm) == jmesh.mesh_axis_sizes(jm)
    assert tmesh.data_parallel_size(tm) == jmesh.data_parallel_size(jm)


@pytest.mark.parametrize("sizes, names", MESHES, ids=_ids(MESHES))
def test_logical_rules_and_act_spec_equal_reference(sizes, names):
    jm, tm = _meshes(sizes, names)
    for kind in ("param", "act"):
        assert trules.logical_rules(tm, kind) == jrules.logical_rules(
            jm, kind)
    axes = [a for a in trules.ACT_RULES if a is not None] + [None, "nope"]
    for i, a in enumerate(axes):
        for b in axes[i:]:
            want = tuple(jrules.act_spec(jm, a, b))
            assert trules.act_spec(tm, a, b) == want, (a, b)
    assert trules.PARAM_RULES == jrules.PARAM_RULES
    assert trules.ACT_RULES == jrules.ACT_RULES


def _spec_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], path + (k,))
    else:
        yield path, tuple(tree)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_partition_specs_equal_reference(arch):
    jspecs = jlm.lm_param_specs(jax_config(arch))
    tspecs = tlm.lm_param_specs(torch_config(arch))
    for sizes, names in MESHES:
        jm, tm = _meshes(sizes, names)
        want = dict(_spec_leaves(jrules.param_partition_specs(jspecs, jm)))
        got = dict(_spec_leaves(trules.param_partition_specs(tspecs, tm)))
        assert got == want, (arch, sizes)
    # partition_specs on a hand-made rules dict with a tuple axis
    rules = {"embed": ("pod", "data"), "mlp": "model",
             "__sizes__": {"pod": 2, "data": 3, "model": 4}}
    want = dict(_spec_leaves(jparams.partition_specs(jspecs, rules)))
    got = dict(_spec_leaves(tparams.partition_specs(tspecs, rules)))
    assert got == want


@pytest.mark.parametrize("tokens", [1, 7, 64])
def test_sharded_workload_pricing_equals_reference(tokens):
    js = jarch.dense_workload(jax_config("qwen2-0.5b"), tokens)
    ts = tarch.dense_workload(torch_config("qwen2-0.5b"), tokens)
    for data, model in ((1, 1), (2, 2), (4, 1), (1, 4), (3, 5), (16, 16)):
        assert [dataclasses.asdict(tarch.shard_site(s, data, model))
                for s in ts] == [
            dataclasses.asdict(jarch.shard_site(s, data, model)) for s in js]
        jper, jtot = jarch.price_workload_sharded(js, 1024, data=data,
                                                  model=model)
        tper, ttot = tarch.price_workload_sharded(ts, 1024, data=data,
                                                  model=model)
        assert tarch.report_dict(ttot) == jarch.report_dict(jtot)
        assert [tarch.report_dict(r) for _, r in tper] == [
            jarch.report_dict(r) for _, r in jper]
        if data == model == 1:
            _, plain = tarch.price_workload(ts, 1024)
            assert tarch.report_dict(ttot) == tarch.report_dict(plain)


def test_mesh_and_shard_scopes_stack():
    a, b = tmesh.AbstractMesh((2, 2), ("data", "model")), object()
    rules = tsc.ScShardRules(batch=("data",))
    assert tsc.active_mesh() is None
    with tsc.use_mesh(a) as got:
        assert got is a and tsc.active_mesh() == (a, None)
        with tsc.use_mesh(b, rules):
            assert tsc.active_mesh() == (b, rules)
        assert tsc.active_mesh() == (a, None)
    assert tsc.active_mesh() is None
    assert tsc.current_shard_count() == 1
    with tsc.shard_scope(8):
        assert tsc.current_shard_count() == 8
        with tsc.shard_scope(2):
            assert tsc.current_shard_count() == 2
        assert tsc.current_shard_count() == 8
    assert tsc.current_shard_count() == 1
    with pytest.raises(RuntimeError):
        with tsc.shard_scope(4):
            raise RuntimeError("unwinds")
    assert tsc.current_shard_count() == 1


def test_array_records_and_census_inside_a_shard_scope_equal_reference():
    """One shard's ``array`` call inside ``shard_scope(4)``: the record's
    shards, local shape and reports, and the fault census (times the
    shards, labelled by them), as the reference's one trace of its
    ``shard_map`` body records them."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 128)).astype(np.float32)
    w = rng.standard_normal((128, 64)).astype(np.float32)
    got, want = {}, {}
    for side, sc, arch, obs, phys, key, arr in (
        (want, jsc, jarch, jobs, jphysics, jax.random.PRNGKey(0),
         jnp.asarray),
        (got, tsc, tarch, tobs, tphysics, ctr_rng.prng_key(0),
         torch.from_numpy),
    ):
        prof = phys.resolve_profile("tiny")
        cfg = sc.ScConfig(backend="array", nbit=1024, device=prof)
        reg = obs.enable()
        try:
            with arch.collect() as recs, sc.shard_scope(4):
                sc.sc_dot(key, arr(x), arr(w), cfg)
            side["census"] = {
                k: reg.value("arch_bit_errors_total", kind=k, shard="4")
                for k in ("stuck0", "stuck1", "retention")}
        finally:
            obs.disable()
        (rec,) = recs
        side["rec"] = (rec.shards, rec.shape, arch.report_dict(rec.report),
                       arch.report_dict(rec.effective_report))
    assert got == want
    assert got["rec"][0] == 4 and got["census"]["stuck0"] > 0


@pytest.mark.parametrize("backend", ["exact", "moment", "bitexact",
                                     "pallas_fused", "pallas_bitexact"])
def test_trivial_mesh_is_sc_dot(backend):
    """A world of one is the 1 x 1 mesh: no live axis, so the sharded
    call is ``sc_dot`` with the same key, bit for bit, and leading dims
    flatten alike.  (Against the reference: the mesh test's rules with
    no live axis.)"""
    mesh = tmesh.make_local_mesh(1, device="cpu")
    assert (mesh.shape, mesh.rank, mesh.backend) == (
        {"data": 1, "model": 1}, 0, None)
    assert mesh.coords == {"data": 0, "model": 0}
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 8)).astype(np.float32)
    w = rng.standard_normal((8, 5)).astype(np.float32)
    cfg = tsc.ScConfig(backend=backend, nbit=64)
    key = ctr_rng.prng_key(0)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    want = tsc.sc_dot(key, xt, wt, cfg)
    got = tsc.sc_dot_sharded(key, xt, wt, cfg, mesh=mesh)
    assert got.shape == (2, 3, 5)
    assert torch.equal(got, want)


def test_make_local_mesh_checks_the_world():
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.make_local_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="ranks"):
        tmesh.DeviceMesh((2, 1), ("data", "model"), device="cpu")
    m = tmesh.AbstractMesh((2, 3, 4), ("pod", "data", "model"))
    assert m.size == 24 and list(m.shape) == ["pod", "data", "model"]
    dims = (2, 3, 4)
    for r in range(24):  # row-major, as jax lays devices out
        assert tmesh._unravel(r, dims) == tuple(np.unravel_index(r, dims))


def test_serve_options_mesh_validates_as_the_reference():
    for kw in (dict(mesh=True), dict(mesh=True, model_parallel=2)):
        JaxOptions(**kw).validate()
        ServeOptions(**kw).validate()
    for kw in (dict(mesh=True, paged=True), dict(mesh=True, chaos=True)):
        with pytest.raises(ValueError):
            JaxOptions(**kw).validate()
        with pytest.raises(ValueError):
            ServeOptions(**kw).validate()


def _small(backend):
    cfg = torch_smoke("qwen2-0.5b").replace(
        param_dtype=torch.float32, act_dtype=torch.float32, d_model=32,
        d_ff=64, vocab=128, sc_backend=backend, sc_nbit=32)
    gen = torch.Generator().manual_seed(0)
    return cfg, tparams.init_params(tlm.lm_param_specs(cfg), gen, "cpu")


def test_slots_must_divide_the_data_span():
    """The reference's check: on a stochastic substrate the slots must
    be a multiple of the rules' batch span (``exact`` shards nothing)."""
    cfg, params = _small("pallas_bitexact")
    mesh = tmesh.AbstractMesh((2, 2), ("data", "model"))
    opts = ServeOptions(mesh=True, slots=3, max_len=16)
    with pytest.raises(ValueError, match="batch span 2"):
        build_engine(params, cfg, opts, device="cpu", mesh=mesh,
                     shard_rules=trules.sc_shard_rules(mesh))
    # rules with no batch axis, and the exact substrate, pass
    build_engine(params, cfg, opts, device="cpu", mesh=mesh,
                 shard_rules=tsc.ScShardRules(batch=(), contract=("model",)))
    ecfg, _ = _small("exact")
    build_engine(params, ecfg, opts, device="cpu", mesh=mesh)


def test_world_one_mesh_engine_serves_the_unsharded_tokens():
    cfg, params = _small("pallas_bitexact")
    mesh = tmesh.make_local_mesh(1, device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(3, 128, n).tolist() for n in (6, 4, 6)]
    toks = []
    for kw in ({}, dict(mesh=mesh, shard_rules=trules.sc_shard_rules(mesh))):
        eng = build_engine(params, cfg,
                           ServeOptions(mesh=bool(kw), slots=2, max_len=16),
                           device="cpu", **kw)
        assert eng.mesh is kw.get("mesh")
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=3))
        toks.append({r.rid: r.generated for r in eng.run_until_drained()})
    assert toks[0] == toks[1] and len(toks[0]) == 3


def test_serve_launcher_mesh_of_one(capsys):
    """``launch/serve.py --mesh`` without ``torchrun``: the trivial mesh,
    the same tokens as without ``--mesh``."""
    argv = ["--smoke", "--arch", "paper-sc", "--requests", "2",
            "--max-new", "3", "--slots", "2", "--max-len", "32",
            "--device", "cpu"]
    plain = launch_serve.main(argv)
    capsys.readouterr()
    meshed = launch_serve.main(argv + ["--mesh"])
    out = capsys.readouterr().out
    assert "serving on mesh {'data': 1, 'model': 1}" in out
    assert "rank 0: device cpu, backend None" in out
    assert [r.generated for r in meshed] == [r.generated for r in plain]
