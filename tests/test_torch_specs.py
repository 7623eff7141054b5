"""The port's dry-run inputs and placements against the reference's, on
the production meshes (16 x 16 and 2 x 16 x 16) of sizes alone.

Every placement's spec equals the reference's ``PartitionSpec`` on
``specs.abstract_mesh``, ``input_specs`` shapes and dtypes equal its
``ShapeDtypeStruct`` s, ``abstract_params`` matches
``params.abstract_params`` leaf for leaf (on ``meta``), and ``decode``
and ``SHAPES`` are the reference's.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import supported_shapes as j_supported_shapes
from repro.launch import specs as JS
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.sc import encoding as jenc
from repro_torch.configs import SHAPES, ShapeConfig, get_config
from repro_torch.launch import specs as S
from repro_torch.launch.dryrun import DRYRUN_ARCHS
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.models import params as params_lib
from repro_torch.models.params import _leaves
from repro_torch.sc import encoding

MESHES = {
    "pod": ((16, 16), ("data", "model")),
    "multipod": ((2, 16, 16), ("pod", "data", "model")),
}


def _norm(spec) -> tuple:
    """A placement's entries as ``PartitionSpec`` holds them (a one-axis
    tuple is the axis)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(
            x, (jax.sharding.NamedSharding, jax.ShapeDtypeStruct,
                jparams.ParamSpec)))
    return {tuple(str(p.key) for p in path): leaf for path, leaf in flat}


def _same_placements(port, ref):
    port = dict(_leaves(port))
    ref = _jax_leaves(ref)
    assert set(port) == set(ref)
    for path, pl in port.items():
        assert _norm(pl.spec) == tuple(ref[path].spec), path


def _dtype(jdt) -> torch.dtype:
    return getattr(torch, np.dtype(jdt).name)


def _same_shapes(port, ref):
    port = dict(_leaves(port))
    ref = _jax_leaves(ref)
    assert set(port) == set(ref)
    for path, t in port.items():
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(ref[path].shape), path
        assert t.dtype == _dtype(ref[path].dtype), path


def test_production_mesh_is_the_reference_sizes():
    pod = make_production_mesh()
    multi = make_production_mesh(multi_pod=True)
    assert isinstance(pod, AbstractMesh)
    assert pod.shape == {"data": 16, "model": 16} and pod.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512
    for name, (sizes, axes) in MESHES.items():
        ref = JS.abstract_mesh(sizes, axes)
        assert S.abstract_mesh(sizes, axes).shape == dict(ref.shape), name


def test_shapes_and_decode_are_the_reference():
    assert set(SHAPES) == set(J_SHAPES)
    for name, sh in SHAPES.items():
        assert isinstance(sh, ShapeConfig)
        ref = J_SHAPES[name]
        assert (sh.name, sh.seq_len, sh.global_batch, sh.kind) == (
            ref.name, ref.seq_len, ref.global_batch, ref.kind)
    rng = np.random.default_rng(0)
    sign = np.sign(rng.normal(size=(4, 8))).astype(np.float32)
    p = rng.uniform(size=(4, 8)).astype(np.float32)
    scale = np.float32(3.5)
    want = np.asarray(jenc.decode(sign, p, scale))
    got = encoding.decode(torch.tensor(sign), torch.tensor(p),
                          torch.tensor(scale)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", DRYRUN_ARCHS)
def test_abstract_params_match_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    port = params_lib.abstract_params(lm.lm_param_specs(cfg),
                                      cfg.param_dtype)
    ref = jparams.abstract_params(jlm.lm_param_specs(jcfg),
                                  jcfg.param_dtype)
    _same_shapes(port, ref)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", DRYRUN_ARCHS)
def test_placements_match_the_reference(arch, mesh_name):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    mesh = S.abstract_mesh(*MESHES[mesh_name])
    jmesh = JS.abstract_mesh(*MESHES[mesh_name])
    p_sh = S.param_shardings(cfg, mesh)
    jp_sh = JS.param_shardings(jcfg, jmesh)
    _same_placements(p_sh, jp_sh)
    _same_placements(S.opt_shardings(cfg, mesh, p_sh),
                     JS.opt_shardings(jcfg, jmesh, jp_sh))
    assert _norm(S.replicated(mesh).spec) == tuple(JS.replicated(jmesh).spec)
    for name in j_supported_shapes(jcfg):
        sh = SHAPES[name]
        b, s = sh.global_batch, sh.seq_len
        _same_placements(S.batch_shardings(cfg, mesh, b),
                         JS.batch_shardings(jcfg, jmesh, b))
        _same_placements(S.cache_shardings(cfg, mesh, b, s),
                         JS.cache_shardings(jcfg, jmesh, b, s))
        for with_seq in (False, True):
            got = S.logits_sharding(cfg, mesh, b, with_seq)
            want = JS.logits_sharding(jcfg, jmesh, b, with_seq)
            assert _norm(got.spec) == tuple(want.spec), (name, with_seq)


@pytest.mark.parametrize("arch", DRYRUN_ARCHS)
def test_input_specs_match_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name in j_supported_shapes(jcfg):
        port = S.input_specs(cfg, SHAPES[name])
        ref = JS.input_specs(jcfg, J_SHAPES[name])
        _same_shapes(port, ref)


def test_placement_shards_divide_the_reference_way():
    """The reference's long-context layout: the hybrid's shared K/V
    sequence over every axis at batch 1, each rank a 1/256 of it."""
    cfg = get_config("zamba2-7b")
    mesh = make_production_mesh()
    sh = S.cache_shardings(cfg, mesh, 1, SHAPES["long_500k"].seq_len)
    k = S.input_specs(cfg, SHAPES["long_500k"])["cache"]["shared_k"]
    assert sh["shared_k"].spec[2] == ("data", "model")
    shard = sh["shared_k"].shard_shape(k.shape)
    assert shard[2] * 256 == k.shape[2] and shard[1] == 1
