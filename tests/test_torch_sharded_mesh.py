"""PyTorch port vs JAX reference: ``sc_dot_sharded`` and the mesh
``ServingEngine`` on four ranks.

The reference runs in subprocesses on 4 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``), its meshes
built with Auto axes (``jax.make_mesh``'s default Explicit axes fail
its sharded einsums on jax 0.9.0); the port runs as 4 gloo ranks of
the CPU under ``torchrun``.  Both sides live in
``tests/_torch_sharded_ranks.py`` and start together, so their
compiles overlap.  The same numpy operands and the reference's
``init_params`` weights feed both.  Held:

* ``pallas_fused`` on the 2x2, 4x1 and 1x4 meshes bit for bit: each
  rank's block draws the same bits as the reference's shard, and the
  partial sums over the model axis are added in coordinate order, as
  XLA's ``psum`` adds them on the CPU, so even the four-way 1x4 sum is
  bit-equal;
* rules naming no live axis: ``sc_dot`` bit for bit, in the port and
  against the reference;
* ``pallas_bitexact`` equal to ``pallas_fused`` in the port;
* ``moment`` within the reference's 0.5 of the exact product on every
  mesh, deterministic, and within 1e-5 of the reference's (its normals
  are ``jax.random.normal``'s to ~1e-5);
* the straight-through gradients within 1e-5 of ``g @ wᵀ`` / ``xᵀ @ g``
  and of the reference's;
* one ``array`` call's record (shards, local shape, reports) and fault
  census equal to the reference's;
* the mesh ``ServingEngine``'s greedy tokens at data 2 x model 2 with 4
  slots equal to the reference's on ``pallas_bitexact`` and ``exact``,
  the same on every rank.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import get_smoke_config
from repro.models import lm as jlm
from repro.models import params as jparams

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
HELPER = os.path.join(HERE, "_torch_sharded_ranks.py")
sys.path.insert(0, HERE)
import _torch_sharded_ranks as ranks  # noqa: E402

RANKS = 4
TIMEOUT = 300


def _inputs(path):
    cfg = get_smoke_config("qwen2-0.5b").replace(
        param_dtype=jnp.float32, act_dtype=jnp.float32, **ranks.SMALL)
    params = jparams.init_params(
        jax.random.PRNGKey(0), jlm.lm_param_specs(cfg), jnp.float32)
    flat = {
        "params/" + "/".join(str(k.key) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(params)[0]
    }
    rng = np.random.default_rng(0)
    f32 = np.float32
    np.savez(
        path,
        x=rng.standard_normal((8, 32)).astype(f32),
        w=rng.standard_normal((32, 6)).astype(f32),
        xa=rng.standard_normal((32, 256)).astype(f32),
        wa=rng.standard_normal((256, 64)).astype(f32),
        # one prompt length (the reference compiles one prefill) and
        # more requests than slots, so slots are reused
        prompts=rng.integers(3, ranks.SMALL["vocab"], (6, ranks.PROMPT)),
        **flat,
    )


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    inputs = str(tmp / "inputs.npz")
    _inputs(inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = {
        "ref": subprocess.Popen(
            [sys.executable, HELPER, "ref", inputs, str(tmp / "ref.npz")],
            env=jenv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
        "ref-engine": subprocess.Popen(
            [sys.executable, HELPER, "ref-engine", inputs,
             str(tmp / "ref_engine.json")],
            env=jenv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
        "port": subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={RANKS}", HELPER, "port", inputs,
             str(tmp / "port")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
    }
    # meanwhile, the reference's exact engine here: it enters no mesh
    # scope, so sizes without devices serve
    data, params = ranks._load(inputs)
    exact = ranks.ref_engine_tokens(
        params, data, "exact", AbstractMesh((2, 2), ("data", "model")))
    for name, p in procs.items():
        out, _ = p.communicate(timeout=TIMEOUT)
        assert p.returncode == 0, f"{name}:\n{out.decode()[-4000:]}"
    with np.load(tmp / "ref.npz") as z:
        ref = {k: z[k] for k in z.files}
    with open(tmp / "ref_engine.json") as f:
        ref_tokens = {"pallas_bitexact": json.load(f), "exact": exact}
    port = []
    for r in range(RANKS):
        with np.load(tmp / f"port.rank{r}.npz") as z:
            port.append({k: z[k] for k in z.files})
    return dict(ref=ref, ref_meta=json.loads(str(ref["meta"])),
                ref_tokens=ref_tokens, port=port,
                port_meta=[json.loads(str(p["meta"])) for p in port],
                data=data)


def _arrays(d):
    return {k: v for k, v in d.items() if k != "meta"}


def test_every_rank_holds_the_same_results(runs):
    first = _arrays(runs["port"][0])
    for other in runs["port"][1:]:
        other = _arrays(other)
        assert sorted(other) == sorted(first)
        for k in first:
            np.testing.assert_array_equal(other[k], first[k], err_msg=k)
    metas = runs["port_meta"]
    assert all(m == metas[0] for m in metas[1:])


@pytest.mark.parametrize("mesh", list(ranks.MESHES))
def test_pallas_fused_sharded_bit_equal_reference(runs, mesh):
    port, ref = runs["port"][0], runs["ref"]
    got, want = port[f"pallas_fused/{mesh}"], ref[f"pallas_fused/{mesh}"]
    assert got.shape == (8, 6)
    np.testing.assert_array_equal(got, want)
    # the packed engine draws the same stream: bit-equal to the fused one
    np.testing.assert_array_equal(port[f"pallas_bitexact/{mesh}"], got)


def test_rules_with_no_live_axis_are_sc_dot(runs):
    port, ref = runs["port"][0], runs["ref"]
    for backend in ("pallas_fused", "moment"):
        np.testing.assert_array_equal(port[f"trivial/{backend}"],
                                      port[f"single/{backend}"])
    np.testing.assert_array_equal(port["trivial/pallas_fused"],
                                  ref["trivial/pallas_fused"])
    np.testing.assert_allclose(port["trivial/moment"], ref["trivial/moment"],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("mesh", list(ranks.MESHES))
def test_moment_sharded_within_the_reference_bound(runs, mesh):
    port, ref = runs["port"][0], runs["ref"]
    got = port[f"moment/{mesh}"]
    exact = runs["data"]["x"] @ runs["data"]["w"]
    assert np.max(np.abs(got - exact)) < 0.5
    assert np.max(np.abs(ref[f"moment/{mesh}"] - exact)) < 0.5
    np.testing.assert_array_equal(port[f"moment_again/{mesh}"], got)
    np.testing.assert_allclose(got, ref[f"moment/{mesh}"], rtol=0,
                               atol=1e-5)


def test_straight_through_gradients(runs):
    port, ref = runs["port"][0], runs["ref"]
    x, w = runs["data"]["x"], runs["data"]["w"]
    g = np.ones((x.shape[0], w.shape[1]), np.float32)
    for got, want, jac in ((port["grad/x"], ref["grad/x"], g @ w.T),
                           (port["grad/w"], ref["grad/w"], x.T @ g)):
        np.testing.assert_allclose(got, jac, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_array_record_and_census_equal_reference(runs):
    got = runs["port_meta"][0]
    want = runs["ref_meta"]
    assert got["record"]["shards"] == 4
    assert got["record"]["shape"] == [16, 128, 64]
    assert got["record"] == want["record"]
    assert got["census"] == want["census"]
    eff, one = got["record"]["effective"], got["record"]["report"]
    assert eff["products"] == 4 * one["products"]


@pytest.mark.parametrize("backend", ranks.ENGINE_BACKENDS)
def test_mesh_engine_greedy_tokens_equal_reference(runs, backend):
    want = runs["ref_tokens"][backend]
    assert sorted(map(int, want)) == list(range(6))
    for meta in runs["port_meta"]:
        assert meta["tokens"][backend] == want
