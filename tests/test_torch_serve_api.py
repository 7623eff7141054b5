"""PyTorch port vs JAX reference: the serve API — ``ServeOptions.validate``
on the reference's combinations, the CLI flags derived from the
dataclass, ``build_engine``'s engine choice, fused attention and fault
profile routing, and the warning on direct engine construction."""

import argparse
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.serve import ServeOptions as JaxOptions
from repro.serve import add_cli_args as jax_add_cli_args
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.models import params as tparams
from repro_torch.serve import (
    PagedServeConfig,
    PagedServingEngine,
    Request,
    ServeConfig,
    ServeOptions,
    ServingEngine,
    add_cli_args,
    build_engine,
    from_cli_args,
)

# the cases of tests/test_serve_api.py's validation test
_BAD = [
    (dict(paged=True, mesh=True), "mutually exclusive"),
    (dict(fused_attention=True), "needs paged"),
    (dict(prefix_cache=True), "need paged"),
    (dict(speculative=True), "need paged"),
    (dict(chaos=True, mesh=True), "drop mesh"),
    (dict(rng_mode="dice"), "rng_mode"),
    (dict(fault_profile="broken-chip"), "unknown device profile"),
]


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke("qwen2-0.5b").replace(
        param_dtype=jnp.float32, act_dtype=jnp.float32
    )
    cfg = torch_smoke("qwen2-0.5b").replace(
        param_dtype=torch.float32, act_dtype=torch.float32
    )
    params = jparams.init_params(
        jax.random.PRNGKey(0), jlm.lm_param_specs(jcfg), jnp.float32
    )
    tp = tparams.params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu"
    )
    return tp, cfg


@pytest.mark.parametrize("bad, match", _BAD)
def test_validate_rejects_what_the_reference_rejects(bad, match):
    with pytest.raises(ValueError, match=match):
        JaxOptions(**bad).validate()
    with pytest.raises(ValueError, match=match):
        ServeOptions(**bad).validate()


@pytest.mark.parametrize(
    "good",
    [
        dict(),
        dict(chaos=True),
        dict(chaos=True, paged=True, fault_profile="tiny"),
        dict(paged=True, fused_attention=True, prefix_cache=True,
             speculative=True, fault_profile="tiny"),
        dict(fault_profile="ideal"),
    ],
)
def test_validate_accepts_what_the_reference_accepts(good):
    JaxOptions(**good).validate()
    ServeOptions(**good).validate()


def test_mesh_alone_is_not_ported():
    """``mesh`` alone validates in both packages now that the sharded
    substrate is ported (``tests/test_torch_sharded.py`` serves on it)."""
    JaxOptions(mesh=True).validate()
    ServeOptions(mesh=True).validate()
    ServeOptions(mesh=True, model_parallel=2).validate()


def test_options_have_the_reference_fields_and_defaults():
    want = {f.name: f.default for f in dataclasses.fields(JaxOptions)}
    got = {f.name: f.default for f in dataclasses.fields(ServeOptions)}
    assert got == want


def test_cli_round_trip_through_derived_flags():
    ap = argparse.ArgumentParser()
    add_cli_args(ap)
    args = ap.parse_args(["--paged", "--block-size", "8", "--max-blocks",
                          "32", "--fault-profile", "tiny", "--seed", "3",
                          "--chaos"])
    opts = from_cli_args(args)
    assert opts.paged and opts.chaos and opts.block_size == 8
    assert opts.num_blocks == 32  # --max-blocks maps onto the field
    assert opts.fault_profile == "tiny" and opts.seed == 3
    assert opts.slots == ServeOptions().slots
    assert from_cli_args(ap.parse_args([])) == ServeOptions()
    assert from_cli_args(args, slots=7).slots == 7
    with pytest.raises(SystemExit):
        ap.parse_args(["--rng-mode", "content"])  # cli=False field


def test_cli_flags_are_the_reference_flags_without_mesh():
    def flags(add):
        ap = argparse.ArgumentParser()
        add(ap)
        return {a.option_strings[0]: a.default for a in ap._actions[1:]}

    want = flags(jax_add_cli_args)
    got = flags(add_cli_args)
    # --mesh / --model-parallel are ported too: the flags are the same
    assert {"--mesh", "--model-parallel"} <= set(got)
    assert got == want


def test_build_engine_selects_engine_class(setup):
    params, cfg = setup
    eng = build_engine(params, cfg, device="cpu")
    assert isinstance(eng, ServingEngine)
    assert eng.scfg == ServeConfig(slots=4, max_len=128)
    paged = build_engine(params, cfg, ServeOptions(paged=True, block_size=4),
                         device="cpu")
    assert isinstance(paged, PagedServingEngine)
    assert paged.scfg.block_size == 4


def test_build_engine_applies_fused_attention_to_cfg(setup):
    params, cfg = setup
    eng = build_engine(params, cfg,
                       ServeOptions(paged=True, fused_attention=True),
                       device="cpu")
    assert eng.cfg.paged_attn == "fused"
    with pytest.raises(ValueError, match="needs paged"):
        build_engine(params, cfg, ServeOptions(fused_attention=True),
                     device="cpu")


@pytest.mark.parametrize("paged", [False, True])
def test_fault_profile_moves_exact_onto_array_for_both_engines(setup, paged):
    params, cfg = setup
    assert cfg.sc_backend == "exact"
    eng = build_engine(params, cfg,
                       ServeOptions(paged=paged, fault_profile="tiny",
                                    slots=1, max_len=32, block_size=4),
                       device="cpu")
    assert eng.cfg.sc_backend == "array"
    assert eng.device_profile.sigma_delta == 0.05
    eng.submit(Request(rid=0, prompt=[5, 9, 17, 3], max_new_tokens=2))
    done = eng.run_until_drained()
    assert len(done) == 1 and len(done[0].generated) == 2
    # an ideal profile threads through without forcing the array backend
    ideal = build_engine(params, cfg,
                         ServeOptions(paged=paged, fault_profile="ideal"),
                         device="cpu")
    assert ideal.cfg.sc_backend == "exact"
    assert ideal.device_profile.is_ideal


def test_direct_constructors_warn_and_build_engine_does_not(setup):
    params, cfg = setup
    with pytest.warns(DeprecationWarning, match="build_engine"):
        ServingEngine(params, cfg, ServeConfig(slots=1, max_len=16),
                      device="cpu")
    with pytest.warns(DeprecationWarning, match="build_engine"):
        PagedServingEngine(params, cfg,
                           PagedServeConfig(slots=1, max_len=16,
                                            block_size=4),
                           device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        build_engine(params, cfg, ServeOptions(slots=1, max_len=16),
                     device="cpu")
        build_engine(params, cfg, ServeOptions(paged=True, slots=1,
                                               max_len=16, block_size=4),
                     device="cpu")


def test_engine_lifecycle_is_shared(setup):
    """Both engines count a raising tick in ``serve_errors_total``,
    close once, and report health."""
    params, cfg = setup
    for paged in (False, True):
        eng = build_engine(params, cfg, ServeOptions(paged=paged, slots=1,
                                                     max_len=16),
                           device="cpu")
        eng.submit(Request(rid=0, prompt=[300], max_new_tokens=2))
        with pytest.raises(IndexError):
            eng.step()  # token id past the vocabulary
        assert eng.metrics.value("serve_errors_total") == 1
        assert eng.health_snapshot()["errors"] == 1
        assert eng._arch_closed
        eng.close()
