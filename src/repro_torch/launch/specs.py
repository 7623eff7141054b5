"""Abstract inputs and placement trees for every dry-run cell.

Port of ``repro.launch.specs``.  ``input_specs(cfg, shape)`` gives the
inputs each (architecture x input-shape) cell is traced with, as
``meta`` tensors of the reference's shapes and dtypes (no allocation).
The ``*_shardings`` helpers give a :class:`~repro_torch.sharding.rules.
Placement` per leaf, holding the reference's ``PartitionSpec`` entries,
derived from the same logical rules (``sharding/rules.py``): where the
reference's dry-run lays each array out (FSDP x TP parameters, the KV
sequence over ``model``), and where the port's dry-run traces a rank's
shards (``launch/dryrun.py``).
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import lm
from repro_torch.models import params as params_lib
from repro_torch.sharding import rules as sharding_rules
from repro_torch.sharding.rules import Placement


def abstract_mesh(axis_sizes, axis_names) -> AbstractMesh:
    """A mesh of sizes alone (the reference's version shim over
    ``jax.sharding.AbstractMesh``)."""
    return AbstractMesh(tuple(axis_sizes), tuple(axis_names))


def _sizes(mesh) -> dict:
    return dict(mesh.shape)


def _dp_axes(mesh, n: int):
    """Data-parallel mesh axes usable for a batch of size n (or None)."""
    sizes = _sizes(mesh)
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    if not axes:
        return None
    if n > 0 and n % math.prod(sizes[a] for a in axes) == 0:
        return axes
    if "data" in sizes and n > 0 and n % sizes["data"] == 0:
        return ("data",)
    return None


def _div(n: int, mesh, axis: str):
    sizes = _sizes(mesh)
    return axis if axis in sizes and n % sizes[axis] == 0 else None


# ---------------------------------------------------------------------------
# Abstract inputs per shape kind
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Abstract step inputs for one cell, on ``meta``.  Returns a dict:

    train   -> {batch: {inputs, labels}}
    prefill -> {inputs}
    decode  -> {cache, tokens, lengths}
    """
    b, s = shape.global_batch, shape.seq_len
    if cfg.frontend == "embeddings" and shape.kind != "decode":
        inputs = _meta((b, s, cfg.d_model), cfg.act_dtype)
    else:
        inputs = _meta((b, s), torch.int32)
    if shape.kind == "train":
        return {"batch": {"inputs": inputs,
                          "labels": _meta((b, s), torch.int32)}}
    if shape.kind == "prefill":
        return {"inputs": inputs}
    # decode: one new token against a cache of seq_len
    return {
        "cache": lm.init_cache(cfg, b, s, device="meta"),
        "tokens": _meta((b,), torch.int32),
        "lengths": _meta((b,), torch.int32),
    }


# ---------------------------------------------------------------------------
# Placement trees
# ---------------------------------------------------------------------------


def param_shardings(cfg: ModelConfig, mesh):
    specs = lm.lm_param_specs(cfg)
    return params_lib.tree_map(
        lambda ps: Placement(mesh, ps),
        params_lib.partition_specs(specs, sharding_rules.logical_rules(mesh)),
    )


def opt_shardings(cfg: ModelConfig, mesh, param_sh):
    """AdamW m/v mirror the parameter placements (f32/bf16 state)."""
    return {"m": param_sh, "v": param_sh, "step": replicated(mesh)}


def batch_shardings(cfg: ModelConfig, mesh, batch: int):
    dp = _dp_axes(mesh, batch)
    if cfg.frontend == "embeddings":
        return {"inputs": Placement(mesh, (dp, None, None)),
                "labels": Placement(mesh, (dp, None))}
    return {"inputs": Placement(mesh, (dp, None)),
            "labels": Placement(mesh, (dp, None))}


def cache_shardings(cfg: ModelConfig, mesh, batch: int, max_len: int):
    """Mirror ``lm.init_cache``'s structure with the reference's
    layout-adaptive specs:

    * batch over (pod, data) when divisible;
    * the KV-cache SEQUENCE over ``model`` (over every axis when the
      batch leaves (pod, data) unused, as ``long_500k``'s batch of 1):
      ``sharding.rules.cache_seq_axes``, the axes the port's prefill and
      decode lay a rank's block out by;
    * SSM heads / d_inner over ``model`` when divisible: the block
      ``lm.init_cache`` gives under ``cst.lay_out_cache`` with the
      in-layer layout on (``sharding/tp.py``).
    """
    dp = _dp_axes(mesh, batch)
    seq_ax = sharding_rules.cache_seq_axes(mesh, batch, max_len) or None
    if seq_ax is not None and len(seq_ax) == 1:
        seq_ax = seq_ax[0]
    kv_ax = None if seq_ax else _div(cfg.n_kv_heads, mesh, "model")

    def ns(*spec):
        return Placement(mesh, spec)

    if cfg.family in ("ssm", "hybrid"):
        inner_ax = _div(cfg.d_inner, mesh, "model")
        state_ax = _div(cfg.ssm_heads, mesh, "model")
        out = {"ssm": {
            "conv_x": ns(None, dp, None, inner_ax),
            "conv_B": ns(None, dp, None, None),
            "conv_C": ns(None, dp, None, None),
            "state": ns(None, dp, state_ax, None, None),
        }}
        if cfg.family == "hybrid":
            out["shared_k"] = ns(None, dp, seq_ax, kv_ax, None)
            out["shared_v"] = ns(None, dp, seq_ax, kv_ax, None)
        return out
    return {"k": ns(None, dp, seq_ax, kv_ax, None),
            "v": ns(None, dp, seq_ax, kv_ax, None)}


def logits_sharding(cfg: ModelConfig, mesh, batch: int, with_seq: bool):
    dp = _dp_axes(mesh, batch)
    v_ax = _div(cfg.vocab, mesh, "model")
    if with_seq:
        return Placement(mesh, (dp, None, v_ax))
    return Placement(mesh, (dp, v_ax))


def replicated(mesh) -> Placement:
    return Placement(mesh, ())
