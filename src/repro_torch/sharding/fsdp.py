"""The FSDP ∘ TP layout of the mesh train step: each rank holds only its
shard of every parameter, and of AdamW's ``m`` and ``v``.

The reference declares the layout (``sharding/rules.py``: a weight's
embed axis over ``data``, its parallelism axis over ``model``) and jits
its step with it as the state's in and out shardings; XLA's partitioner
then all-gathers each layer's weights inside the layer scan (its
``make_param_constrain``) and reduce-scatters the gradients.  The port
does that work itself over ``torch.distributed``, as ``sc/sharded.py``
does for the SC contraction:

* :func:`shard_tree` cuts a rank's shards out of whole leaves
  (``Placement.shard``: along each dimension the block at the rank's
  coordinate over the dimension's mesh axes);
* :class:`GatherParam` all-gathers a shard into the whole leaf where it
  is used (``Placement.gather``: bits copied exactly, so every rank runs
  the replicated step's forward on the same values).  Its backward turns
  this rank's gradient of the whole leaf into the gradient of its shard
  of the batch-mean loss: a local slice along each dimension split over
  ``model`` (the ranks of a model group hold the same rows of the batch,
  so their gradients of the whole leaf are equal already), a
  reduce-scatter along each dimension split over a batch axis
  (``data``), an all-reduce over each batch axis no dimension is split
  over (``pod``, which never splits a parameter, and ``data`` for a leaf
  whose dimensions do not divide it), then the division by the batch
  span;
* with the in-layer layout on (the step's default), every leaf the
  layer code runs on a rank's ``model`` block (``sharding.tp.
  weight_blocks``: the heads / kv heads, the MLP hidden, the
  vocabulary, the SSM's ``d_inner`` and heads, the experts) gathers
  over ``data`` only and keeps that block (:func:`keep_blocks`,
  ``Placement.keep``): the layer uses it as it comes, its gradient is
  the block's, and the reduce-scatter over ``data`` runs at the block's
  size with no ``model`` slice, so no rank holds such a leaf whole or
  its whole gradient.  SwiGLU's ``wi``, whose contiguous shard holds
  the gate's columns apart from the up's, is relaid into the layer's
  ``parts=2`` block by one all-to-all over ``model`` after the gather
  (``Placement.parts``, span ``fsdp.relayout``), its gradient back
  before the reduction;
* :func:`gather_params` gathers the leaves outside the layer stack (the
  embedding and tied unembed, ``final_norm``, the frontend, zamba2's
  shared block) once a step; ``train/step.py:make_param_constrain``
  gathers each layer's leaves inside the layer's checkpointed function,
  so under ``remat="full"`` the backward's recompute gathers it again
  and no layer's whole weights are kept for the backward: gather, use,
  discard;
* :func:`collective_plan` counts the collectives of one step from the
  placements alone, and :func:`state_placements` places every leaf of a
  train state (what ``checkpoint.save`` gathers and
  ``checkpoint.restore_resharded`` cuts).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from repro_torch.launch.mesh import (
    all_reduce,
    collective_span,
    reduce_scatter,
)
from repro_torch.models import lm
from repro_torch.models.params import _leaves, _set, tree_map
from repro_torch.sharding import tp as tp_lib
from repro_torch.sharding.rules import (
    ColBlock,
    Placement,
    param_shardings,
    spec_axes,
)


def _live_dims(placement: Placement, ndim: int) -> list:
    """Per dimension, the mesh axes of size > 1 it is split over."""
    sizes = placement.mesh.shape
    return [tuple(a for a in axes if sizes[a] > 1)
            for axes in placement.dim_axes(ndim)]


def shard_tree(tree, placements):
    """This rank's shard of every whole leaf of ``tree``."""
    return tree_map(lambda t, pl: pl.shard(t), tree, placements)


def reduce_grad(g: torch.Tensor, placement: Placement, reduce_axes: tuple
                ) -> torch.Tensor:
    """The gradient of this rank's shard of the loss's mean over the
    ranks of ``reduce_axes``, from this rank's gradient ``g`` of the
    whole leaf (see the module doc), in ``g``'s dtype.  The sums run in
    float32."""
    mesh = placement.mesh
    sizes, coords = mesh.shape, mesh.coords
    dims = _live_dims(placement, g.dim())
    dtype = g.dtype
    for i, axes in enumerate(dims):
        if not axes or axes[0] in reduce_axes:
            continue
        if all(a in placement.keep for a in axes):
            continue  # the gradient of the kept block already
        if any(a in reduce_axes or a in placement.keep for a in axes):
            raise ValueError(
                f"dimension {i} of a leaf is split over {axes}: batch and "
                "model axes, or kept and gathered ones, on one dimension")
        block, n = 0, 1
        for a in axes:
            block, n = block * sizes[a] + coords[a], n * sizes[a]
        size = g.shape[i] // n
        g = g.narrow(i, block * size, size)
    g = g.to(torch.float32)
    for i, axes in enumerate(dims):
        if axes and axes[0] in reduce_axes:
            for a in axes:
                g = reduce_scatter(g, mesh, a, i)
    split = {a for axes in dims for a in axes}
    rest = tuple(a for a in reduce_axes if sizes[a] > 1 and a not in split)
    if rest:
        g = g.clone(memory_format=torch.contiguous_format)
        with collective_span("fsdp.grad_allreduce", g, axes=rest,
                             bytes=g.numel() * g.element_size()):
            for a in rest:
                all_reduce(g, mesh, a)
    span = math.prod(sizes[a] for a in reduce_axes)
    return (g / span).to(dtype)


def _parts_block(placement: Placement, t):
    """The kept dimension of ``t`` and the ``parts`` :class:`ColBlock` it
    is laid out in (``Placement.parts``)."""
    dim = placement.kept_dim(t.dim())
    sizes = placement.mesh.shape
    axes = tuple(a for a in placement.dim_axes(t.dim())[dim]
                 if sizes[a] > 1)
    span = math.prod(sizes[a] for a in axes)
    return dim, ColBlock(placement.mesh, axes, t.shape[dim] * span,
                         placement.parts)


class GatherParam(torch.autograd.Function):
    """``shard`` -> the whole leaf, or the rank's kept block
    (``placement.gather``, then the ``parts`` relayout); the backward
    gives the shard's gradient of the mean loss over ``reduce_axes``
    (the inverse relayout, then :func:`reduce_grad`)."""

    @staticmethod
    def forward(ctx, shard, placement, reduce_axes):
        ctx.placement, ctx.reduce_axes = placement, reduce_axes
        whole = placement.gather(shard)
        if placement.parts > 1:
            dim, blk = _parts_block(placement, whole)
            whole = tp_lib.to_parts(whole, blk, dim, "fsdp.relayout")
        return whole.clone() if whole is shard else whole

    @staticmethod
    def backward(ctx, g):
        pl = ctx.placement
        if pl.parts > 1:
            dim, blk = _parts_block(pl, g)
            g = tp_lib.from_parts(g, blk, dim, "fsdp.relayout")
        return reduce_grad(g, pl, ctx.reduce_axes), None, None


_GATHERED: list = []


@contextlib.contextmanager
def record_gathers():
    """Within, every leaf :func:`gather_tree` gathers appends ``(path,
    shape)`` to the list this yields (paths as in
    ``lm.lm_param_specs``, a layer's under ``"blocks"`` without the
    layer axis): what a step's gathers hand the layer code."""
    out: list = []
    _GATHERED.append(out)
    try:
        yield out
    finally:
        _GATHERED.remove(out)


def gather_tree(tree, placements, reduce_axes: tuple = (), prefix=()):
    """Every leaf of ``tree`` (shards; at ``prefix`` in the parameter
    tree) through :class:`GatherParam`; a leaf that nothing splits and
    whose gradient needs no reduction is passed through as it is."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, placements[k], reduce_axes, prefix + (k,))
                for k, v in tree.items()}
    pl, sizes = placements, placements.mesh.shape
    if not pl.live_axes(tree.dim()) and all(sizes[a] == 1
                                            for a in reduce_axes):
        out = tree
    else:
        out = GatherParam.apply(tree, pl, tuple(reduce_axes))
    for rec in _GATHERED:
        rec.append((prefix, tuple(out.shape)))
    return out


def gather_params(params, placements, reduce_axes: tuple = ()):
    """``params`` with every leaf outside the layer stack (``blocks``)
    gathered: what a step gathers once."""
    return {k: v if k == "blocks" else gather_tree(v, placements[k],
                                                   reduce_axes, (k,))
            for k, v in params.items()}


def layer_placements(placements):
    """The placements of one layer of the stacked ``blocks`` (the
    leading layer axis is never split)."""
    return tree_map(lambda pl: dataclasses.replace(pl, spec=pl.spec[1:]),
                    placements["blocks"])


def keep_blocks(placements, cfg, *, train: bool = True):
    """``placements`` (of ``cfg``'s parameters) with every leaf that the
    layer code runs on this rank's block of a dimension under the mesh's
    in-layer layout (``sharding.tp.weight_blocks``; ``train=False``: the
    expert leaves alone) keeping that block along the dimension's mesh
    axes (``Placement.keeping``): gathered over the other axes only,
    and relaid into the layer's ``parts`` segments where it has more
    than one.  A leaf keeps its block only where the placement splits
    that dimension over the layer block's axes (its block is then the
    placement's); elsewhere it gathers whole."""
    mesh = next(pl for _, pl in _leaves(placements)).mesh
    blocks = tp_lib.weight_blocks(cfg, tp_lib.TensorParallel(mesh),
                                  train=train)
    out = tree_map(lambda pl: pl, placements)
    sizes = mesh.shape
    for path, (dim, blk) in blocks.items():
        node = out
        for k in path:
            node = node[k]
        i = dim + (path[0] == "blocks")
        entry = node.spec[i] if i < len(node.spec) else None
        axes = tuple(a for a in spec_axes(entry) if sizes[a] > 1)
        if axes == blk.axes:
            _set(out, path, node.keeping(axes, blk.parts))
    return out


def state_placements(state, placements):
    """A :class:`Placement` for every leaf of a train state whose
    parameters ``placements`` places: ``m`` and ``v`` as their
    parameter (an int8 state's ``q``; its per-tensor ``scale`` whole),
    the error-feedback residual's ``(n_pods, ...)`` leaves as their
    parameter behind a whole leading dimension, ``opt.step`` whole."""
    mesh = next(pl for _, pl in _leaves(placements)).mesh
    whole = Placement(mesh, ())

    def moment(pl, enc):
        return {"q": pl, "scale": whole} if isinstance(enc, dict) else pl

    out = {"params": placements, "opt": {
        "m": tree_map(moment, placements, state["opt"]["m"]),
        "v": tree_map(moment, placements, state["opt"]["v"]),
        "step": whole}}
    if "ef" in state:
        out["ef"] = None if state["ef"] is None else tree_map(
            lambda pl: Placement(mesh, (None,) + tuple(pl.spec)), placements)
    return out


def _record(plan, kind, axis, nbytes, times):
    entry = plan.setdefault(kind, {"count": 0, "bytes": 0})
    entry["count"] += times
    entry["bytes"] += times * nbytes
    by_axis = plan.setdefault("by_axis", {})
    key = f"{kind}:{axis}"
    by_axis[key] = by_axis.get(key, 0) + times * nbytes


def collective_plan(cfg, mesh, *, reduce_axes: tuple,
                    microbatches: int = 1,
                    tensor_parallel: bool = True) -> dict:
    """The parameter collectives one train step makes on ``mesh`` under
    the FSDP ∘ TP layout, from the placements alone: ``{"all-gather",
    "reduce-scatter", "all-reduce": {"count", "bytes"}, "by_axis":
    {"kind:axis": bytes}}``, bytes counted as each collective's operand
    (the reference's HLO account counts them so).  Each microbatch
    gathers every leaf outside the layer stack once and every layer's
    leaves once more under ``remat="full"`` (the backward's recompute),
    and reduces each leaf's gradient once.  The loss's all-reduce and
    the optimizer's norm / absmax reductions are not in it.  With
    ``tensor_parallel`` (``make_constrain``'s in-layer layout on) the
    leaves the layer code runs on a rank's block gather over ``data``
    only, at their ``model`` block's bytes (:func:`keep_blocks`), and a
    ``parts`` leaf adds an ``"all-to-all"`` over ``model`` at its
    block's bytes with each gather and each gradient (the relayout)."""
    specs = lm.lm_param_specs(cfg)
    placements = param_shardings(specs, mesh)
    if tensor_parallel:
        placements = keep_blocks(placements, cfg)
    dtype_bytes = torch.empty((), dtype=cfg.param_dtype).element_size()
    sizes = mesh.shape
    plan: dict = {}
    gathers_a_layer = 2 if cfg.remat == "full" else 1
    for (path, pl), (_, spec) in zip(_leaves(placements), _leaves(specs)):
        nbytes = (spec.dtype.itemsize if spec.dtype is not None
                  else dtype_bytes)
        layered = path[0] == "blocks"
        shape = list(spec.shape[1:] if layered else spec.shape)
        if layered:
            pl = dataclasses.replace(pl, spec=pl.spec[1:])
        dims = _live_dims(pl, len(shape))
        if not any(dims) and all(sizes[a] == 1 for a in reduce_axes):
            continue
        layers = spec.shape[0] if layered else 1
        n = microbatches * layers
        gathers = n * (gathers_a_layer if layered else 1)
        cur = list(pl.shard_shape(shape))
        for i, axes in enumerate(dims):
            for a in reversed(axes):
                if a in pl.keep:
                    continue
                _record(plan, "all-gather", a, math.prod(cur) * nbytes,
                        gathers)
                cur[i] *= sizes[a]
        if pl.parts > 1:
            kept = dims[pl.kept_dim(len(shape))]
            _record(plan, "all-to-all", kept[0], math.prod(cur) * nbytes,
                    gathers + n)
        # the gradient: model slices, data reduce-scatters, all-reduces;
        # the reductions run in float32
        cur = list(shape)
        for i, axes in enumerate(dims):
            if axes and axes[0] not in reduce_axes:
                cur[i] //= math.prod(sizes[a] for a in axes)
        for i, axes in enumerate(dims):
            if axes and axes[0] in reduce_axes:
                for a in axes:
                    _record(plan, "reduce-scatter", a, 4 * math.prod(cur), n)
                    cur[i] //= sizes[a]
        split = {a for axes in dims for a in axes}
        for a in reduce_axes:
            if sizes[a] > 1 and a not in split:
                _record(plan, "all-reduce", a, 4 * math.prod(cur), n)
    return plan
