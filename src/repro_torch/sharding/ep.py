"""The expert-parallel layout of the MoE FFN: a rank's block of the
experts over ``model``.

The reference declares it (``sharding/rules.py``: ``"experts"`` over
``model`` for the expert weights and for the capacity buffers, which
``models/moe.py`` constrains to ``("batch", "experts", ...)`` before and
after the expert FFN) and XLA's partitioner moves the values.  The port
moves them itself, as ``sharding/tp.py`` moves the in-layer blocks; it is
part of the in-layer layout, on wherever ``cst.tp`` is set
(``make_constrain(..., tensor_parallel=False)`` turns it off).

The routing, the stable sort and the capacity run on the whole rows a
model group shares (the whole in-layer sequence), so every rank assigns
the same slots.  Each rank then fills only its experts' part of the
capacity buffer, runs its ``e / model`` experts and all-gathers the
outputs over ``model`` in coordinate order, so the combine sees the
whole layout's ``y`` bit for bit.  Every value stays whole and equal on
the ranks of a model group, or is a rank's block:

* :func:`enter`: the whole ``x`` the dispatch reads; the backward sums
  the ranks' partial gradients (each rank's holds its experts' tokens
  only) over ``model`` in coordinate order (``ep.sum``);
* :class:`GatherOutputs`: the rank's experts' outputs -> every expert's
  (``ep.gather``); the backward keeps the gradient's block;
* :func:`local_experts`: a whole expert leaf -> the rank's block (the
  serving path, the replicated train step); its backward all-gathers the
  block's gradient (``ep.grad``), so the gradient is whole and equal on
  the model group.  Under the FSDP layout the leaf arrives as the block
  already (``sharding/fsdp.py:keep_blocks``) and is used as it is.

An expert count the span does not divide stays whole on every rank (the
reference's per-tensor fallback): that is a layout, not a fallback.
Every collective goes through ``launch/mesh.py:all_gather``;
``sharding.tp.tp_collective_plan`` counts them.
"""

from __future__ import annotations

import torch

from repro_torch.sharding import tp as tp_lib
from repro_torch.sharding.rules import ColBlock


def expert_block(constrain, cfg):
    """This rank's :class:`ColBlock` of ``cfg.n_experts`` over ``model``
    under ``constrain``'s in-layer layout, or None: the experts whole."""
    tp = tp_lib.of(constrain)
    return None if tp is None else tp.block(cfg.n_experts)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, blk):
        ctx.blk = blk
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        blk = ctx.blk
        return tp_lib.sum_over(g, blk.mesh, blk.axes, span="ep.sum"), None


def enter(x, blk: ColBlock):
    """``x`` (whole), of which this rank dispatches only its experts'
    tokens: the backward sums the ranks' partial gradients."""
    return _Enter.apply(x, blk)


class GatherOutputs(torch.autograd.Function):
    """``(b, e / m, cap, d)`` outputs of the rank's experts -> ``(b, e,
    cap, d)`` (``ep.gather``); the backward keeps the gradient's block
    (every rank's gradient of the whole is the same)."""

    @staticmethod
    def forward(ctx, y, blk):
        ctx.blk = blk
        return tp_lib._gather_dim(y, blk, 1, "ep.gather")

    @staticmethod
    def backward(ctx, g):
        return tp_lib._block(g, ctx.blk, 1), None


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, blk):
        ctx.blk = blk
        return tp_lib._block(w, blk, 0)

    @staticmethod
    def backward(ctx, g):
        return tp_lib._gather_dim(g, ctx.blk, 0, "ep.grad"), None


def local_experts(w, blk, n_experts: int):
    """The expert leaf ``w`` (``(e, ...)``) as this rank runs it: the
    whole leaf where ``blk`` is None; else the rank's block, sliced here
    from a whole leaf (no copy without a gradient) or taken as it is
    where the leaf arrives as the block (the FSDP layout's gather).
    Any other leading dimension means the weights' layout and the
    activations' disagree, and raises."""
    if blk is None:
        if w.shape[0] != n_experts:
            raise ValueError(
                f"an expert leaf of {w.shape[0]} experts, but the layout "
                f"holds all {n_experts} (the expert-parallel layout is off)")
        return w
    if w.shape[0] == blk.size:
        return w
    if w.shape[0] != n_experts:
        raise ValueError(
            f"an expert leaf of {w.shape[0]} experts: neither all "
            f"{n_experts} nor this rank's block of {blk.size}")
    if torch.is_grad_enabled() and w.requires_grad:
        return _Slice.apply(w, blk)
    return w.narrow(0, blk.start, blk.size)
