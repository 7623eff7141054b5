"""The sequence layouts of activations: the residual stream's sequence
over ``model`` between the layers of a mesh train step, and the decode
cache's sequence over its axes in prefill and decode.

The reference declares them (``sharding/rules.py``: ``"resid_seq"`` over
``model``, the Megatron-style sequence parallelism of its mesh step;
``launch/specs.py:cache_shardings``: the KV cache's sequence over
``model``, or every axis for a batch of 1) and XLA's partitioner moves
the values.  The port moves them itself over ``torch.distributed``, as
``sharding/fsdp.py`` moves the parameters; a rank's block is a
``sharding.rules.SeqBlock``:

* :class:`SeqGather` all-gathers a rank's block of a tensor along its
  sequence dimension into the whole sequence, over the block's axes in
  coordinate order (bits copied exactly).  Its backward is this rank's
  block of the gradient, a local slice: the ranks of a model group hold
  the same rows and compute the same whole-sequence gradient (every SC
  call's K split merges over ``model``), so a reduce-scatter would
  scale the gradient by the ``model`` span;
* :class:`SeqSlice` keeps the rank's block of the whole sequence; its
  backward all-gathers the gradient's blocks;
* ``models/lm.py:encode`` runs each checkpointed layer as gather, the
  layer on the whole sequence, slice, so a checkpoint saves only the
  block and the backward's recompute gathers it again;
* :func:`stack_blocks` gathers the decode attention's per-block
  partials (``models/attention.py:chunk_decode_attention``), which are
  then merged in coordinate order;
* :func:`seq_collective_plan` and :func:`combine_plan` count those
  collectives from the shapes alone.

Every collective is timed as the tracer span ``seq.all_gather`` (the
combine's as ``seq.combine``) and recorded as an ``all-gather`` on a
``RecordingMesh``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.launch.mesh import all_gather, batch_axes
from repro_torch.models import lm
from repro_torch.sharding.fsdp import _record
from repro_torch.sharding.rules import resid_seq_axes, seq_block


def _gather(x, block, dim: int, span: str):
    """Every rank's block ``x`` concatenated on ``dim`` in the blocks'
    row-major order: the minor axis first, as ``Placement.gather``."""
    for a in reversed(block.axes):
        x = all_gather(x, block.mesh, a, dim, span=span)
    return x


def _block_of(x, block, dim: int):
    return x.narrow(dim, block.start, block.size).clone(
        memory_format=torch.contiguous_format)


class SeqGather(torch.autograd.Function):
    """A rank's sequence block -> the whole sequence; the backward keeps
    the block of the gradient (see the module doc)."""

    @staticmethod
    def forward(ctx, x, block, dim):
        ctx.block, ctx.dim = block, dim
        return _gather(x, block, dim, "seq.all_gather")

    @staticmethod
    def backward(ctx, g):
        return _block_of(g, ctx.block, ctx.dim), None, None


class SeqSlice(torch.autograd.Function):
    """The whole sequence -> this rank's block (a copy, so the whole can
    be freed); the backward all-gathers the gradient's blocks."""

    @staticmethod
    def forward(ctx, x, block, dim):
        ctx.block, ctx.dim = block, dim
        return _block_of(x, block, dim)

    @staticmethod
    def backward(ctx, g):
        return (_gather(g.contiguous(), ctx.block, ctx.dim, "seq.all_gather"),
                None, None)


def stack_blocks(t: torch.Tensor, block) -> torch.Tensor:
    """Every rank's ``t`` over the block's axes, stacked in coordinate
    order: ``(span, *t.shape)``, no autograd (the decode's combine)."""
    return _gather(t[None], block, 0, "seq.combine")


def _rank_rows(mesh, batch: int, microbatches: int) -> int:
    dp = math.prod(mesh.shape[a] for a in batch_axes(mesh))
    return batch // (microbatches * dp)


def _gathers(plan, block, nbytes: int, times: int) -> None:
    """``times`` gathers of a block of ``nbytes``: one an axis, the
    operand growing by each axis gathered (minor first)."""
    for a in reversed(block.axes):
        _record(plan, "all-gather", a, nbytes, times)
        nbytes *= block.mesh.shape[a]


def seq_collective_plan(cfg, mesh, batch: int, seq: int, *,
                        microbatches: int = 1) -> dict:
    """The sequence gathers one train step makes on a rank of ``mesh``
    for a global ``batch`` of ``seq`` positions: ``{"all-gather":
    {"count", "bytes"}, "by_axis": {"all-gather:axis": bytes}}`` (empty
    where the sequence stays whole), bytes counted as each gather's
    operand.  Each microbatch gathers the embedding's gradient once (its
    slice's backward), each checkpointed layer body (the backbone layers
    and zamba2's shared invocations) in its forward, again in the
    backward's recompute under ``remat="full"``, and its output's
    gradient, and the last layer's output once before the final norm."""
    block = seq_block(mesh, resid_seq_axes(mesh, seq), seq)
    if block is None:
        return {}
    rows = _rank_rows(mesh, batch, microbatches)
    nbytes = rows * block.size * cfg.d_model * torch.empty(
        (), dtype=cfg.act_dtype).element_size()
    bodies = lm.n_backbone_layers(cfg) + lm.n_shared_invocations(cfg)
    per_body = 3 if cfg.remat == "full" else 2
    plan: dict = {}
    _gathers(plan, block, nbytes, microbatches * (2 + per_body * bodies))
    return plan


def combine_plan(cfg, rows: int, block) -> dict:
    """The decode combine's gathers of one decode step on a rank holding
    ``rows`` rows of the cache's sequence ``block``: one an attention
    layer (the backbone's, or zamba2's shared invocations), each of every
    rank's float32 partials ``(rows, kv, group, 1, head_dim + 2)``;
    empty where the cache is whole."""
    if block is None:
        return {}
    layers = (lm.n_shared_invocations(cfg) if cfg.family in lm.STATE_FAMILIES
              else cfg.n_layers)
    nbytes = 4 * rows * cfg.n_heads * (cfg.resolved_head_dim + 2)
    plan: dict = {}
    _gathers(plan, block, nbytes, layers)
    return plan
