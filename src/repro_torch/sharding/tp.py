"""The in-layer layout of a mesh step: heads, kv heads, the MLP hidden,
the vocabulary, ``d_inner`` and the SSD heads over ``model`` (the MoE
FFN's experts in ``sharding/ep.py``, on the same ``cst.tp``).

The reference declares it (``sharding/rules.py:ACT_RULES``: ``"heads"``,
``"kv_heads"``, ``"mlp"``, ``"vocab"``, ``"ssm_inner"`` over ``model``;
``models/attention.py``'s context-parallel branch where the heads do not
divide) and XLA's partitioner moves the values.  The port moves them
itself over ``torch.distributed``, as ``sharding/seq.py`` moves the
residual sequence; a rank's block of a dimension is a
``sharding.rules.ColBlock``.

Every tensor of a layer is either *whole* (the same bits on the ranks
of a model group, and, in the backward, the same whole gradient) or a
rank's *block*.  These functions keep that so, which keeps every
parameter's gradient whole and equal on the ranks of a model group: the
train step then reduces it over the batch axes only, as before.

* :class:`ColSlice`: whole -> block; the backward all-gathers the
  gradient's blocks (``tp.gather``);
* :class:`ColGather`: block -> whole (``tp.gather``); the backward keeps
  the gradient's block;
* :func:`enter`: a whole tensor that each rank uses only in part (the
  input of an ``exact`` column-parallel matmul, the whole K/V of GQA and
  of context-parallel attention, the SSD's B and C); the forward is the
  identity and the backward sums the ranks' partial gradients
  (``tp.sum``);
* :func:`row_sum`: the ranks' partial products of a row-parallel matmul
  summed (``tp.sum``); the backward is the identity (the sum is used
  whole);
* :func:`all_sum`: a sum whose result each rank uses only in part (the
  gated norm's sum of squares over ``d_inner``); both ways ``tp.sum``;
* :func:`vocab_nll`: the loss's log-softmax over a rank's vocabulary
  block: the max, the sum of exponentials and the label's logit reduced
  over ``model`` (``tp.vocab``); the backward needs no collective.

Every sum is exact copies of every rank's operand (an all-gather) added
in coordinate order (``sc.sharded.sum_in_order``), so the ranks hold the
same bits.  A sum over a span of ``m`` ranks gathers its operand in
``min(m, rows)`` pieces of rows, so no rank ever holds more than about
one operand's worth of the others' copies.  Every collective goes
through ``launch/mesh.py:all_gather``: it is timed as its tracer span
(``tp.gather``, ``tp.sum``, ``tp.vocab``) and recorded with that site on
a ``RecordingMesh``.  :func:`tp_collective_plan` counts them from the
shapes.
"""

from __future__ import annotations

import math

import torch

from repro_torch.launch.mesh import all_gather
from repro_torch.sc.sharded import sum_in_order
from repro_torch.sharding.rules import ColBlock, col_block

MODEL_AXES = ("model",)


# ---------------------------------------------------------------------------
# Moving values
# ---------------------------------------------------------------------------


def _stack(t, mesh, axes, span: str):
    """Every rank's ``t`` over ``axes`` stacked in row-major coordinate
    order: ``(span, *t.shape)``, bits copied exactly (minor axis
    first)."""
    out = t.contiguous()[None]
    for a in reversed(axes):
        out = all_gather(out, mesh, a, 0, span=span)
    return out


def _gather_dim(x, blk: ColBlock, dim: int, span: str = "tp.gather"):
    """The whole dimension ``dim`` from every rank's block ``x`` (one
    block a part: gathered on ``dim`` itself, no reordering copy)."""
    dim = dim % x.dim()
    if blk.parts == 1:
        out = x.contiguous()
        for a in reversed(blk.axes):
            out = all_gather(out, blk.mesh, a, dim, span=span)
        return out
    st = _stack(x, blk.mesh, blk.axes, span)  # (S, ..., width, ...)
    shape = list(x.shape)
    st = st.reshape(st.shape[0], *shape[:dim], blk.parts, blk.size,
                    *shape[dim + 1:])
    # (S, pre, parts, size, post) -> (pre, parts, S, size, post)
    st = st.movedim(0, dim + 1)
    return st.reshape(*shape[:dim], blk.length, *shape[dim + 1:])


def _block(x, blk: ColBlock, dim: int):
    """This rank's block of the whole ``x`` along ``dim`` (a copy)."""
    seg = blk.length // blk.parts
    parts = [x.narrow(dim, p * seg + blk.start, blk.size)
             for p in range(blk.parts)]
    out = parts[0] if blk.parts == 1 else torch.cat(parts, dim)
    return out.clone(memory_format=torch.contiguous_format)


class ColSlice(torch.autograd.Function):
    """Whole -> this rank's block; the backward gathers the gradient."""

    @staticmethod
    def forward(ctx, x, blk, dim):
        ctx.blk, ctx.dim = blk, dim
        return _block(x, blk, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.blk, ctx.dim), None, None


class ColGather(torch.autograd.Function):
    """This rank's block -> the whole; the backward keeps the block of
    the gradient (every rank's gradient of the whole is the same)."""

    @staticmethod
    def forward(ctx, x, blk, dim):
        ctx.blk, ctx.dim = blk, dim
        return _gather_dim(x, blk, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.blk, ctx.dim), None, None


def sum_over(t, mesh, axes, span: str = "tp.sum"):
    """``t`` summed over the ranks of ``axes`` in coordinate order, the
    same bits on every rank.  The rows (every dimension but the last,
    flattened) are gathered in ``min(ranks, rows)`` pieces."""
    n = math.prod(mesh.shape[a] for a in axes)
    flat = t.reshape(-1, t.shape[-1]) if t.dim() else t.reshape(1, 1)
    outs = [sum_in_order(list(_stack(piece, mesh, axes, span)))
            for piece in torch.tensor_split(flat, min(n, flat.shape[0]))]
    return torch.cat(outs).reshape(t.shape)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_over(g, ctx.mesh, ctx.axes), None, None


class _RowSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return sum_over(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return sum_over(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return sum_over(g, ctx.mesh, ctx.axes), None, None


def enter(x, blk: ColBlock):
    """``x`` (whole), used by each rank only in part from here on: the
    backward sums the ranks' partial gradients over ``blk``'s axes."""
    return _Enter.apply(x, blk.mesh, blk.axes)


def row_sum(x, blk: ColBlock):
    """The ranks' partials ``x`` summed over ``blk``'s axes; the result
    is used whole (its gradient passes through)."""
    return _RowSum.apply(x, blk.mesh, blk.axes)


def all_sum(x, blk: ColBlock):
    """The ranks' ``x`` summed over ``blk``'s axes, the result used by
    each rank only in part (the backward sums too)."""
    return _AllSum.apply(x, blk.mesh, blk.axes)


class VocabNLL(torch.autograd.Function):
    """Per-position negative log-likelihood from a rank's block of the
    float32 logits ``(..., width)`` over the vocabulary and the whole
    labels: ``logsumexp - logit[label]``, each reduced over the block's
    axes (the max; then the sum of exponentials beside the label's logit,
    which only its holder contributes).  The backward is the block of
    ``softmax - onehot``."""

    @staticmethod
    def forward(ctx, z, labels, blk):
        m = _stack(z.amax(dim=-1), blk.mesh, blk.axes,
                   "tp.vocab").amax(dim=0)
        s = torch.exp(z - m[..., None]).sum(dim=-1)
        lab = labels.to(torch.int64) - blk.start
        inside = (lab >= 0) & (lab < blk.size)
        zl = torch.gather(z, -1, lab.clamp(0, blk.size - 1)[..., None])
        zl = torch.where(inside, zl[..., 0], torch.zeros_like(s))
        tot = sum_in_order(list(_stack(torch.stack([s, zl], dim=-1),
                                       blk.mesh, blk.axes, "tp.vocab")))
        lse = m + torch.log(tot[..., 0])
        ctx.save_for_backward(z, lse, lab, inside)
        return lse - tot[..., 1]

    @staticmethod
    def backward(ctx, g):
        z, lse, lab, inside = ctx.saved_tensors
        gz = torch.exp(z - lse[..., None])
        hit = torch.zeros_like(gz).scatter_(
            -1, lab.clamp(0, z.shape[-1] - 1)[..., None],
            inside[..., None].to(gz.dtype))
        return g[..., None] * (gz - hit), None, None


def vocab_nll(z, labels, blk: ColBlock):
    return VocabNLL.apply(z, labels, blk)


# ---------------------------------------------------------------------------
# The layout of one mesh
# ---------------------------------------------------------------------------


class TensorParallel:
    """The in-layer layout over ``mesh``'s ``model`` axis
    (``make_constrain(...).tp``): :meth:`block` resolves a dimension to
    this rank's :class:`ColBlock`, or None where it stays whole."""

    def __init__(self, mesh, axes: tuple = MODEL_AXES):
        self.mesh = mesh
        self.axes = tuple(a for a in axes if mesh.shape.get(a, 1) > 1)

    @property
    def span(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.axes)

    def block(self, length: int, parts: int = 1):
        return col_block(self.mesh, self.axes, length, parts)

    def heads(self, cfg):
        """The attention's heads layout: ``"heads"`` where the query
        heads divide the span, else ``"cp"`` (context parallelism: the
        query sequence's block over ``model``, the reference's branch)."""
        return "heads" if cfg.n_heads % self.span == 0 else "cp"


def of(constrain):
    """The :class:`TensorParallel` of a ``make_constrain`` result, or
    None (no mesh, ``tensor_parallel=False``, or no live ``model``)."""
    return getattr(constrain, "tp", None)


# ---------------------------------------------------------------------------
# The plan: the collectives of one train step, from the shapes
# ---------------------------------------------------------------------------


class _Plan:
    def __init__(self, span: int):
        self.span = span
        self.out: dict = {}

    def add(self, site: str, nbytes: int, times: int = 1, count: int = 1):
        e = self.out.setdefault(site, {"count": 0, "bytes": 0})
        e["count"] += times * count
        e["bytes"] += times * nbytes

    def gather(self, numel_block: int, esize: int, times: int = 1):
        self.add("tp.gather", numel_block * esize, times)

    def sum(self, shape, esize: int, times: int = 1, site: str = "tp.sum"):
        rows = math.prod(shape[:-1]) if len(shape) else 1
        self.add(site, math.prod(shape) * esize, times,
                 count=min(self.span, rows))


def tp_collective_plan(cfg, mesh, batch: int, seq: int, *,
                       microbatches: int = 1, fsdp: bool = False) -> dict:
    """The in-layer collectives one train step makes on a rank of
    ``mesh`` for a global ``batch`` of ``seq`` positions: ``{site:
    {"count", "bytes"}}`` for ``tp.gather``, ``tp.sum`` and ``tp.vocab``,
    and for the MoE FFN's expert-parallel layout (``sharding/ep.py``)
    ``ep.gather`` (the experts' outputs), ``ep.sum`` (the dispatched
    input's gradient) and, in the replicated layout (``fsdp`` False),
    ``ep.grad`` (the expert leaves' gradients); empty without a live
    ``model`` axis.  Bytes are counted as each gather's operand, as the
    tracer's spans and a ``RecordingMesh`` count them.  It follows the
    layer code (``models/``): each checkpointed body's forward twice
    under ``remat="full"`` (the backward's recompute), each loss chunk's
    forward twice, every backward once."""
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.models import lm, moe

    tp = TensorParallel(mesh)
    if not tp.axes:
        return {}
    plan = _Plan(tp.span)
    dp = math.prod(mesh.shape[a] for a in batch_axes(mesh))
    rows = batch // (microbatches * dp)
    exact = cfg.sc_backend == "exact"
    act = torch.empty((), dtype=cfg.act_dtype).element_size()
    par = torch.empty((), dtype=cfg.param_dtype).element_size()
    fwd = 2 if cfg.remat == "full" else 1
    b, s, d = rows, seq, cfg.d_model

    def dense_cols(k: int, blk, *, bias=False):
        """A column-parallel matmul with k inputs: no forward collective;
        the backward gathers the output's gradient (SC) or the weight's
        and sums the input's (``exact``)."""
        if exact:
            plan.sum((b, s, k), act)
            plan.gather(k * blk.width, par)
            if bias:
                plan.gather(blk.width, par)
        else:
            plan.gather(b * s * blk.width, act)

    def dense_rows(n: int, blk, fw: int):
        """A row-parallel matmul with n outputs on the block ``blk`` of
        its inputs.  The last one of a checkpointed body runs its forward
        once (``fw`` 1): the recompute stops once it has every tensor the
        backward saved."""
        if exact:
            plan.sum((b, s, n), act, fw)
        plan.gather(blk.width * n, par)  # the weight's gradient

    def attention(fw):
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        if tp.heads(cfg) == "cp":
            blk = tp.block(s)
            if blk is None:
                return
            plan.gather(b * blk.size * h * hd, act)  # q slice's backward
            plan.sum((b, s, kv, hd), act, 2)  # k's and v's enter
            plan.gather(b * blk.size * h * hd, act, fw)  # the output
            return
        hb = tp.block(h * hd)
        dense_cols(d, hb, bias=cfg.qkv_bias)
        kb = tp.block(kv * hd) if kv % tp.span == 0 else None
        if kb is not None:
            dense_cols(d, kb, bias=cfg.qkv_bias)
            dense_cols(d, kb, bias=cfg.qkv_bias)
        else:  # k, v whole: each rank picks its q heads' kv heads
            plan.sum((b, s, kv, hd), act, 2)
        if cfg.qk_norm:  # the norm weights on the heads blocks
            plan.sum((hd,), par, 2 if kb is not None else 1)
        dense_rows(d, hb, fw)

    def mlp():
        fb = tp.block(cfg.d_ff)
        if fb is None:
            return
        swiglu = cfg.mlp_variant == "swiglu"
        dense_cols(d, tp.block(2 * cfg.d_ff, parts=2) if swiglu else fb)
        dense_rows(d, fb, 1)  # the body's last op

    def experts(fw):
        eb = tp.block(cfg.n_experts)
        if eb is not None:
            cap = moe.capacity(cfg, s)
            plan.add("ep.gather", b * eb.size * cap * d * act, fw)
            plan.sum((b, s, d), act, site="ep.sum")
            if not fsdp:  # wi's and wo's gradient blocks
                plan.add("ep.grad", eb.size * 3 * d * cfg.d_ff * par,
                         count=2)
        if cfg.shared_expert:
            mlp()

    def ssm(fw):
        hb = tp.block(cfg.ssm_heads)
        if hb is None:
            return
        ib = tp.block(cfg.d_inner)
        for blk in (ib, ib, hb):  # wz, wx, wdt
            dense_cols(d, blk)
        plan.gather(hb.width, par, 3)  # dt_bias, A_log, D
        plan.gather(cfg.ssm_conv * ib.width, par)  # conv_x
        plan.sum((b, s, cfg.ssm_state), act, 2)  # B's and C's enter
        if exact:
            plan.sum((b, s, 1), 4, fw + 1)  # the norm's sums, both ways
            plan.gather(ib.width, par)  # the norm's weight
            dense_rows(d, ib, 1)  # the body's last op
        else:  # ``out`` takes per-token keys: its input gathered whole
            plan.gather(b * s * ib.width, act, fw)

    for _ in range(microbatches):
        for _layer in range(lm.n_backbone_layers(cfg)):
            if cfg.family in lm.STATE_FAMILIES:
                ssm(fwd)
            else:
                attention(fwd)
                if cfg.family == "moe":
                    experts(fwd)
                else:
                    mlp()
        for _inv in range(lm.n_shared_invocations(cfg)):
            attention(fwd)
            mlp()
        vb = tp.block(cfg.vocab)
        if vb is not None:
            c = min(lm.LOSS_SEQ_CHUNK, s)
            chunks = s // c if s % c == 0 else 1
            c = s // chunks
            for _chunk in range(chunks):
                plan.add("tp.vocab", b * c * 4, 2)  # the max, twice
                plan.add("tp.vocab", b * c * 8, 2)  # the sums, twice
                if exact:
                    plan.sum((b, c, d), act)
                    plan.gather(d * vb.width, par)
                else:
                    plan.gather(b * c * vb.width, act)
    return plan.out
