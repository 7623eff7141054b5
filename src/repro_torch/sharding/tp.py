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
rank's *block*.  These functions keep that so.  A weight the layer runs
on a block is either sliced from the whole leaf (its gradient gathered
back whole, equal on the model group: the replicated step and serving)
or arrives as the block (:func:`weight_blocks` lists them; the FSDP
step's gathers keep it, ``sharding/fsdp.py:keep_blocks``), its gradient
the block's (:func:`local`, :func:`is_block`).  For such blocks:

* :func:`to_parts` / :func:`from_parts`: a contiguous FSDP block <-> a
  ``parts`` block (SwiGLU's gate and up), one all-to-all
  (``launch/mesh.py:all_to_all``, bits as they are);
* :func:`cols_to_rows`: a block of a weight's columns -> its block of
  the rows with every column, the K block ``sc.sc_dot_sharded`` cuts
  (``tp.relayout``);
* :func:`lookup`: the embedding lookup on a vocabulary block, each
  token's row selected from its holder (:func:`select_over`,
  ``tp.lookup``).

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
through ``launch/mesh.py:all_gather`` (the relayouts through
``all_to_all``): it is timed as its tracer span (``tp.gather``,
``tp.sum``, ``tp.vocab``, ``tp.lookup``, ``tp.relayout``) and recorded
with that site on a ``RecordingMesh``.  :func:`tp_collective_plan`
counts them from the shapes.
"""

from __future__ import annotations

import math

import torch

from repro_torch.launch.mesh import all_gather, all_to_all
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
# Weights as a rank's block: relayouts, the vocabulary-parallel lookup
# ---------------------------------------------------------------------------


def local(t, blk, dim: int):
    """The weight ``t`` as this rank runs it on ``blk`` along ``dim``: the
    whole leaf sliced (serving, the replicated step: the backward
    gathers the gradient, :class:`ColSlice`), or the rank's block used as
    it comes (the FSDP step's gather keeps it,
    ``sharding/fsdp.py:keep_blocks``).  Any other size means the weights'
    layout and the activations' disagree, and raises."""
    if blk is None or is_block(t, blk, dim):
        return t
    return blk.slice(t, dim)


def is_block(t, blk, dim: int) -> bool:
    """Whether the weight ``t`` holds ``blk``'s block along ``dim`` (else
    it is whole; any other size raises, as :func:`local`)."""
    n = t.shape[dim]
    if blk is None or n == blk.length:
        return False
    if n == blk.width:
        return True
    raise ValueError(
        f"a weight of {n} along dimension {dim}: neither the whole "
        f"{blk.length} nor this rank's block of {blk.width}")


def _axis(blk: ColBlock) -> str:
    if len(blk.axes) != 1:
        raise ValueError(f"a relayout over {blk.axes}: one mesh axis only")
    return blk.axes[0]


def _move_units(t, blk: ColBlock, dim: int, held, wanted, span: str):
    """Along ``dim``, in units of ``blk.size``: every rank ``c`` holds the
    units ``held(c)`` and wants ``wanted(c)`` (both in local order); one
    all-to-all over ``blk``'s axis moves each unit, bits as they are,
    from its holder to the rank that wants it."""
    dim = dim % t.dim()
    me, u = blk.index, blk.size
    pos = {k: i for i, k in enumerate(held(me))}

    def cat(ts):
        return torch.cat(ts, dim) if ts else t.narrow(dim, 0, 0)

    pieces = [cat([t.narrow(dim, pos[k] * u, u) for k in wanted(c)
                   if k in pos]) for c in range(blk.span)]
    want = wanted(me)
    units, shapes = [], []
    for j in range(blk.span):
        theirs = set(held(j))
        units.append([k for k in want if k in theirs])
        shape = list(t.shape)
        shape[dim] = len(units[-1]) * u
        shapes.append(tuple(shape))
    got = all_to_all(pieces, blk.mesh, _axis(blk), shapes, span=span)
    at = {k: r.narrow(dim, i * u, u)
          for ks, r in zip(units, got) for i, k in enumerate(ks)}
    return torch.cat([at[k] for k in want], dim)


def to_parts(t, blk: ColBlock, dim: int, span: str = "tp.relayout"):
    """The rank's contiguous block of ``blk.length`` along ``dim`` (an
    FSDP shard's layout) -> its ``blk`` of ``blk.parts`` segments."""
    p, m = blk.parts, blk.span
    return _move_units(t, blk, dim,
                       lambda c: [c * p + q for q in range(p)],
                       lambda c: [q * m + c for q in range(p)], span)


def from_parts(t, blk: ColBlock, dim: int, span: str = "tp.relayout"):
    """:func:`to_parts`' inverse."""
    p, m = blk.parts, blk.span
    return _move_units(t, blk, dim,
                       lambda c: [q * m + c for q in range(p)],
                       lambda c: [c * p + q for q in range(p)], span)


def cols_to_rows(w, cols: ColBlock, span: str = "tp.relayout"):
    """``w`` ``(K, cols.width)``, the rank's block ``cols`` of the
    columns -> ``(K / span, cols.length)``, its block of the rows with
    every column in the whole leaf's order: the K block
    ``sc.sc_dot_sharded`` cuts for the rank (one all-to-all)."""
    m = cols.span
    kb = w.shape[0] // m
    got = all_to_all([w.narrow(0, c * kb, kb) for c in range(m)],
                     cols.mesh, _axis(cols), [(kb, cols.width)] * m,
                     span=span)
    if cols.parts == 1:
        return torch.cat(got, 1)
    st = torch.stack([g.reshape(kb, cols.parts, cols.size) for g in got], 2)
    return st.reshape(kb, cols.length)


def select_over(t, owner, mesh, axes, span: str):
    """Per row of ``t`` (every dimension but the last, flattened), the
    row of the rank at coordinate ``owner`` over ``axes``: exact copies
    of every rank's rows, selected (no float sum, so a ``-0.0`` stays).
    Gathered in ``min(ranks, rows)`` pieces, as :func:`sum_over`."""
    n = math.prod(mesh.shape[a] for a in axes)
    flat = t.reshape(-1, t.shape[-1])
    own = owner.reshape(-1)
    outs = []
    for piece, o in zip(torch.tensor_split(flat, min(n, flat.shape[0])),
                        torch.tensor_split(own, min(n, flat.shape[0]))):
        st = _stack(piece, mesh, axes, span)  # (n, rows, width)
        idx = o[None, :, None].expand(1, *piece.shape)
        outs.append(torch.gather(st, 0, idx)[0])
    return torch.cat(outs).reshape(t.shape)


def add_rows(n: int, index, src):
    """``n`` zero rows with ``src``'s row i added to row ``index[i]``, a
    repeated index's rows summed in index order, the same bits from run
    to run: on CUDA by ``index_put_`` accumulating (it sorts the indices
    first; ``index_add_`` adds with atomics in a varying order), else by
    ``index_add_`` (serial on the CPU, where an accumulating
    ``index_put_`` adds large inputs in parallel with atomics)."""
    out = src.new_zeros((n, src.shape[-1]))
    if src.is_cuda:
        return out.index_put_((index,), src, accumulate=True)
    return out.index_add_(0, index, src)


class VocabLookup(torch.autograd.Function):
    """Token rows from this rank's block ``(blk.width, d)`` of an
    embedding table: each rank looks up the tokens in its vocabulary
    block, and the model group takes each token's row from its holder
    (:func:`select_over`, ``tp.lookup``).  The block's gradient is the
    rank's own tokens' rows of the output's gradient added in
    (:func:`add_rows`); the output's gradient is whole and equal on the
    model group, so no collective runs."""

    @staticmethod
    def forward(ctx, table, tokens, blk):
        tok = tokens.to(torch.int64)
        lab = tok - blk.start
        inside = (lab >= 0) & (lab < blk.size)
        rows = table[lab.clamp(0, blk.size - 1)]
        ctx.save_for_backward(lab, inside)
        ctx.n = table.shape[0]
        return select_over(rows, tok // blk.size, blk.mesh, blk.axes,
                           "tp.lookup")

    @staticmethod
    def backward(ctx, g):
        lab, inside = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        # the other ranks' tokens land on a spare row, dropped
        row = torch.where(inside, lab, ctx.n).reshape(-1)
        return add_rows(ctx.n + 1, row, g2)[:ctx.n], None, None


def lookup(table, tokens, blk):
    """``table[tokens]``: on a whole table a plain lookup; on this rank's
    vocabulary block ``blk`` (:func:`is_block`) the vocabulary-parallel
    lookup (:class:`VocabLookup`)."""
    if not is_block(table, blk, 0):
        return table[tokens.long()]
    return VocabLookup.apply(table, tokens, blk)


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


def weight_blocks(cfg, tp, *, train: bool = True) -> dict:
    """``{path: (dim, ColBlock)}``: each parameter leaf (paths as in
    ``lm.lm_param_specs``; a layer's leaves without the layer axis, whose
    ``dim`` does not count it) that the layer code runs on this rank's
    block of one dimension under the in-layer layout ``tp``, so that
    the FSDP step can gather it as that block
    (``sharding/fsdp.py:keep_blocks``).  It follows the layer code's own
    resolution (``models/``); a leaf not listed runs whole:

    * the context-parallel branch (the heads do not divide the span):
      every attention leaf;
    * kv heads that do not divide the span: ``wk`` / ``wv`` / ``bk`` /
      ``bv``;
    * calls with per-row keys, never split (``sc/sharded.py``): the SSM
      projections and ``out`` / ``norm`` on the SC substrate;
    * on the SC substrate a column-parallel leaf whose contraction the
      span does not divide (its K block cannot be cut).

    SwiGLU's ``wi`` runs on a ``parts=2`` block.  ``train=False`` (the
    prefill and decode paths) lists the expert leaves alone."""
    from repro_torch.models import lm

    out: dict = {}
    if tp is None:
        return out
    sc_on = cfg.sc_backend != "exact"
    d = cfg.d_model

    def add(path, dim, blk):
        if blk is not None:
            out[path] = (dim, blk)

    def cols(path, blk, k=d):
        if blk is not None and not (sc_on and k % tp.span):
            add(path, 1, blk)
            return True
        return False

    def attention(pre):
        if tp.heads(cfg) != "heads":
            return
        hd = cfg.resolved_head_dim
        hb = tp.block(cfg.n_heads * hd)
        if cols(pre + ("wq",), hb) and cfg.qkv_bias:
            add(pre + ("bq",), 0, hb)
        add(pre + ("wo",), 0, hb)
        if cfg.n_kv_heads % tp.span == 0:
            kb = tp.block(cfg.n_kv_heads * hd)
            for w, b in (("wk", "bk"), ("wv", "bv")):
                if cols(pre + (w,), kb) and cfg.qkv_bias:
                    add(pre + (b,), 0, kb)

    def mlp(pre):
        fb = tp.block(cfg.d_ff)
        if fb is None:
            return
        cols(pre + ("wi",), tp.block(2 * cfg.d_ff, parts=2)
             if cfg.mlp_variant == "swiglu" else fb)
        add(pre + ("wo",), 0, fb)

    def ssm(pre):
        hb = tp.block(cfg.ssm_heads)
        if hb is None:
            return
        ib = tp.block(cfg.d_inner)
        for name in ("dt_bias", "A_log", "D"):
            add(pre + (name,), 0, hb)
        add(pre + ("conv_x",), 1, ib)
        if not sc_on:
            cols(pre + ("wz",), ib)
            cols(pre + ("wx",), ib)
            cols(pre + ("wdt",), hb)
            add(pre + ("norm",), 0, ib)
            add(pre + ("out",), 0, ib)

    if cfg.family == "moe":
        eb = tp.block(cfg.n_experts)
        add(("blocks", "ffn", "wi"), 0, eb)
        add(("blocks", "ffn", "wo"), 0, eb)
    if not train:
        return out
    if cfg.family in lm.STATE_FAMILIES:
        ssm(("blocks", "ssm"))
    else:
        attention(("blocks", "attn"))
        if cfg.family != "moe":
            mlp(("blocks", "ffn"))
        elif cfg.shared_expert:
            mlp(("blocks", "ffn", "shared"))
    if cfg.family == "hybrid":
        attention(("shared", "attn"))
        mlp(("shared", "mlp"))
    vb = tp.block(cfg.vocab)
    if cfg.tie_embeddings:
        if vb is not None and not (sc_on and d % tp.span):
            add(("embed", "table"), 0, vb)
    else:
        add(("embed", "table"), 0, vb)
        cols(("unembed",), vb)
    return out


# ---------------------------------------------------------------------------
# The plan: the collectives of one train step, from the shapes
# ---------------------------------------------------------------------------


class _Plan:
    def __init__(self, span: int):
        self.span = span
        self.out: dict = {}

    def add(self, site: str, nbytes: int, times: int = 1, count: int = 1):
        if not times:
            return
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
    ``model`` axis.  Under ``fsdp`` the leaves of :func:`weight_blocks`
    arrive as their blocks: their gradients need no gather; an SC
    column-parallel call relays its block to its K block in each forward
    (``tp.relayout``, an all-to-all) and gathers its input's gradient's
    K blocks beside its output's gradient; the embedding table's lookup
    selects each token's row over ``model`` (``tp.lookup``).
    Bytes are counted as each collective's operand, as the tracer's
    spans and a ``RecordingMesh`` count them.  It follows the layer code
    (``models/``): each checkpointed body's forward twice under
    ``remat="full"`` (the backward's recompute), each loss chunk's
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
    kept = weight_blocks(cfg, tp) if fsdp else {}

    def dense_cols(k: int, blk, path, fw: int, *, bias=False, n=None):
        """A column-parallel matmul with k inputs on ``n`` rows (default
        ``b·s``): no forward collective on a whole weight; the backward
        gathers the output's gradient (SC) or the weight's and sums the
        input's (``exact``).  A kept block: the input's sum alone, and on
        SC the block's relayout in each forward (``fw`` of them)."""
        n = b * s if n is None else n
        if path in kept and not exact:
            plan.add("tp.relayout", k * blk.width * par, fw)
            plan.gather(n * blk.width, act)  # the output's gradient
            plan.gather(n * k // tp.span, act)  # the input's
        elif path in kept:
            plan.sum((n, k), act)
        elif exact:
            plan.sum((n, k), act)
            plan.gather(k * blk.width, par)
            if bias:
                plan.gather(blk.width, par)
        else:
            plan.gather(n * blk.width, act)

    def dense_rows(n: int, blk, fw: int, path):
        """A row-parallel matmul with n outputs on the block ``blk`` of
        its inputs.  The last one of a checkpointed body runs its forward
        once (``fw`` 1): the recompute stops once it has every tensor the
        backward saved."""
        if exact:
            plan.sum((b, s, n), act, fw)
        if path not in kept:
            plan.gather(blk.width * n, par)  # the weight's gradient

    def attention(fw, pre):
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
        dense_cols(d, hb, pre + ("wq",), fw, bias=cfg.qkv_bias)
        kb = tp.block(kv * hd) if kv % tp.span == 0 else None
        if kb is not None:
            dense_cols(d, kb, pre + ("wk",), fw, bias=cfg.qkv_bias)
            dense_cols(d, kb, pre + ("wv",), fw, bias=cfg.qkv_bias)
        else:  # k, v whole: each rank picks its q heads' kv heads
            plan.sum((b, s, kv, hd), act, 2)
        if cfg.qk_norm:  # the norm weights on the heads blocks
            plan.sum((hd,), par, 2 if kb is not None else 1)
        dense_rows(d, hb, fw, pre + ("wo",))

    def mlp(pre):
        fb = tp.block(cfg.d_ff)
        if fb is None:
            return
        swiglu = cfg.mlp_variant == "swiglu"
        dense_cols(d, tp.block(2 * cfg.d_ff, parts=2) if swiglu else fb,
                   pre + ("wi",), fwd)
        dense_rows(d, fb, 1, pre + ("wo",))  # the body's last op

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
            mlp(("blocks", "ffn", "shared"))

    def ssm(fw):
        hb = tp.block(cfg.ssm_heads)
        if hb is None:
            return
        ib = tp.block(cfg.d_inner)
        pre = ("blocks", "ssm")
        for blk, name in ((ib, "wz"), (ib, "wx"), (hb, "wdt")):
            dense_cols(d, blk, pre + (name,), fw)
        small = [pre + (n,) for n in ("dt_bias", "A_log", "D")]
        plan.gather(hb.width, par, sum(p not in kept for p in small))
        if pre + ("conv_x",) not in kept:
            plan.gather(cfg.ssm_conv * ib.width, par)
        plan.sum((b, s, cfg.ssm_state), act, 2)  # B's and C's enter
        if exact:
            plan.sum((b, s, 1), 4, fw + 1)  # the norm's sums, both ways
            if pre + ("norm",) not in kept:
                plan.gather(ib.width, par)  # the norm's weight
            dense_rows(d, ib, 1, pre + ("out",))  # the body's last op
        else:  # ``out`` takes per-token keys: its input gathered whole
            plan.gather(b * s * ib.width, act, fw)

    for _ in range(microbatches):
        vb = tp.block(cfg.vocab)
        if ("embed", "table") in kept and cfg.frontend != "embeddings":
            plan.sum((b, s, d), par, site="tp.lookup")
        for _layer in range(lm.n_backbone_layers(cfg)):
            if cfg.family in lm.STATE_FAMILIES:
                ssm(fwd)
            else:
                attention(fwd, ("blocks", "attn"))
                if cfg.family == "moe":
                    experts(fwd)
                else:
                    mlp(("blocks", "ffn"))
        for _inv in range(lm.n_shared_invocations(cfg)):
            attention(fwd, ("shared", "attn"))
            mlp(("shared", "mlp"))
        if vb is not None:
            c = min(lm.LOSS_SEQ_CHUNK, s)
            chunks = s // c if s % c == 0 else 1
            c = s // chunks
            unembed = (("embed", "table") if cfg.tie_embeddings
                       else ("unembed",))
            if unembed in kept and not exact:  # once for every chunk
                plan.add("tp.relayout", d * vb.width * par)
            for _chunk in range(chunks):
                plan.add("tp.vocab", b * c * 4, 2)  # the max, twice
                plan.add("tp.vocab", b * c * 8, 2)  # the sums, twice
                dense_cols(d, vb, unembed, 0, n=b * c)
    return plan.out
