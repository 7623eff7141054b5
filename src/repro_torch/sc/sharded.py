"""Mesh-sharded SC execution: one ``sc_dot`` split over device-mesh axes.

Port of ``repro.sc.sharded`` onto ``torch.distributed``.  The design is
SPMD: every rank of a :class:`~repro_torch.launch.mesh.DeviceMesh` runs
the same program on the same replicated operands, and a sharded call
splits only its own SC contraction:

* the flattened row dimension M of ``x`` over the *batch* axes
  (``("pod", "data")`` by default): rank (b, c) takes rows block b;
* the contraction dimension K over the *contract* axes (``("model",)``):
  it takes K block c, pop-counts its own slice of the K products, and
  the partial signed accumulations merge with a SUM over the contract
  group, as per-subarray POPCOUNTs merge through the adder tree (§IV);
* then every rank gathers the row blocks over the batch group, so each
  ends with the whole ``(M, N)`` product, as the reference's
  ``shard_map`` output is.

Training holds only its own rows (``ScShardRules.local_rows``): rank
(b, c) is handed row block b already, the rows of its batch shard, since
``lm_loss`` flattens ``(batch, seq)`` batch-major; it runs the same K
block and SUM merge, and gathers nothing, so its output is its own row
block of the product.  Rules are resolved against the global M (the
local M times the span of the mesh's batch axes), so a rank drops an
axis exactly where the reference does; a call whose rules would leave a
batch axis of the mesh unsplit would need every row on every rank, and
raises instead of gathering.

Both merges are exact copies of every rank's block (an integer SUM over
zero-padded slots, the only collective, which gloo and NCCL both run on
CUDA tensors), and the partial accumulations are then added in
coordinate order, as XLA's ``psum`` adds them on the reference's CPU
devices: so every rank holds the same bits, and they are the
reference's.

RNG semantics are the reference's: every rank folds the caller's key
with its coordinate along each live axis, in the order ``rules.batch +
rules.contract`` (``fold_in(key, axis_index(ax))``).  Axes of size one,
absent axes and axes that do not divide their dimension are dropped by
:func:`resolve_rules` and do not perturb the key, so a trivial mesh (or
rules naming no live axis) is exactly ``sc_dot(key, x, w, cfg)``.

Gradients: the straight-through ``autograd.Function`` of ``sc_dot``
wraps the whole sharded call, so the gradient is the exact-product
jacobian of the full operands (``g @ wᵀ``, ``xᵀ @ g``), which is what
the reference's ``psum`` transposes to.  Under ``local_rows`` it is the
jacobian of the rank's rows (``g_local @ wᵀ``, ``x_localᵀ @ g_local``):
w's part is partial over the batch group, and the train step's gradient
all-reduce completes it.

``models/layers.py:dense`` routes a one-key stochastic matmul here
whenever a :func:`use_mesh` scope is active.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import torch

from repro_torch.launch.mesh import all_reduce, batch_axes, collective_span
from repro_torch.sc import ctr_rng
from repro_torch.sc.config import ScConfig
from repro_torch.sc.registry import _dispatch, _StraightThrough, sc_dot


@dataclasses.dataclass(frozen=True)
class ScShardRules:
    """Which mesh axes shard an ``sc_dot``.

    ``batch`` axes split the flattened row dimension M of ``x`` (pure
    data parallelism); ``contract`` axes split the contraction dimension
    K (the partial accumulations merge with a SUM).  Axis names that are
    absent from the mesh, have size one, or do not divide their
    dimension are dropped per call by :func:`resolve_rules`.

    ``local_rows``: ``x`` holds only this rank's rows, its block over
    the mesh's batch axes (``launch.mesh.batch_axes``), and the output
    is its block of the product (training's data parallelism).

    ``contract_local``: ``x`` and ``w`` hold only this rank's block of
    the contraction over the contract axes (a row-parallel layer of the
    in-layer layout, ``sharding/tp.py``): the call takes them as its K
    block as they are, which is the block it would cut from the whole.

    ``w_local``: ``w`` alone holds this rank's K block (every column) and
    ``x`` the whole contraction (a column-parallel layer whose weight
    arrives as its block of the columns, relaid to its rows by
    ``sharding.tp.cols_to_rows``); the call cuts ``x``'s K block as
    usual.  Forward only: the caller takes the gradient itself.
    """

    batch: tuple = ("pod", "data")
    contract: tuple = ("model",)
    local_rows: bool = False
    contract_local: bool = False
    w_local: bool = False


DEFAULT_RULES = ScShardRules()


def resolve_rules(mesh, m: int, k: int,
                  rules: ScShardRules | None = None) -> ScShardRules:
    """Concretize ``rules`` against ``mesh`` and the call shape: keep
    only axes present in the mesh with size > 1 whose product divides
    the dimension they shard (M for batch axes, K for contract axes)."""
    rules = rules if rules is not None else DEFAULT_RULES
    sizes = dict(mesh.shape)

    def live(axes, dim):
        kept = []
        span = 1
        for ax in axes:
            sz = sizes.get(ax, 1)
            if sz > 1 and dim % (span * sz) == 0:
                kept.append(ax)
                span *= sz
        return tuple(kept)

    return ScShardRules(batch=live(tuple(rules.batch), m),
                        contract=live(tuple(rules.contract), k),
                        local_rows=rules.local_rows,
                        contract_local=rules.contract_local,
                        w_local=rules.w_local)


def _axis_span(mesh, axes) -> int:
    sizes = dict(mesh.shape)
    return math.prod(sizes[a] for a in axes) if axes else 1


def shard_counts(mesh, m: int, k: int,
                 rules: ScShardRules | None = None) -> tuple:
    """(batch shards, contract shards) a call would actually split into."""
    r = resolve_rules(mesh, m, k, rules)
    return _axis_span(mesh, r.batch), _axis_span(mesh, r.contract)


def _coord(mesh, axes) -> int:
    """This rank's row-major block index over ``axes``."""
    c = 0
    for ax in axes:
        c = c * mesh.shape[ax] + mesh.coords[ax]
    return c


def _gather(t, mesh, axes):
    """Every rank's ``t`` along ``axes``, stacked in block order:
    ``(span, *t.shape)``.  One integer SUM over zero-padded slots per
    axis, minor axis first, so the bits are copied exactly (float32
    through its int32 view, integer tensors in their own type)."""
    word = t.dtype if not t.is_floating_point() else torch.int32
    out = t.contiguous().view(word)[None]
    for ax in reversed(axes):
        n = mesh.shape[ax]
        if n == 1:
            continue
        buf = torch.zeros((n, *out.shape), dtype=word, device=out.device)
        buf[mesh.coords[ax]] = out
        all_reduce(buf, mesh, ax)
        out = buf.reshape(n * out.shape[0], *out.shape[1:])
    return out.view(t.dtype)


def sum_in_order(parts):
    """``parts[0] + parts[1] + ...`` in coordinate order, as XLA's
    ``psum`` adds on the reference's CPU devices."""
    y = parts[0]
    for p in parts[1:]:
        y = y + p
    return y


def _sharded_dispatch(key, x2, w, cfg, *, mesh, rules):
    """This rank's block through the registry's dispatch, then the SUM
    over the contract axes and (unless the rows are local) the gather
    over the batch axes."""
    m, k = x2.shape
    if rules.contract_local:  # the rank's K block already
        cols, c = k, 0
    else:
        cols = k // _axis_span(mesh, rules.contract)
        c = _coord(mesh, rules.contract)
    if rules.local_rows:
        rows, b = m, 0
    else:
        rows, b = m // _axis_span(mesh, rules.batch), _coord(mesh, rules.batch)
    xs = x2[b * rows:(b + 1) * rows, c * cols:(c + 1) * cols]
    ws = w if rules.w_local else w[c * cols:(c + 1) * cols]
    for ax in rules.batch + rules.contract:
        key = ctr_rng.fold_in(key, mesh.coords[ax])
    y = _dispatch(key, xs, ws, cfg)
    if rules.contract:
        span = _axis_span(mesh, rules.contract)
        with collective_span("sc.merge", y, axes=rules.contract,
                                         bytes=4 * span * y.numel()):
            y = sum_in_order(_gather(y, mesh, rules.contract))
    if rules.batch and not rules.local_rows:
        span = _axis_span(mesh, rules.batch)
        with collective_span("sc.merge", y, axes=rules.batch,
                                         bytes=4 * span * y.numel()):
            y = _gather(y, mesh, rules.batch).reshape(m, -1)
    return y


def _resolve_local(mesh, m: int, k: int, rules: ScShardRules):
    """``resolve_rules`` for a call holding this rank's rows: against the
    global M, and every batch axis of the mesh must stay live."""
    split = batch_axes(mesh)
    r = resolve_rules(mesh, m * _axis_span(mesh, split), k, rules)
    if r.batch != split:
        raise ValueError(
            f"sc_dot_sharded: this rank holds {m} rows, its block over the "
            f"mesh's batch axes {split} of {dict(mesh.shape)}, but the rules "
            f"{rules} shard the rows over {r.batch}: the call would need "
            "every row on every rank (a row gather)")
    return r


def sc_dot_sharded(key, x, w, cfg: ScConfig = ScConfig(), *, mesh,
                   rules: ScShardRules | None = None):
    """``x @ w`` through the SC substrate, sharded over ``mesh``.

    x: (..., K) float32; w: (K, N) float32, both whole on every rank;
    returns (..., N) float32, whole on every rank, exactly like
    ``sc_dot``.  Leading dims of ``x`` flatten to M, which shards over
    ``rules.batch``; K shards over ``rules.contract``.  When no axis
    survives :func:`resolve_rules` this is ``sc_dot(key, x, w, cfg)``.
    Under ``rules.local_rows`` x holds this rank's rows and the result
    is their rows of the product; under ``rules.contract_local`` x and
    w hold this rank's K block (the straight-through gradient is then
    the block's: ``g @ w_blockᵀ``, ``x_blockᵀ @ g``).
    """
    lead = x.shape[:-1]
    k_dim = x.shape[-1]
    m = math.prod(lead) if lead else 1
    rules = rules if rules is not None else DEFAULT_RULES
    k_whole = k_dim
    if rules.contract_local:
        k_whole = k_dim * _axis_span(mesh, tuple(
            a for a in rules.contract if mesh.shape.get(a, 1) > 1))
    if rules.local_rows:
        r = _resolve_local(mesh, m, k_whole, rules)
    else:
        r = resolve_rules(mesh, m, k_whole, rules)
    if rules.contract_local and k_dim * _axis_span(mesh, r.contract) \
            != k_whole:
        raise ValueError(
            f"sc_dot_sharded: x holds a contraction block of {k_dim} over "
            f"{rules.contract}, but the rules split K {k_whole} over "
            f"{r.contract}")
    if rules.w_local:
        if w.shape[0] * _axis_span(mesh, r.contract) != k_whole or \
                not r.contract:
            raise ValueError(
                f"sc_dot_sharded: w holds a contraction block of "
                f"{w.shape[0]}, but the rules split K {k_whole} over "
                f"{r.contract}")
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            raise ValueError("sc_dot_sharded: w_local has no gradient; "
                             "the caller takes the block's")
    if not r.batch and not r.contract:
        return sc_dot(key, x, w, cfg)
    n_shards = _axis_span(mesh, r.batch) * _axis_span(mesh, r.contract)
    dispatch = functools.partial(_sharded_dispatch, mesh=mesh, rules=r)
    with shard_scope(n_shards):
        y = _StraightThrough.apply(x.reshape(m, k_dim), w, key, cfg,
                                   dispatch)
    return y.reshape(*lead, w.shape[-1])


# ---------------------------------------------------------------------------
# Ambient mesh scope — what makes dense() route here with no caller changes
# ---------------------------------------------------------------------------

_MESH_STACK: list = []


@contextlib.contextmanager
def use_mesh(mesh, rules: ScShardRules | None = None):
    """Scope within which ``models.layers.dense`` routes every one-key
    stochastic matmul through :func:`sc_dot_sharded` on ``mesh``."""
    _MESH_STACK.append((mesh, rules))
    try:
        yield mesh
    finally:
        _MESH_STACK.pop()


def active_mesh():
    """(mesh, rules) of the innermost :func:`use_mesh`, or ``None``."""
    return _MESH_STACK[-1] if _MESH_STACK else None


# ---------------------------------------------------------------------------
# Shard multiplicity scope — read by the `array` backend's trace records
# ---------------------------------------------------------------------------

_SHARD_COUNT: list = [1]


@contextlib.contextmanager
def shard_scope(n: int):
    """Mark that ``sc_dot`` dispatches inside run as one of ``n``
    concurrent mesh shards: the ``array`` backend stamps each CallRecord
    with this multiplicity (its shape is one shard's), so the accountant
    merges the shards as concurrent banks, and multiplies the fault
    census by it."""
    _SHARD_COUNT.append(n)
    try:
        yield
    finally:
        _SHARD_COUNT.pop()


def current_shard_count() -> int:
    return _SHARD_COUNT[-1]
