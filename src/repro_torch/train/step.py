"""The train step: straight-through gradients of ``lm.lm_loss``,
microbatched accumulation, data parallelism over a device mesh, the
optional cross-pod int8 gradient compression, and the AdamW update.

Port of ``repro.train.step``.  ``make_train_step`` returns a
``step(state, batch) -> (state, metrics)`` function; PyTorch runs it
eagerly, so there is no ``jit`` around it.  Every family trains: the
attention stacks, MoE, the SSM and hybrid families (autograd through
``ssd_chunked``, the causal conv and zamba2's shared block), and the
audio family on frame embeddings (``data.make_embedding_batch``).

On a mesh (``launch/mesh.py:DeviceMesh``, one process a rank) the step
is SPMD and numerically the reference's mesh step, the single-device
step with every one-key SC matmul sharded:

* every rank is handed the GLOBAL batch and keeps its rows: with ``n``
  microbatches, rank (pod, data) takes row block ``(pod, data)`` of
  each microbatch, ``batch.reshape(n, dp, b / (n·dp), ...)[:, d]``
  (under the cross-pod compression the pods split the batch first, as
  the reference's ``shard_map`` over ``pod`` does); a batch that does
  not divide raises;
* everything per row (embedding, norms, attention, the loss chunks)
  runs on those rows alone; each one-key SC matmul runs under
  ``sc.use_mesh`` with ``local_rows`` rules: the rank's K block over
  ``model``, its key folded with its coordinates, the partial sums
  merged over ``model`` in coordinate order, no row gather;
* a rank's loss is the mean over its tokens; the loss and every
  gradient leaf are then summed over the batch group (``pod`` x
  ``data``) and divided by its span, before ``adamw_update``, so the
  grad-norm clip sees the full gradient and every rank applies the same
  update to its replica of the parameters (parameters and optimizer
  state stay whole on every rank);
* with ``cross_pod_compress`` and a ``pod`` axis the sum runs over
  ``data`` only and the pods exchange int8 gradients with error
  feedback (``distributed/compression.py``; ``state["ef"]`` must hold
  :func:`~repro_torch.distributed.init_error_feedback`'s residual).

Between layers each rank holds only its block of the residual stream's
sequence over ``model`` (the reference's ``ACT_RULES["resid_seq"]``,
Megatron-style sequence parallelism; ``sharding/seq.py``): each
checkpointed layer all-gathers the whole sequence of its rows, runs on
it and keeps its block, so the checkpoints hold ``1/model`` of the
sequence; a sequence that does not divide stays whole
(:func:`make_constrain`).  The ranks of a model group compute the same
values either way, so the step is the whole-sequence step bit for bit.

Inside each layer the step lays the reference's in-layer axes out over
``model`` (``sharding/tp.py``, ``cst.tp``): each rank computes its block
of the heads (or, where the heads do not divide, of the query sequence:
context parallelism), of the MLP hidden, of the loss's vocabulary, of
the SSM's ``d_inner`` and heads, and of the MoE FFN's experts
(``sharding/ep.py``: expert parallelism); every parameter's gradient
stays whole and equal on the ranks of a model group, so the reductions
below are unchanged.  On the SC substrate every SC call sees the whole
layout's operands (the forward is the whole layout's bit for bit); on
``exact`` the row-parallel sums reorder float additions.

``TrainConfig(fsdp=True)`` is the reference's FSDP ∘ TP layout
(``sharding/fsdp.py``): ``params``, ``m`` and ``v`` (and the residual)
hold only the rank's shard of each leaf (``train_state_init(...,
mesh=)``); the step gathers the leaves outside the layer stack once and
each layer's inside its checkpointed function
(:func:`make_param_constrain`; the expert leaves of the expert-parallel
layout over ``data`` only, each rank keeping its experts' block); the
gradients arrive as the shards' gradients, reduced by the gathers'
backward (a reduce-scatter over ``data``, an all-reduce over ``pod``),
so only the loss is all-reduced here; AdamW's norm and its int8 scales
reduce over the ranks holding distinct shards, and the compression's
scales are each leaf's.  Values
are the replicated layout's; only where they live and which collectives
move them change.

A trivial mesh (a world of one) is the single-device step bit for bit,
in either layout.

RNG: the step's root key is ``fold_in(PRNGKey(seed), opt.step)`` (none
under the ``exact`` backend), microbatch ``i`` folds ``i`` into it, and
the model folds layers, chunks and sites below that — the reference's
key chain, so both packages draw the same noise for the same step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from repro_torch import resolve_device, sc
from repro_torch.distributed import compression
from repro_torch.launch.mesh import all_reduce, batch_axes, collective_span
from repro_torch.models import lm
from repro_torch.models import params as params_lib
from repro_torch.models.params import _leaves, _set, tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.sc import ctr_rng
from repro_torch.sharding import fsdp as fsdp_lib
from repro_torch.sharding import act_spec, param_shardings, sc_shard_rules
from repro_torch.sharding import rules
from repro_torch.sharding import tp as tp_lib


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    cross_pod_compress: bool = False
    seed: int = 0
    # on a mesh: hold each rank's FSDP ∘ TP shard of the parameters and
    # optimizer state (False: every leaf whole on every rank)
    fsdp: bool = False


def make_constrain(mesh, *, seq_parallel: bool = True,
                   tensor_parallel: bool = True):
    """The activation constraint of a mesh step (None without a mesh):
    the reference's ``make_constrain``, which lays activations out by
    ``ACT_RULES``, for the layouts the port moves itself.

    ``cst(v, *logical_axes)`` returns ``v``.  It checks that a tensor
    whose first logical axis is ``"batch"`` holds this rank's rows of
    the batch (``cst.batch``, set by the step), and carries
    ``cst.axis_sizes`` for model code that adapts to the mesh.  It also
    carries the sequence layouts (``sharding/seq.py``):

    * ``cst.seq_axes``: the mesh axes ``"resid_seq"`` maps to
      (``model``); ``cst.seq_block(s)`` is this rank's
      ``sharding.rules.SeqBlock`` of a residual stream of ``s``
      positions between layers, or None where it stays whole (no live
      axis, or ``s`` does not divide: the reference's fallback);
    * ``cst.cache``: the block of the decode cache's sequence the
      caller's cache holds (None: whole), set by
      ``cst.lay_out_cache(batch, max_len)`` for a global ``batch`` from
      ``sharding.rules.cache_seq_axes`` (``cache_shardings``' axes);
      ``lm.init_cache`` / ``prefill`` / ``decode_step`` read it.

    ``seq_parallel=False`` keeps both sequences whole: the layout of
    earlier steps, which no entry point asks for (the tests compare the
    two with it).

    The in-layer layout (``sharding/tp.py``): ``cst.tp`` is the
    ``sharding.tp.TensorParallel`` of the mesh's ``model`` axis (None
    where it has one rank): the model code lays the heads / kv heads,
    the MLP hidden, the loss's vocabulary, the SSM's ``d_inner`` and
    heads and the MoE FFN's experts out over it inside each layer, and
    takes the context-parallel attention branch where the heads do not
    divide; every dimension that does not divide stays whole.
    ``lay_out_cache`` also sets ``cst.state`` (the same object): the SSM
    decode state holds the rank's block of the heads.
    ``tensor_parallel=False`` keeps every in-layer tensor whole: the
    sequence layouts alone, bit for bit, which only the tests and
    ``chip_smoke.py`` ask for (to compare with)."""
    if mesh is None:
        return None

    def cst(v, *axes):
        if axes and axes[0] == "batch" and cst.batch is not None \
                and v.shape[0] != cst.batch:
            raise ValueError(
                f"constrain: a 'batch' dim of {v.shape[0]} rows, but this "
                f"rank holds {cst.batch} rows of the batch on "
                f"{dict(mesh.shape)}")
        return v

    def seq_block(length: int):
        if not seq_parallel:
            return None
        return rules.seq_block(mesh, rules.resid_seq_axes(mesh, length),
                               length)

    def lay_out_cache(batch: int, max_len: int):
        cst.cache = None if not seq_parallel else rules.seq_block(
            mesh, rules.cache_seq_axes(mesh, batch, max_len), max_len)
        cst.state = cst.tp
        return cst.cache

    cst.axis_sizes = dict(mesh.shape)
    cst.seq_axes = (rules.spec_axes(act_spec(mesh, "resid_seq")[0])
                    if seq_parallel else ())
    cst.seq_block = seq_block
    cst.lay_out_cache = lay_out_cache
    cst.cache = None
    cst.batch = None
    tp = tp_lib.TensorParallel(mesh)
    cst.tp = tp if tensor_parallel and tp.axes else None
    cst.state = None
    return cst


def make_param_constrain(mesh, cfg, *, fsdp: bool = False,
                         reduce_axes=None, expert_parallel=None):
    """The per-layer weight constraint (None without a mesh), applied to
    each layer's weights inside the layer's checkpointed function.

    With every leaf whole on every rank it is the identity.  Under the
    FSDP ∘ TP layout (``fsdp``) it all-gathers each leaf of the layer
    from the rank's shard (``sharding.fsdp.GatherParam``), and its
    backward reduces the layer's gradient over ``reduce_axes`` (default:
    the mesh's batch axes): per-layer gather -> use -> discard, gathered
    again by the backward's recompute under ``remat="full"``.

    ``expert_parallel`` (default: on wherever the mesh's ``model`` axis
    is live) is the expert layout of the activation constraint it runs
    beside (``make_constrain``'s ``cst.tp``; ``make_train_step`` passes
    it from there): under FSDP the expert leaves then gather over
    ``data`` only and keep their ``model`` block
    (``sharding.fsdp.keep_blocks``), else they gather whole.  In the
    replicated layout the leaves are whole and ``models/moe.py`` slices
    the rank's block (``sharding.ep.local_experts``, whose backward
    gathers the block's gradient).  The result carries it as
    ``.expert_parallel``; ``lm`` raises where it differs from the
    constraint's layout."""
    if mesh is None:
        return None
    ep_on = (bool(tp_lib.TensorParallel(mesh).axes)
             if expert_parallel is None else bool(expert_parallel))
    if not fsdp:
        def fn(layer_tree):
            return layer_tree
    else:
        specs = lm.lm_param_specs(cfg)
        placements = param_shardings(specs, mesh)
        if ep_on:
            placements = fsdp_lib.keep_blocks(placements, specs)
        placements = fsdp_lib.layer_placements(placements)
        axes = (batch_axes(mesh) if reduce_axes is None
                else tuple(reduce_axes))

        def fn(layer_tree):
            return fsdp_lib.gather_tree(layer_tree, placements, axes)
    fn.expert_parallel = ep_on
    return fn


def train_state_init(key, cfg, tcfg: TrainConfig, *, device=None,
                     mesh=None):
    """The train state ``{"params", "opt"}`` on ``device`` (the card
    unless the caller asks for the CPU).  ``key`` is an int seed or a
    ``torch.Generator``; weights are drawn on the generator's device, so
    one seed gives the same weights on every target.  With
    ``tcfg.fsdp`` and a ``mesh`` each leaf of ``params``, ``m`` and
    ``v`` is the rank's shard of the whole leaf the same seed gives (the
    whole leaves are drawn on the generator's device, cut there, and
    only the shards moved to ``device``).  With ``cross_pod_compress``
    the state also has ``"ef": None``, for the caller to fill with
    ``init_error_feedback(params, n_pods)``."""
    device = resolve_device(device)
    gen = key
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(key))
    specs = lm.lm_param_specs(cfg)
    if tcfg.fsdp and mesh is not None:
        whole = params_lib.init_params(specs, gen, gen.device,
                                       cfg.param_dtype)
        params = tree_map(lambda p, pl: pl.shard(p).to(device), whole,
                          param_shardings(specs, mesh))
        del whole
    else:
        params = params_lib.init_params(specs, gen, device, cfg.param_dtype)
    state = {"params": params, "opt": adamw_init(params, tcfg.optimizer)}
    if tcfg.cross_pod_compress:
        state["ef"] = None
    return state


def _value_and_grad(loss_fn, params, *args):
    """(loss, grads) of ``loss_fn(params, *args)`` w.r.t. every leaf."""
    tracked = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = loss_fn(tracked, *args)
    loss.backward()
    grads = tree_map(
        lambda t: torch.zeros_like(t) if t.grad is None else t.grad, tracked
    )
    return loss.detach(), grads


def _to_device(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _span(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def shard_batch(batch, mesh, microbatches: int = 1, *,
                pods_first: bool = False):
    """This rank's rows of the global ``batch``, microbatch-major: row
    block ``(pod, data)`` of each of the ``microbatches`` splits, or,
    with ``pods_first``, the pod's contiguous block split into
    microbatches and each of those split over ``data``."""
    axes = batch_axes(mesh)
    dp, n = _span(mesh, axes), microbatches
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        b = v.shape[0]
        if b % (n * dp):
            raise ValueError(
                f"a batch of {b} rows does not split into {n} microbatches "
                f"over the {dp} data-parallel ranks of {dict(mesh.shape)}")
        r = b // (n * dp)
        if pods_first and "pod" in axes:
            pods = mesh.shape["pod"]
            rows = v.reshape(pods, n, dp // pods, r, *v.shape[1:])
            rows = rows[mesh.coords["pod"], :, mesh.coords.get("data", 0)]
        else:
            rows = v.reshape(n, dp, r, *v.shape[1:])
            d = 0
            for ax in axes:
                d = d * mesh.shape[ax] + mesh.coords[ax]
            rows = rows[:, d]
        out[k] = rows.reshape(n * r, *v.shape[1:])
    return out


def _mean_over(loss, grads, mesh, axes):
    """``loss`` and every leaf of ``grads`` summed over the ranks of
    ``axes`` and divided by their span: one float32 all-reduce an axis
    over all of them together."""
    if not axes:
        return loss, grads
    leaves = list(_leaves(grads))
    flat = torch.cat([g.to(torch.float32).reshape(-1) for _, g in leaves]
                     + [loss.to(torch.float32).reshape(1)])
    with collective_span("train.grad_allreduce", flat,
                                     bytes=4 * flat.numel(), axes=axes):
        for ax in axes:
            all_reduce(flat, mesh, ax)
    flat = flat / _span(mesh, axes)
    out: dict = {}
    off = 0
    for path, g in leaves:
        _set(out, path, flat[off:off + g.numel()].view(g.shape))
        off += g.numel()
    return flat[-1], out


def make_train_step(cfg, tcfg: TrainConfig, mesh=None):
    """Returns ``step(state, batch) -> (state, metrics)``; on ``mesh``
    every rank is handed the global batch (see the module doc)."""
    cst = make_constrain(mesh)
    compress = (tcfg.cross_pod_compress and mesh is not None
                and "pod" in mesh.axis_names)
    axes = () if mesh is None else batch_axes(mesh)
    reduce_axes = tuple(a for a in axes if a != "pod") if compress else axes
    sharded = tcfg.fsdp and mesh is not None
    placements = (param_shardings(lm.lm_param_specs(cfg), mesh)
                  if sharded else None)
    cstp = make_param_constrain(mesh, cfg, fsdp=sharded,
                                reduce_axes=reduce_axes,
                                expert_parallel=tp_lib.of(cst) is not None)
    n = max(tcfg.microbatches, 1)

    def loss_fn(params, batch, rng):
        if sharded:
            params = fsdp_lib.gather_params(params, placements, reduce_axes)
        return lm.lm_loss(params, batch, cfg, rng=rng, constrain=cst,
                          constrain_params=cstp)

    def grads_of(params, batch, rng):
        if n <= 1:
            return _value_and_grad(loss_fn, params, batch, rng)
        micro = {
            k: v.reshape((n, v.shape[0] // n) + v.shape[1:])
            for k, v in batch.items()
        }
        loss = 0.0
        g_acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                          params)
        for i in range(n):
            mb = {k: v[i] for k, v in micro.items()}
            key = None if rng is None else ctr_rng.fold_in(rng, i)
            li, gi = _value_and_grad(loss_fn, params, mb, key)
            g_acc = tree_map(lambda a, b: a + b.to(torch.float32), g_acc, gi)
            loss = loss + li
        return loss / n, tree_map(lambda g: g / n, g_acc)

    def substrate():
        # each one-key SC matmul of a rank's rows: its K block, no gather
        if mesh is None or cfg.sc_backend == "exact":
            return contextlib.nullcontext()
        rules = dataclasses.replace(sc_shard_rules(mesh), local_rows=True)
        return sc.use_mesh(mesh, rules)

    def loss_and_grads(state, batch):
        """The step's loss, gradient (reduced over the batch group; the
        shards' gradients under the FSDP layout) and new error-feedback
        residual, before the update."""
        params = state["params"]
        device = tree_leaves(params)[0].device
        if mesh is not None:
            batch = shard_batch(batch, mesh, n, pods_first=compress)
            cst.batch = next(iter(batch.values())).shape[0] // n
        batch = _to_device(batch, device)
        # the SC substrate is the only rng consumer in the loss
        rng = None
        if cfg.sc_backend != "exact":
            root = ctr_rng.prng_key(tcfg.seed)
            rng = ctr_rng.fold_in(root, int(state["opt"]["step"]))

        def pod_grads(p, b):
            loss, grads = grads_of(p, b, rng)
            if sharded:  # the gathers' backward has reduced the gradients
                return _mean_over(loss, {}, mesh, reduce_axes)[0], grads
            return _mean_over(loss, grads, mesh, reduce_axes)

        with substrate():
            if compress:
                fn = compression.compressed_grads(pod_grads, mesh)
                loss, grads, new_ef = fn(params, batch, state.get("ef"))
            else:
                loss, grads = pod_grads(params, batch)
                new_ef = state.get("ef")
        return loss, grads, new_ef

    def apply(state, grads, new_ef=None):
        """The AdamW update of ``state`` by ``grads`` (``loss_and_grads``'
        gradient): ``(new_state, metrics)``."""
        params = state["params"]
        grads = tree_map(lambda g, p: g.to(p.dtype), grads, params)
        new_params, new_opt, metrics = adamw_update(
            grads, state["opt"], params, tcfg.optimizer,
            placements=placements)
        new_state = {"params": new_params, "opt": new_opt}
        if "ef" in state:
            new_state["ef"] = new_ef
        return new_state, metrics

    def step(state, batch):
        loss, grads, new_ef = loss_and_grads(state, batch)
        new_state, metrics = apply(state, grads, new_ef)
        metrics["loss"] = loss
        return new_state, metrics

    # a step in two parts, for callers that keep the gradient
    step.loss_and_grads, step.apply = loss_and_grads, apply
    return step


def make_eval_step(cfg, mesh=None, *, fsdp: bool = False):
    """``eval_step(params, batch) -> loss`` without a graph; on ``mesh``
    each rank takes its rows of the global batch and the loss is the
    mean over the batch group.  With ``fsdp`` ``params`` are the rank's
    shards (``train_state_init(..., mesh=)`` under ``TrainConfig(fsdp=
    True)``), gathered as the train step gathers them."""
    cst = make_constrain(mesh)
    axes = () if mesh is None else batch_axes(mesh)
    sharded = fsdp and mesh is not None
    placements = (param_shardings(lm.lm_param_specs(cfg), mesh)
                  if sharded else None)
    cstp = make_param_constrain(mesh, cfg, fsdp=sharded,
                                expert_parallel=tp_lib.of(cst) is not None)

    def eval_step(params, batch):
        device = tree_leaves(params)[0].device
        if mesh is not None:
            batch = shard_batch(batch, mesh)
            cst.batch = next(iter(batch.values())).shape[0]
        with torch.no_grad():
            if sharded:
                params = fsdp_lib.gather_params(params, placements)
            loss = lm.lm_loss(params, _to_device(batch, device), cfg,
                              constrain=cst, constrain_params=cstp)
            return _mean_over(loss, {}, mesh, axes)[0]

    return eval_step
