"""LM assembly: parameter specs, the full-sequence forward and loss for
training, the fixed-slot cache with ``prefill`` / ``decode_step``, the
paged cache, and one chunked decode/prefill step.

Port of ``repro.models.lm``:

  dense / audio / vlm : N × (RMSNorm → GQA attn → RMSNorm → MLP)
  moe                 : N × (RMSNorm → GQA attn → RMSNorm → MoE FFN)
  ssm                 : N × (RMSNorm → Mamba2/SSD block, ``models/ssm.py``)
  hybrid              : groups of ``attn_every`` Mamba2 layers, each group
                        followed by ONE weight-shared (attn + MLP) block
                        with a K/V cache of its own per invocation
                        (zamba2: 81 "layers" = 54 ssm + 27 shared
                        invocations).

Layers are stacked on a leading axis and run by a Python loop (the
reference's ``lax.scan``), each layer under activation checkpointing when
``cfg.remat == "full"`` (the reference's ``jax.checkpoint``).  Backbone
layer ``i`` draws from ``fold_in(rng, i)``, shared invocation ``j`` from
``fold_in(rng, 10_000 + j)``.  Every family serves and trains.  Under
``frontend="embeddings"`` (musicgen-large) ``encode``, ``forward`` and
``prefill`` also take (b, s, d) frame embeddings, projected into the
residual stream through ``models/frontend.py`` under the root ``rng``;
serving feeds tokens through the embedding table.

Recomputation is safe for the stochastic backends because their noise
is a pure function of the per-layer, per-site key (``sc/ctr_rng.py``):
the recomputed forward draws exactly the bits the first one drew.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device, sc
from repro_torch.models import attention, frontend, layers, moe, ssm
from repro_torch.models.params import ParamSpec, tree_map_specs
from repro_torch.sharding import tp as tp_lib

# The families that carry recurrent state (the reference's
# ``serve/kv_cache.py:CachePlan``); every other one is an attention stack.
STATE_FAMILIES = ("ssm", "hybrid")
SHARED_KEY_BASE = 10_000  # key fold of shared invocation j: base + j


def _norm_spec(cfg):
    return ParamSpec((cfg.d_model,), ("embed",), "ones")


def block_specs(cfg):
    if cfg.family in STATE_FAMILIES:
        return {"ln1": _norm_spec(cfg), "ssm": ssm.ssm_specs(cfg)}
    return {
        "ln1": _norm_spec(cfg),
        "attn": attention.attn_specs(cfg),
        "ln2": _norm_spec(cfg),
        "ffn": moe.moe_specs(cfg) if cfg.family == "moe"
        else layers.mlp_specs(cfg),
    }


def shared_block_specs(cfg):
    """zamba2's weight-shared transformer block (MHA + MLP)."""
    return {
        "ln1": _norm_spec(cfg),
        "attn": attention.attn_specs(cfg),
        "ln2": _norm_spec(cfg),
        "mlp": layers.mlp_specs(cfg),
    }


def stack_specs(specs, n: int):
    def stack(s):
        axes = ("layers",) + s.axes
        return ParamSpec((n,) + s.shape, axes, s.init, s.dtype)

    return tree_map_specs(stack, specs)


def n_backbone_layers(cfg) -> int:
    """Stacked backbone depth (hybrid: ssm layers only; ``n_layers``
    counts ssm layers + shared invocations)."""
    if cfg.family == "hybrid":
        return cfg.n_layers * cfg.attn_every // (cfg.attn_every + 1)
    return cfg.n_layers


def n_shared_invocations(cfg) -> int:
    if cfg.family != "hybrid":
        return 0
    return n_backbone_layers(cfg) // cfg.attn_every


def _shared_after(cfg, idx: int):
    """The shared invocation that runs after backbone layer ``idx``
    (hybrid: after every ``attn_every``-th layer), else None."""
    if cfg.family != "hybrid" or (idx + 1) % cfg.attn_every:
        return None
    return idx // cfg.attn_every


def lm_param_specs(cfg):
    sp = {
        "embed": layers.embed_specs(cfg),
        "blocks": stack_specs(block_specs(cfg), n_backbone_layers(cfg)),
        "final_norm": _norm_spec(cfg),
    }
    if not cfg.tie_embeddings:
        shape = (cfg.d_model, cfg.vocab)
        sp["unembed"] = ParamSpec(shape, ("embed", "vocab"), "scaled")
    if cfg.family == "hybrid":
        sp["shared"] = shared_block_specs(cfg)
    if cfg.frontend == "embeddings":
        sp["frontend"] = frontend.frontend_specs(cfg)
    return sp


def _logits(x, params, cfg, key=None, cols=None, w_rows=None):
    """Output projection (site ``unembed``): ``key`` is the caller's rng
    root — raw (2,) or per-row (..., 2) — folded here with the site's
    salt.  With ``cols`` (a block of the vocabulary) this rank's block
    of the logits (``layers.dense``'s column-parallel call; ``w_rows``
    its block weight's K block, :func:`_unembed_rows`)."""
    key = layers.site_key(key, "unembed")
    if cfg.tie_embeddings:
        y = layers.unembed(x, params["embed"], cfg, key, cols=cols,
                           w_rows=w_rows)
    else:
        w = params["unembed"]
        if cols is None and w.shape[-1] != cfg.vocab:
            raise ValueError(f"an unembed of {w.shape[-1]} columns: the "
                             f"whole vocabulary is {cfg.vocab}")
        y = layers.dense(x, w, cfg, key, site="unembed", cols=cols,
                         w_rows=w_rows)
    return y.to(torch.float32)


def _unembed_rows(params, cfg, vb):
    """Where the unembed's weight arrives as this rank's vocabulary block
    ``vb`` and runs on the SC substrate inside ``sc.use_mesh``: its K
    block (``sharding.tp.cols_to_rows``), relaid once for every loss
    chunk and the chunks' recompute; else None."""
    if vb is None or cfg.sc_backend == "exact" or sc.active_mesh() is None:
        return None
    w = (params["embed"]["table"].T if cfg.tie_embeddings
         else params["unembed"])
    if not tp_lib.is_block(w, vb, 1):
        return None
    with torch.no_grad():
        return tp_lib.cols_to_rows(w, vb).to(torch.float32)


def _layer(tree, idx: int):
    """Layer ``idx`` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, idx) for k, v in tree.items()}
    return tree[idx]


# ---------------------------------------------------------------------------
# Forward and loss over a full sequence (train / eval)
# ---------------------------------------------------------------------------


def _ffn(x, p, cfg, key, cst=None):
    """The block's FFN: the MoE layer for family moe (under ``cst``'s
    in-layer layout a rank's block of the experts over ``model``,
    ``sharding/ep.py``), else the MLP."""
    if cfg.family == "moe":
        return moe.moe_ffn(x, p, cfg, key, constrain=cst)
    return layers.mlp(x, p, cfg, key, constrain=cst)


def _apply_block(x, p, cfg, positions, key, cache=None, cache_length=None,
                 seq=None, cst=None, need_kv=False):
    """One backbone block (pre-norm residual).  Returns ``(x, cache)``.

    Attention families: the sequence's K/V, or the ring-buffer ``cache``
    it wrote into (``seq``: the block of its sequence the cache holds).
    SSM / hybrid: the Mamba2 block under the layer's key unfolded, with
    ``cache`` None, ``"prefill"`` or a state dict
    (:func:`ssm.ssm_block`).  ``cst`` (a mesh step's constraint) goes
    to every sub-block, as the reference's ``_apply_block`` passes it:
    its in-layer layout (``sharding/tp.py``); ``need_kv``: return K/V
    whole (prefill's cache)."""
    if cfg.family in STATE_FAMILIES:
        h, new_cache = ssm.ssm_block(
            layers.rms_norm(x, p["ln1"]), p["ssm"], cfg, key, cache=cache,
            constrain=cst)
        return x + h, new_cache
    akey = layers.fold_keys(key, 11)
    h, kv = attention.attention_block(
        layers.rms_norm(x, p["ln1"]),
        p["attn"],
        cfg,
        positions,
        akey,
        cache=cache,
        cache_length=cache_length,
        seq=seq,
        constrain=cst,
        need_kv=need_kv,
    )
    x = x + h
    fkey = layers.fold_keys(key, 13)
    h = _ffn(layers.rms_norm(x, p["ln2"]), p["ffn"], cfg, fkey, cst)
    return x + h, kv


def _apply_shared(x, p, cfg, positions, key, cache=None, cache_length=None,
                  seq=None, cst=None, need_kv=False):
    """zamba2's weight-shared block: attention under ``fold_in(key, 17)``,
    the MLP under ``fold_in(key, 19)``.  Returns ``(x, (k, v))`` as
    :func:`_apply_block` does for an attention layer."""
    h, kv = attention.attention_block(
        layers.rms_norm(x, p["ln1"]),
        p["attn"],
        cfg,
        positions,
        layers.fold_keys(key, 17),
        cache=cache,
        cache_length=cache_length,
        seq=seq,
        constrain=cst,
        need_kv=need_kv,
    )
    x = x + h
    mkey = layers.fold_keys(key, 19)
    h = layers.mlp(layers.rms_norm(x, p["ln2"]), p["mlp"], cfg, mkey,
                   constrain=cst)
    return x + h, kv


def _maybe_remat(fn, cfg):
    """``fn`` under activation checkpointing when ``cfg.remat == "full"``:
    the backward recomputes its forward instead of keeping its
    activations."""
    if cfg.remat == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if cfg.remat != "none":
        raise ValueError(f"unknown cfg.remat={cfg.remat!r} (none | full)")
    return fn


def _seq_block(constrain, length: int):
    """The rank's block of a residual stream of ``length`` positions
    between layers (``train.step.make_constrain``), or None: whole."""
    fn = getattr(constrain, "seq_block", None)
    return None if fn is None else fn(length)


def _cache_block(constrain, length: int | None = None):
    """The block of the decode cache's sequence ``constrain`` lays the
    caller's cache out by (``cst.lay_out_cache``), or None: whole."""
    blk = getattr(constrain, "cache", None)
    if blk is not None and length is not None and blk.length != length:
        raise ValueError(f"the cache is laid out for {blk.length} "
                         f"positions, not {length}")
    return blk


def _state_block(constrain, cfg):
    """The block of the SSM heads the decode state holds under
    ``constrain`` (``cst.lay_out_cache`` under the in-layer layout), or
    None: whole."""
    tp = getattr(constrain, "state", None)
    return None if tp is None else tp.block(cfg.ssm_heads)


def _check_layouts(constrain, constrain_params):
    """The weights' in-layer layout (``make_param_constrain``'s
    ``tensor_parallel``) must be the activations' (``constrain.tp``):
    the two cannot silently disagree."""
    want = getattr(constrain_params, "tensor_parallel", None)
    if want is not None and want != (tp_lib.of(constrain) is not None):
        raise ValueError(
            f"the parameter constraint lays the in-layer weights out "
            f"{'over model' if want else 'whole'}, the activation "
            f"constraint {'whole' if want else 'over model'}")


def _whole(x, blk):
    return x if blk is None else blk.gather(x)


def _part(x, blk):
    return x if blk is None else blk.slice(x)


def _embed_inputs(params, inputs, cfg, rng=None, vocab=None):
    """Tokens (b, s) through the embedding table (with ``vocab``, a
    rank's block of the vocabulary, the table may be that block:
    ``layers.embed``), or, under ``frontend="embeddings"``, (b, s, d)
    embeddings through the frontend's projection (site
    ``frontend_proj`` of the root ``rng``)."""
    if cfg.frontend == "embeddings" and inputs.dim() == 3:
        x = inputs.to(cfg.act_dtype)
        if "frontend" in params:
            x = frontend.project_embeddings(x, params["frontend"], cfg, rng)
        return x
    return layers.embed(inputs, params["embed"], vocab).to(cfg.act_dtype)


def encode(params, inputs, cfg, *, rng=None, constrain=None,
           constrain_params=None):
    """Backbone pass: tokens (b, s) or frontend embeddings (b, s, d) ->
    final hidden states (b, s, d) after the last norm.  Backbone layer
    ``idx`` draws from ``fold_in(rng, idx)``, shared invocation ``j``
    from ``fold_in(rng, 10_000 + j)``.  Under ``remat="full"`` each
    backbone layer and each shared invocation is its own (non-reentrant)
    checkpoint; the shared block's parameters, a closure of each
    invocation, get every invocation's gradient.

    ``constrain(v, *logical_axes)`` sees the residual stream after the
    embedding and after every layer, ``constrain_params`` each layer's
    weights (``train.step.make_constrain`` / ``make_param_constrain``);
    neither changes a value.  ``constrain_params`` runs inside the
    layer's checkpointed function: under the FSDP layout it gathers the
    layer's weights from the rank's shards, and the backward's
    recompute gathers them again instead of keeping them.

    Where ``constrain.seq_block(s)`` gives a block (a mesh step's
    sequence parallelism, ``sharding/seq.py``) the residual stream
    between layers is this rank's block of the sequence: each
    checkpointed layer body and shared invocation gathers the whole
    sequence first and keeps its block of the output last, so a
    checkpoint saves only the block and the recompute gathers again;
    the last layer's output is gathered before the final norm.

    Inside each layer ``constrain.tp`` lays the heads, the MLP hidden,
    the SSM's ``d_inner`` / heads and the MoE FFN's experts out over
    ``model`` (``sharding/tp.py``, ``sharding/ep.py``;
    ``make_constrain(..., tensor_parallel=False)`` keeps them whole).
    ``constrain_params``' in-layer layout must be ``constrain``'s: a
    mismatch raises.  Under it a weight may arrive as the rank's block
    (the FSDP step keeps it, ``sharding/fsdp.py:keep_blocks``), the
    embedding table as its vocabulary block (a vocabulary-parallel
    lookup, ``sharding.tp.lookup``)."""
    _check_layouts(constrain, constrain_params)
    cst = constrain or (lambda v, *a: v)
    cstp = constrain_params or (lambda t: t)
    tp = tp_lib.of(constrain)
    x = _embed_inputs(params, inputs, cfg, rng,
                      None if tp is None else tp.block(cfg.vocab))
    b, s = x.shape[:2]
    x = cst(x, "batch", "resid_seq", None)
    blk = _seq_block(constrain, s)
    x = _part(x, blk)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)

    def body(xc, lp, key):
        xc = _whole(xc, blk)
        return _part(_apply_block(xc, cstp(lp), cfg, positions, key,
                                  cst=constrain)[0], blk)

    def shared(xc, key):
        xc = _whole(xc, blk)
        return _part(_apply_shared(xc, params["shared"], cfg, positions,
                                   key, cst=constrain)[0], blk)

    body, shared = _maybe_remat(body, cfg), _maybe_remat(shared, cfg)
    for idx in range(n_backbone_layers(cfg)):
        key = layers.fold_keys(rng, idx)
        x = body(x, _layer(params["blocks"], idx), key)
        inv = _shared_after(cfg, idx)
        if inv is not None:
            x = shared(x, layers.fold_keys(rng, SHARED_KEY_BASE + inv))
        x = cst(x, "batch", "resid_seq", None)
    return layers.rms_norm(_whole(x, blk), params["final_norm"])


def forward(params, inputs, cfg, *, rng=None, constrain=None,
            constrain_params=None):
    """Full logits (b, s, vocab).  Prefer :func:`lm_loss` for training:
    it never holds the whole logits tensor.  The logits are the whole
    vocabulary on every rank (as :func:`prefill`'s and
    :func:`decode_step`'s): their callers, samplers and evaluators, read
    every entry; only the loss works on a rank's vocabulary block."""
    cst = constrain or (lambda v, *a: v)
    x = encode(params, inputs, cfg, rng=rng, constrain=constrain,
               constrain_params=constrain_params)
    return cst(_logits(x, params, cfg, rng), "batch", "seq", "vocab")


LOSS_SEQ_CHUNK = 1024


def _chunk_nll(xi, li, params, cfg, key, vb=None, w_rows=None):
    """One chunk's summed NLL; with ``vb`` (a vocabulary block) from this
    rank's block of the logits, the log-softmax reduced over ``model``
    (``sharding.tp.vocab_nll``)."""
    if vb is not None:
        logits = _logits(xi, params, cfg, key, cols=vb,
                         w_rows=w_rows)  # (b, c, V/m) f32
        return tp_lib.vocab_nll(logits, li, vb).sum()
    logits = _logits(xi, params, cfg, key)  # (b, c, vocab) f32
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, li[..., None].long())[..., 0].sum()


def lm_loss(params, batch, cfg, *, rng=None, constrain=None,
            constrain_params=None):
    """Causal next-token cross-entropy, sequence-chunked.

    The unembed, log-softmax and gather run per sequence chunk of
    ``LOSS_SEQ_CHUNK`` under activation checkpointing, so the backward
    recomputes each chunk's logits instead of keeping them: peak memory
    is O(chunk·vocab), not O(s·vocab).  Chunk ``i`` draws from
    ``fold_in(rng, i)``.  ``batch["inputs"]`` is tokens, or frame
    embeddings under ``frontend="embeddings"``.  ``constrain`` /
    ``constrain_params`` go to :func:`encode`.  Under ``constrain.tp``
    each chunk's logits are this rank's vocabulary block (the reference's
    ``"vocab"`` over ``model``; a vocabulary that does not divide stays
    whole): ``_chunk_nll``'s log-softmax reduces over ``model``, and the
    unembed's backward gathers its gradient's blocks, or, where the
    weight arrives as its block (the FSDP step), keeps the block's.
    """
    x = encode(params, batch["inputs"], cfg, rng=rng, constrain=constrain,
               constrain_params=constrain_params)
    tp = tp_lib.of(constrain)
    vb = None if tp is None else tp.block(cfg.vocab)
    w_rows = _unembed_rows(params, cfg, vb)
    labels = batch["labels"]
    b, s, _ = x.shape
    c = min(LOSS_SEQ_CHUNK, s)
    if s % c:
        c = s  # irregular lengths: single chunk
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(s // c):
        key = layers.fold_keys(rng, i)
        sl = slice(i * c, (i + 1) * c)
        nll = checkpoint(
            _chunk_nll,
            x[:, sl],
            labels[:, sl],
            params,
            cfg,
            key,
            vb,
            w_rows,
            use_reentrant=False,
        )
        total = total + nll
    return total / (b * s)


# ---------------------------------------------------------------------------
# Fixed-slot serving: a full-length K/V row (or a state row) per batch slot
# ---------------------------------------------------------------------------


def _stacked_state(cfg, n: int, batch: int, dtype, device, heads=None):
    """:func:`ssm.init_ssm_cache` stacked over ``n`` backbone layers
    (``heads``: the block of the SSM heads each layer's state holds)."""
    one = ssm.init_ssm_cache(cfg, batch, dtype, device=device, heads=heads)
    return {k: v[None].repeat((n,) + (1,) * v.dim()) for k, v in one.items()}


def init_cache(cfg, batch: int, max_len: int, dtype=None, *, device=None,
               constrain=None):
    """Stacked per-layer decode cache in ``cfg.act_dtype``.

    Attention families: ``{"k", "v"}`` of (layers, batch, max_len,
    kv_heads, head_dim) zeros.  SSM: ``{"ssm"}``, the conv tails and the
    float32 state of every backbone layer (leading axis = layer).  Hybrid
    adds ``shared_k`` / ``shared_v`` of (invocations, batch, max_len,
    kv_heads, head_dim).  With ``constrain.cache`` (a mesh's cache
    layout, ``train.step.make_constrain``) the K/V sequence is this
    rank's block of the ``max_len`` positions; with ``constrain.state``
    (the in-layer layout's) each state holds this rank's block of the
    SSM heads ``(batch, heads/m, n, p)`` and ``conv_x`` its block of
    ``d_inner``, as ``launch/specs.py:cache_shardings`` declares."""
    device = resolve_device(device)
    kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    dtype = dtype or cfg.act_dtype
    blk = _cache_block(constrain, max_len)
    max_len = max_len if blk is None else blk.size
    if cfg.family in STATE_FAMILIES:
        n = n_backbone_layers(cfg)
        cache = {"ssm": _stacked_state(cfg, n, batch, dtype, device,
                                       _state_block(constrain, cfg))}
        if cfg.family == "hybrid":
            shape = (n_shared_invocations(cfg), batch, max_len, kvh, hd)
            for name in ("shared_k", "shared_v"):
                cache[name] = torch.zeros(shape, dtype=dtype, device=device)
        return cache
    shape = (cfg.n_layers, batch, max_len, kvh, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def prefill(params, inputs, cfg, max_len: int, *, rng=None, constrain=None,
            constrain_params=None):
    """Run the prompt through the model.  inputs: (b, s) tokens, or (b, s,
    d) embeddings under ``frontend="embeddings"``, with ``s <= max_len``.
    Returns ``(logits, cache, lengths)``: the last token's logits (b,
    vocab) — the unembed runs on that one row — the cache, and
    ``lengths`` (b,) = s.

    Attention families: every layer's K/V zero-padded to ``max_len``
    (:func:`init_cache`'s layout).  SSM / hybrid: each backbone layer's
    chunked pass also returns its state (``ssm_block(cache="prefill")``):
    ``cache["ssm"]`` stacks the raw conv tails — the last
    ``min(s, ssm_conv - 1)`` positions, as the reference slices them —
    and the final SSD states; hybrid adds the shared invocations' K/V
    zero-padded to ``max_len``.

    ``rng`` is one raw (2,) key for the whole call, folded per layer (and
    per SSD chunk inside an SSM layer); the unembed draws from ``rng``
    itself.  ``constrain`` sees the residual stream after the embedding
    and after every layer, ``constrain_params`` each backbone layer's
    weights, as in :func:`encode`.  Where ``constrain.cache`` lays the
    cache out by a block of its sequence, the cache holds that block
    and each layer's K/V writes only the positions inside it; where
    ``constrain.state`` lays the SSM state out by its heads, each layer
    runs on its block and the cache holds it.  Inside each layer
    ``constrain.tp`` lays the heads, the MLP hidden and the MoE FFN's
    experts out over ``model``; the K/V are gathered whole for the
    cache.  The logits are
    the whole vocabulary (see :func:`forward`).
    """
    _check_layouts(constrain, constrain_params)
    cst = constrain or (lambda v, *a: v)
    cstp = constrain_params or (lambda t: t)
    x = _embed_inputs(params, inputs, cfg, rng)
    b, s = x.shape[:2]
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len={max_len}")
    x = cst(x, "batch", "resid_seq", None)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    cache = init_cache(cfg, b, max_len, x.dtype, device=x.device,
                       constrain=constrain)
    blk = _cache_block(constrain, max_len)
    lo, hi = (0, s) if blk is None else (blk.start, min(blk.stop, s))

    def write(buf, idx, t):  # positions [lo, hi) of the block
        if hi > lo:
            buf[idx, :, :hi - lo] = t[:, lo:hi]

    if cfg.family in STATE_FAMILIES:
        states = []
        for idx in range(n_backbone_layers(cfg)):
            key = layers.fold_keys(rng, idx)
            x, nc = _apply_block(x, cstp(_layer(params["blocks"], idx)),
                                 cfg, positions, key, cache="prefill",
                                 cst=constrain)
            states.append(nc)
            inv = _shared_after(cfg, idx)
            if inv is not None:
                key = layers.fold_keys(rng, SHARED_KEY_BASE + inv)
                x, (k, v) = _apply_shared(x, params["shared"], cfg,
                                          positions, key, cst=constrain,
                                          need_kv=True)
                write(cache["shared_k"], inv, k)
                write(cache["shared_v"], inv, v)
            x = cst(x, "batch", "resid_seq", None)
        cache["ssm"] = {name: torch.stack([st[name] for st in states])
                        for name in states[0]}
    else:
        for idx in range(cfg.n_layers):
            key = layers.fold_keys(rng, idx)
            x, (k, v) = _apply_block(
                x, cstp(_layer(params["blocks"], idx)), cfg, positions, key,
                cst=constrain, need_kv=True)
            write(cache["k"], idx, k)
            write(cache["v"], idx, v)
            x = cst(x, "batch", "resid_seq", None)
    x = layers.rms_norm(x, params["final_norm"])
    logits = _logits(x[:, -1], params, cfg, rng)
    lengths = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return logits, cache, lengths


def _write_state(stacked: dict, idx: int, new: dict) -> None:
    """Layer ``idx``'s rows of a stacked state, overwritten IN PLACE."""
    for name, v in new.items():
        stacked[name][idx].copy_(v)


def decode_step(params, cache, tokens, lengths, cfg, *, rng=None,
                constrain=None, constrain_params=None):
    """One token per row.  tokens: (b,) next input ids; lengths: (b,)
    current fill (the new token writes at that index, clamped to the
    last one).  Returns ``(logits (b, vocab), cache)``: ``cache`` is the
    dict given, whose buffers this call updated IN PLACE (SSM layers:
    their conv tails and states; attention: the K/V rows).

    ``rng`` is one raw (2,) key for the whole batch, folded per layer as
    in :func:`prefill`; every row is one row of each SC matmul, so a
    row's bits depend on its neighbours (the fixed-slot engine's
    contract, unlike :func:`decode_paged`'s per-request keys).
    ``constrain`` / ``constrain_params`` as in :func:`prefill`: where
    ``constrain.cache`` lays the cache out by a block of its sequence,
    ``cache`` holds that block, each attention layer writes the new K/V
    only inside it and combines the ranks' partials
    (``attention.chunk_decode_attention``).  Where ``constrain.state``
    lays the SSM state out by its heads, ``cache["ssm"]`` holds that
    block and each SSM layer decodes on it.  Inside each layer
    ``constrain.tp`` lays the MLP hidden, the MoE FFN's experts (and, on
    a whole K/V cache, the attention heads) out over ``model``.
    """
    _check_layouts(constrain, constrain_params)
    cst = constrain or (lambda v, *a: v)
    cstp = constrain_params or (lambda t: t)
    blk = _cache_block(constrain)
    kv_name = "shared_k" if cfg.family == "hybrid" else "k"
    if blk is not None and kv_name in cache \
            and cache[kv_name].shape[2] != blk.size:
        raise ValueError(f"decode_step: a cache of {cache[kv_name].shape[2]} "
                         f"positions, but the layout's block holds "
                         f"{blk.size}")
    hb = _state_block(constrain, cfg) if "ssm" in cache else None
    heads = cfg.ssm_heads if hb is None else hb.width
    if "ssm" in cache and cache["ssm"]["state"].shape[2] != heads:
        raise ValueError(f"decode_step: a state of "
                         f"{cache['ssm']['state'].shape[2]} SSM heads, but "
                         f"the layout's block holds {heads}")
    x = layers.embed(tokens, params["embed"]).to(cfg.act_dtype)[:, None]
    x = cst(x, "batch", None, None)
    positions = lengths.to(torch.int64)[:, None]
    new_lengths = lengths.to(torch.int64) + 1
    if cfg.family in STATE_FAMILIES:
        for idx in range(n_backbone_layers(cfg)):
            key = layers.fold_keys(rng, idx)
            lc = _layer(cache["ssm"], idx)
            x, nc = _apply_block(x, cstp(_layer(params["blocks"], idx)),
                                 cfg, positions, key, cache=lc,
                                 cst=constrain)
            _write_state(cache["ssm"], idx, nc)
            inv = _shared_after(cfg, idx)
            if inv is not None:
                key = layers.fold_keys(rng, SHARED_KEY_BASE + inv)
                x, _ = _apply_shared(
                    x, params["shared"], cfg, positions, key,
                    cache=(cache["shared_k"][inv], cache["shared_v"][inv]),
                    cache_length=new_lengths, seq=blk, cst=constrain,
                )
            x = cst(x, "batch", None, None)
    else:
        for idx in range(cfg.n_layers):
            key = layers.fold_keys(rng, idx)
            x, _ = _apply_block(
                x,
                cstp(_layer(params["blocks"], idx)),
                cfg,
                positions,
                key,
                cache=(cache["k"][idx], cache["v"][idx]),
                cache_length=new_lengths,
                seq=blk,
                cst=constrain,
            )
            x = cst(x, "batch", None, None)
    x = layers.rms_norm(x, params["final_norm"])
    return _logits(x[:, 0], params, cfg, rng), cache


# ---------------------------------------------------------------------------
# Paged serving
# ---------------------------------------------------------------------------


def init_paged_cache(cfg, num_blocks: int, block_size: int, *, slots=None,
                     device=None):
    """Per-family paged decode cache (the device half of
    ``serve/kv_cache.py:CachePlan``), in ``cfg.act_dtype``.

    Attention families: one pool of ``num_blocks`` token blocks per layer
    (block 0 is the reserved null block).  SSM: nothing to page — one
    state + conv-tail row PER BATCH ROW (``slots``) for every backbone
    layer, carried beside the block table (the allocator still meters
    the token budget; the tables go unread by the model).  Hybrid: both,
    with K/V pools only for the shared invocations.
    """
    device = resolve_device(device)
    kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    n_pools = cfg.n_layers
    pages = {}
    if cfg.family in STATE_FAMILIES:
        if slots is None:
            raise ValueError(
                f"family={cfg.family!r} carries fixed-size SSM state per "
                "batch row — pass slots= to init_paged_cache"
            )
        pages["ssm"] = _stacked_state(cfg, n_backbone_layers(cfg), slots,
                                      cfg.act_dtype, device)
        if cfg.family == "ssm":
            return pages
        n_pools = n_shared_invocations(cfg)
    shape = (n_pools, num_blocks, block_size, kvh, hd)
    for name in ("k", "v"):
        pages[name] = torch.zeros(shape, dtype=cfg.act_dtype, device=device)
    return pages


def _reset_fresh_state(state: dict, lengths) -> None:
    """Zero, IN PLACE, the state and conv rows of sequences starting from
    position 0 this step (a fresh admission or an eviction resume) — the
    recurrent analogue of a fresh block table.  Leaves: (n, b, ...); idle
    rows (lengths == 0, nothing fed) zero harmlessly."""
    fresh = lengths == 0
    for v in state.values():
        v.masked_fill_(fresh.reshape((1, -1) + (1,) * (v.dim() - 2)), 0)


def decode_paged(
    params,
    pages,
    block_table,
    tokens,
    lengths,
    n_valid,
    cfg,
    *,
    rng=None,
    all_logits: bool = False,
):
    """One chunked step over the paged KV cache — decode AND prefill.

    tokens: (b, sc) — row r feeds its next ``n_valid[r]`` context tokens
    at absolute positions ``lengths[r] + i``; slots beyond a row's valid
    count write their K/V to the null block and are masked out of every
    live query.  Returns ``(logits, pages)``: logits (b, vocab) at each
    row's last valid position (or (b, sc, vocab) with ``all_logits``),
    and ``pages`` — the same dict, whose pools this call updated IN
    PLACE.

    RNG contract: ``rng`` is (b, 2) per-request raw keys; every token
    folds its row's key with its ABSOLUTE position, and all layer /
    call-site folds derive from that, so a token's stochastic bits
    depend only on (request key, position, layer, site).  ``rng`` may
    also be (b, sc, 2) per-token keys already resolved by the caller.
    ``paged_attn="fused_sc"`` requires ``rng``.

    SSM / hybrid layers feed their chunk through :func:`ssm.ssm_stream`
    (token-recurrent, so a row's state is bit-identical whatever the
    chunking or batch composition); rows at ``lengths == 0`` zero their
    state first.  Hybrid adds the shared attention block over its own
    K/V pools per invocation, under keys ``fold_in(10_000 + j)``.
    """
    if rng is None and cfg.paged_attn == "fused_sc":
        raise ValueError(
            "paged_attn='fused_sc' draws stochastic attention logits "
            "from per-request keys; pass rng=(b, 2) raw keys"
        )
    b, sc = tokens.shape
    dev = tokens.device
    x = layers.embed(tokens, params["embed"]).to(cfg.act_dtype)
    steps = torch.arange(sc, device=dev)
    positions = lengths.to(torch.int64)[:, None] + steps[None, :]
    keys = None
    if rng is not None:
        if rng.dim() == 3:
            keys = rng  # (b, sc, 2) caller-resolved keys
        else:
            per_tok = rng[:, None, :].expand(b, sc, rng.shape[-1])
            keys = layers.fold_keys(per_tok, positions)  # (b, sc, 2)

    def attend(xc, p, key, kp, vp):
        h, _, _ = attention.paged_attention_block(
            layers.rms_norm(xc, p["ln1"]), p["attn"], cfg, positions, key,
            kp, vp, block_table, lengths, n_valid,
        )
        return xc + h

    if cfg.family in STATE_FAMILIES:
        _reset_fresh_state(pages["ssm"], lengths)
        valid = steps[None, :] < n_valid.to(torch.int64)[:, None]
        for idx in range(n_backbone_layers(cfg)):
            lp = _layer(params["blocks"], idx)
            h, nc = ssm.ssm_stream(
                layers.rms_norm(x, lp["ln1"]), lp["ssm"], cfg,
                layers.fold_keys(keys, idx), _layer(pages["ssm"], idx),
                valid,
            )
            x = x + h
            _write_state(pages["ssm"], idx, nc)
            inv = _shared_after(cfg, idx)
            if inv is not None:
                sp = params["shared"]
                k2 = layers.fold_keys(keys, SHARED_KEY_BASE + inv)
                x = attend(x, sp, layers.fold_keys(k2, 17), pages["k"][inv],
                           pages["v"][inv])
                x = x + layers.mlp(layers.rms_norm(x, sp["ln2"]), sp["mlp"],
                                   cfg, layers.fold_keys(k2, 19))
    else:
        for idx in range(cfg.n_layers):
            lp = _layer(params["blocks"], idx)
            lkeys = layers.fold_keys(keys, idx)
            x = attend(x, lp, layers.fold_keys(lkeys, 11), pages["k"][idx],
                       pages["v"][idx])
            fkey = layers.fold_keys(lkeys, 13)
            x = x + _ffn(layers.rms_norm(x, lp["ln2"]), lp["ffn"], cfg, fkey)
    x = layers.rms_norm(x, params["final_norm"])
    if all_logits:
        return _logits(x, params, cfg, keys), pages
    rows = torch.arange(b, device=dev)
    last = torch.clamp(n_valid.to(torch.int64) - 1, min=0)
    lkey = None
    if keys is not None:
        # uint32 tensors take no advanced indexing on CUDA: gather in int64
        lkey = keys.to(torch.int64)[rows, last].to(torch.uint32)
    return _logits(x[rows, last], params, cfg, lkey), pages
