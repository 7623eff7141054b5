"""LM assembly: parameter specs, the full-sequence forward and loss for
training, the fixed-slot cache with ``prefill`` / ``decode_step``, the
paged cache, and one chunked decode/prefill step.

Port of the attention families of ``repro.models.lm``: dense and vlm run
N × (RMSNorm → GQA attn → RMSNorm → MLP), moe the same with the MoE FFN
(``models/moe.py``) in place of the MLP.  Layers are stacked on a
leading axis and run by a Python loop (the reference's ``lax.scan``),
each layer under activation checkpointing when ``cfg.remat == "full"``
(the reference's ``jax.checkpoint``).  The SSM, hybrid and audio
families and the embeddings frontend come with a later slice (ROADMAP
queue 1 item 7).

Recomputation is safe for the stochastic backends because their noise
is a pure function of the per-layer, per-site key (``sc/ctr_rng.py``):
the recomputed forward draws exactly the bits the first one drew.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.models import attention, layers, moe
from repro_torch.models.params import ParamSpec, tree_map_specs

# The attention families: one K/V cache per layer (the reference's
# ``serve/kv_cache.py`` plans moe and vlm like dense).
FAMILIES = ("dense", "moe", "vlm")


def require_ported(cfg) -> None:
    """Raise ``NotImplementedError`` naming ROADMAP queue 1 item 7 for a
    family or frontend the port does not run yet."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family={cfg.family!r} is not ported yet (ROADMAP queue 1 "
            f"item 7); the port runs {', '.join(FAMILIES)}"
        )
    if cfg.frontend != "tokens":
        raise NotImplementedError(
            f"frontend={cfg.frontend!r} needs the modality frontend, not "
            "ported yet (ROADMAP queue 1 item 7)"
        )


def _norm_spec(cfg):
    return ParamSpec((cfg.d_model,), ("embed",), "ones")


def block_specs(cfg):
    require_ported(cfg)
    return {
        "ln1": _norm_spec(cfg),
        "attn": attention.attn_specs(cfg),
        "ln2": _norm_spec(cfg),
        "ffn": moe.moe_specs(cfg) if cfg.family == "moe"
        else layers.mlp_specs(cfg),
    }


def stack_specs(specs, n: int):
    def stack(s):
        axes = ("layers",) + s.axes
        return ParamSpec((n,) + s.shape, axes, s.init, s.dtype)

    return tree_map_specs(stack, specs)


def lm_param_specs(cfg):
    sp = {
        "embed": layers.embed_specs(cfg),
        "blocks": stack_specs(block_specs(cfg), cfg.n_layers),
        "final_norm": _norm_spec(cfg),
    }
    if not cfg.tie_embeddings:
        shape = (cfg.d_model, cfg.vocab)
        sp["unembed"] = ParamSpec(shape, ("embed", "vocab"), "scaled")
    return sp


def _logits(x, params, cfg, key=None):
    """Output projection (site ``unembed``): ``key`` is the caller's rng
    root — raw (2,) or per-row (..., 2) — folded here with the site's
    salt."""
    key = layers.site_key(key, "unembed")
    if cfg.tie_embeddings:
        y = layers.unembed(x, params["embed"], cfg, key)
    else:
        w = params["unembed"]
        y = layers.dense(x, w, cfg, key, site="unembed")
    return y.to(torch.float32)


def _layer(tree, idx: int):
    """Layer ``idx`` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, idx) for k, v in tree.items()}
    return tree[idx]


# ---------------------------------------------------------------------------
# Forward and loss over a full sequence (train / eval)
# ---------------------------------------------------------------------------


def _ffn(x, p, cfg, key):
    """The block's FFN: the MoE layer for family moe, else the MLP."""
    if cfg.family == "moe":
        return moe.moe_ffn(x, p, cfg, key)
    return layers.mlp(x, p, cfg, key)


def _apply_block(x, p, cfg, positions, key, cache=None, cache_length=None):
    """One attention block (pre-norm residual).  Returns ``(x, (k, v))``:
    the sequence's K/V, or the ring-buffer ``cache`` it wrote into."""
    akey = layers.fold_keys(key, 11)
    h, kv = attention.attention_block(
        layers.rms_norm(x, p["ln1"]),
        p["attn"],
        cfg,
        positions,
        akey,
        cache=cache,
        cache_length=cache_length,
    )
    x = x + h
    fkey = layers.fold_keys(key, 13)
    h = _ffn(layers.rms_norm(x, p["ln2"]), p["ffn"], cfg, fkey)
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


def _embed_inputs(params, inputs, cfg, rng=None):
    if inputs.dim() == 3:
        raise NotImplementedError(
            "embedding inputs need the modality frontend, not ported yet "
            "(ROADMAP queue 1 item 7)"
        )
    return layers.embed(inputs, params["embed"]).to(cfg.act_dtype)


def encode(params, inputs, cfg, *, rng=None):
    """Backbone pass: tokens (b, s) -> final hidden states (b, s, d) after
    the last norm.  Layer ``idx`` draws from ``fold_in(rng, idx)``."""
    require_ported(cfg)
    x = _embed_inputs(params, inputs, cfg, rng)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)

    def body(xc, lp, key):
        return _apply_block(xc, lp, cfg, positions, key)[0]

    body = _maybe_remat(body, cfg)
    for idx in range(cfg.n_layers):
        key = layers.fold_keys(rng, idx)
        x = body(x, _layer(params["blocks"], idx), key)
    return layers.rms_norm(x, params["final_norm"])


def forward(params, inputs, cfg, *, rng=None):
    """Full logits (b, s, vocab).  Prefer :func:`lm_loss` for training:
    it never holds the whole logits tensor."""
    x = encode(params, inputs, cfg, rng=rng)
    return _logits(x, params, cfg, rng)


LOSS_SEQ_CHUNK = 1024


def _chunk_nll(xi, li, params, cfg, key):
    logits = _logits(xi, params, cfg, key)  # (b, c, vocab) f32
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, li[..., None].long())[..., 0].sum()


def lm_loss(params, batch, cfg, *, rng=None):
    """Causal next-token cross-entropy, sequence-chunked.

    The unembed, log-softmax and gather run per sequence chunk of
    ``LOSS_SEQ_CHUNK`` under activation checkpointing, so the backward
    recomputes each chunk's logits instead of keeping them: peak memory
    is O(chunk·vocab), not O(s·vocab).  Chunk ``i`` draws from
    ``fold_in(rng, i)``.
    """
    x = encode(params, batch["inputs"], cfg, rng=rng)
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
            use_reentrant=False,
        )
        total = total + nll
    return total / (b * s)


# ---------------------------------------------------------------------------
# Fixed-slot serving: a full-length K/V row per batch slot
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_len: int, dtype=None, *, device=None):
    """Stacked per-layer decode cache: ``{"k", "v"}`` of (layers, batch,
    max_len, kv_heads, head_dim) zeros in ``cfg.act_dtype``."""
    require_ported(cfg)
    device = resolve_device(device)
    kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (cfg.n_layers, batch, max_len, kvh, hd)
    dtype = dtype or cfg.act_dtype
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def prefill(params, inputs, cfg, max_len: int, *, rng=None):
    """Run the prompt through the model.  inputs: (b, s) tokens with
    ``s <= max_len``.  Returns ``(logits, cache, lengths)``: the last
    token's logits (b, vocab) — the unembed runs on that one row — a
    cache of every layer's K/V zero-padded to ``max_len``
    (:func:`init_cache`'s layout), and ``lengths`` (b,) = s.

    ``rng`` is one raw (2,) key for the whole call: layer ``idx`` draws
    from ``fold_in(rng, idx)``, the unembed from ``rng`` itself.
    """
    require_ported(cfg)
    x = _embed_inputs(params, inputs, cfg, rng)
    b, s = x.shape[:2]
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len={max_len}")
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    cache = init_cache(cfg, b, max_len, x.dtype, device=x.device)
    for idx in range(cfg.n_layers):
        key = layers.fold_keys(rng, idx)
        x, (k, v) = _apply_block(
            x, _layer(params["blocks"], idx), cfg, positions, key
        )
        cache["k"][idx, :, :s] = k
        cache["v"][idx, :, :s] = v
    x = layers.rms_norm(x, params["final_norm"])
    logits = _logits(x[:, -1], params, cfg, rng)
    lengths = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return logits, cache, lengths


def decode_step(params, cache, tokens, lengths, cfg, *, rng=None):
    """One token per row.  tokens: (b,) next input ids; lengths: (b,)
    current fill (the new token writes at that index, clamped to the
    last one).  Returns ``(logits (b, vocab), cache)``: ``cache`` is the
    dict given, whose buffers this call updated IN PLACE.

    ``rng`` is one raw (2,) key for the whole batch, folded per layer as
    in :func:`prefill`; every row is one row of each SC matmul, so a
    row's bits depend on its neighbours (the fixed-slot engine's
    contract, unlike :func:`decode_paged`'s per-request keys).
    """
    require_ported(cfg)
    x = layers.embed(tokens, params["embed"]).to(cfg.act_dtype)[:, None]
    positions = lengths.to(torch.int64)[:, None]
    new_lengths = lengths.to(torch.int64) + 1
    for idx in range(cfg.n_layers):
        key = layers.fold_keys(rng, idx)
        x, _ = _apply_block(
            x,
            _layer(params["blocks"], idx),
            cfg,
            positions,
            key,
            cache=(cache["k"][idx], cache["v"][idx]),
            cache_length=new_lengths,
        )
    x = layers.rms_norm(x, params["final_norm"])
    return _logits(x[:, 0], params, cfg, rng), cache


# ---------------------------------------------------------------------------
# Paged serving
# ---------------------------------------------------------------------------


def init_paged_cache(cfg, num_blocks: int, block_size: int, *, device=None):
    """One pool of ``num_blocks`` token blocks per layer, in
    ``cfg.act_dtype`` (block 0 is the reserved null block)."""
    require_ported(cfg)
    device = resolve_device(device)
    kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (cfg.n_layers, num_blocks, block_size, kvh, hd)
    return {
        "k": torch.zeros(shape, dtype=cfg.act_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.act_dtype, device=device),
    }


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
    """
    require_ported(cfg)
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
    for idx in range(cfg.n_layers):
        lp = _layer(params["blocks"], idx)
        lkeys = layers.fold_keys(keys, idx)
        h, _, _ = attention.paged_attention_block(
            layers.rms_norm(x, lp["ln1"]),
            lp["attn"],
            cfg,
            positions,
            layers.fold_keys(lkeys, 11),
            pages["k"][idx],
            pages["v"][idx],
            block_table,
            lengths,
            n_valid,
        )
        x = x + h
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
