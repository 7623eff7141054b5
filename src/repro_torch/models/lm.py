"""LM assembly for the paged serving path: parameter specs, the paged
cache, and one chunked decode/prefill step.

Port of the dense branch of ``repro.models.lm``: N × (RMSNorm → GQA attn
→ RMSNorm → SwiGLU MLP), layers stacked on a leading axis and run by a
Python loop (the reference's ``lax.scan``).  The MoE, SSM and hybrid
families, the full-sequence ``forward`` / ``prefill`` / ``decode_step``
and training come with later slices (ROADMAP queue 1 items 7 and 9).
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models import attention, layers
from repro_torch.models.params import ParamSpec, tree_map_specs

_FAMILIES = ("dense",)


def _require_dense(cfg) -> None:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family={cfg.family!r} is not ported yet (ROADMAP queue 1 "
            "item 7); this slice serves the dense family"
        )


def _norm_spec(cfg):
    return ParamSpec((cfg.d_model,), ("embed",), "ones")


def block_specs(cfg):
    _require_dense(cfg)
    return {
        "ln1": _norm_spec(cfg),
        "attn": attention.attn_specs(cfg),
        "ln2": _norm_spec(cfg),
        "ffn": layers.mlp_specs(cfg),
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


def init_paged_cache(cfg, num_blocks: int, block_size: int, *, device=None):
    """One pool of ``num_blocks`` token blocks per layer, in
    ``cfg.act_dtype`` (block 0 is the reserved null block)."""
    _require_dense(cfg)
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
    _require_dense(cfg)
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
        x = x + layers.mlp(layers.rms_norm(x, lp["ln2"]), lp["ffn"], cfg, fkey)
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
