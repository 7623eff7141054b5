"""GQA attention: full and blockwise (online-softmax) attention over a
whole sequence for training, and the paged KV cache for chunked decode
and prefill.

Port of ``repro.models.attention`` minus the fixed-slot ring-buffer
decode (``attention_block`` with a cache), which comes with the
fixed-slot engine (ROADMAP queue 1 item 9).  The paged decode
path (:func:`paged_attention_block`) routes through ``cfg.paged_attn``:
``"unfused"`` runs the reference gather -> :func:`chunk_decode_attention`
sequence, ``"fused"`` / ``"fused_sc"`` dispatch to the CUDA kernels in
``kernels/paged_attention.py``.  GQA is computed grouped: q heads are
reshaped to (kv_heads, group) so no KV head replication is materialized.

The page pools are updated IN PLACE (``paged_scatter``,
``paged_copy_blocks``): eager PyTorch has no reason to copy a whole pool
per token, so these functions write into the tensors they are given and
return them.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import paged_attention
from repro_torch.models import layers
from repro_torch.models.params import ParamSpec
from repro_torch.sc import ctr_rng

NEG_INF = -1e30


def attn_specs(cfg):
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    sp = {
        "wq": ParamSpec((d, h * hd), ("embed", "heads"), "scaled"),
        "wk": ParamSpec((d, kv * hd), ("embed", "kv_embed"), "scaled"),
        "wv": ParamSpec((d, kv * hd), ("embed", "kv_embed"), "scaled"),
        "wo": ParamSpec((h * hd, d), ("heads", "embed"), "scaled"),
    }
    if cfg.qkv_bias:
        sp["bq"] = ParamSpec((h * hd,), ("heads",), "zeros")
        sp["bk"] = ParamSpec((kv * hd,), ("kv_embed",), "zeros")
        sp["bv"] = ParamSpec((kv * hd,), ("kv_embed",), "zeros")
    if cfg.qk_norm:
        sp["q_norm"] = ParamSpec((hd,), (None,), "ones")
        sp["k_norm"] = ParamSpec((hd,), (None,), "ones")
    return sp


def _project_qkv(x, p, cfg, positions, key=None):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if key is None:
        keys = [None] * 3
    elif key.dim() > 1:
        # Per-token keys (paged/chunked decode): one fold per projection,
        # so each token's draw stays a function of its own key alone.
        keys = [layers.fold_keys(key, 23 + j) for j in range(3)]
    else:
        keys = list(ctr_rng.split(key, 3))
    q = layers.dense(x, p["wq"], cfg, keys[0], p.get("bq"))
    k = layers.dense(x, p["wk"], cfg, keys[1], p.get("bk"))
    v = layers.dense(x, p["wv"], cfg, keys[2], p.get("bv"))
    q, k = q.reshape(b, s, h, hd), k.reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = layers.rms_norm(q, p["q_norm"])
        k = layers.rms_norm(k, p["k_norm"])
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v.reshape(b, s, kv, hd)


def _grouped(q, kv_heads: int):
    b, s, h, hd = q.shape
    return q.reshape(b, s, kv_heads, h // kv_heads, hd)


def full_attention(q, k, v, *, causal: bool = True):
    """Reference O(S²) attention. q: (b,s,h,d), k/v: (b,t,kv,d)."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = _grouped(q, kv).to(torch.float32)  # (b,s,kv,g,d)
    scale = paged_attention._scale(hd)
    kf = k.to(torch.float32)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, kf) * scale
    if causal:
        t = k.shape[1]
        mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
        mask = torch.tril(mask, diagonal=t - s)
        logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    vf = v.to(torch.float32)
    out = torch.einsum("bkgst,btkd->bskgd", w, vf)
    return out.reshape(b, s, h, hd).to(q.dtype)


def blockwise_attention(q, k, v, *, causal: bool = True, chunk: int = 1024):
    """Flash-style attention: query chunks outside, KV chunks inside, with
    an online softmax (running max, denominator, accumulator).  Matches
    :func:`full_attention` to float tolerance; the peak intermediate is
    one (b, kv, g, cq, ckv) logits tile.  Queries are the LAST s
    positions of the KV timeline.
    """
    b, s, h, hd = q.shape
    kv = k.shape[2]
    t = k.shape[1]
    ckv = min(chunk, t)
    cq = min(chunk, s)
    g = h // kv
    scale = paged_attention._scale(hd)
    qg = _grouped(q, kv).to(torch.float32).permute(0, 2, 3, 1, 4)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    q_off = t - s
    outs = []
    for q0 in range(0, s, cq):
        qi = qg[:, :, :, q0 : q0 + cq]  # (b,kv,g,cq,d)
        n_q = qi.shape[3]
        q_idx = q0 + q_off + torch.arange(n_q, device=q.device)
        m = torch.full((b, kv, g, n_q), NEG_INF, device=q.device)
        denom = torch.zeros((b, kv, g, n_q), device=q.device)
        acc = torch.zeros((b, kv, g, n_q, hd), device=q.device)
        for t0 in range(0, t, ckv):
            kc = kf[:, t0 : t0 + ckv]
            vc = vf[:, t0 : t0 + ckv]
            logits = torch.einsum("bkgsd,btkd->bkgst", qi, kc) * scale
            if causal:
                kv_idx = t0 + torch.arange(kc.shape[1], device=q.device)
                mask = kv_idx[None, :] <= q_idx[:, None]
                logits = torch.where(mask, logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            denom = denom * alpha + p.sum(dim=-1)
            pv = torch.einsum("bkgst,btkd->bkgsd", p, vc)
            acc = acc * alpha[..., None] + pv
            m = m_new
        outs.append(acc / torch.clamp_min(denom, 1e-30)[..., None])
    out = torch.cat(outs, dim=3)  # (b,kv,g,s,d)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)
    return out.to(q.dtype)


def attention_block(x, p, cfg, positions, key=None, *, cache=None):
    """Self-attention sub-block over a whole sequence (training, eval).
    Returns ``(out, (k, v))``: causal attention through
    ``cfg.attn_impl`` (``"blockwise"`` or ``"full"``), then the output
    projection under the key folded with 7.
    """
    if cache is not None:
        raise NotImplementedError(
            "attention_block over a fixed-slot ring-buffer cache is not "
            "ported yet (ROADMAP queue 1 item 9); the paged path is "
            "paged_attention_block"
        )
    q, k, v = _project_qkv(x, p, cfg, positions, key)
    if cfg.attn_impl == "full":
        out = full_attention(q, k, v, causal=True)
    elif cfg.attn_impl == "blockwise":
        out = blockwise_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    else:
        raise ValueError(
            f"unknown cfg.attn_impl={cfg.attn_impl!r} "
            "(expected 'blockwise' or 'full')"
        )
    b, s = out.shape[:2]
    okey = layers.fold_keys(key, 7)
    y = layers.dense(out.reshape(b, s, -1), p["wo"], cfg, okey)
    return y, (k, v)


def chunk_decode_attention(q, k_cache, v_cache, lengths):
    """A chunk of queries against a per-sequence cache.

    q: (b, sc, h, d) — chunk token i of row r sits at ABSOLUTE position
    ``lengths[r] + i`` (its K/V already in the cache); k/v_cache:
    (b, L, kv, d).  Causal within the chunk, masked beyond each row's
    fill.  Serves both decode (sc = 1) and chunked prefill.
    """
    b, sc, h, hd = q.shape
    kv = k_cache.shape[2]
    qg = q.reshape(b, sc, kv, h // kv, hd).to(torch.float32)
    scale = paged_attention._scale(hd)
    kf = k_cache.to(torch.float32)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, kf) * scale
    t_idx = torch.arange(k_cache.shape[1], device=q.device)
    steps = torch.arange(sc, device=q.device)
    q_pos = lengths.to(torch.int64)[:, None] + steps[None, :]  # (b, sc)
    mask = t_idx[None, None, :] <= q_pos[:, :, None]  # (b, sc, L)
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    vf = v_cache.to(torch.float32)
    out = torch.einsum("bkgst,btkd->bskgd", w, vf)
    return out.reshape(b, sc, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Paged KV lookup: fixed-size token blocks + per-sequence block tables
# ---------------------------------------------------------------------------


def paged_gather(pages, block_table):
    """Materialize each sequence's cache view from the block pool.

    pages: (P, bs, kv, d); block_table: (b, nb) — position t of row r
    lives in ``pages[block_table[r, t // bs], t % bs]``.  Returns the
    gathered (b, nb·bs, kv, d) view.
    """
    g = pages[block_table.long()]  # (b, nb, bs, kv, d)
    b, nb, bs = g.shape[:3]
    return g.reshape(b, nb * bs, *g.shape[3:])


def paged_scatter(pages, block_table, new, lengths, n_valid):
    """Write a chunk's K or V rows into the pool IN PLACE; returns it.

    new: (b, sc, kv, d) — token i of row r goes to absolute position
    ``lengths[r] + i`` when ``i < n_valid[r]``; tokens beyond a row's
    valid count land in the reserved null block 0, which no live
    sequence maps (duplicate writes there are harmless).
    """
    bs = pages.shape[1]
    b, sc = new.shape[:2]
    nb = block_table.shape[1]
    i = torch.arange(sc, device=pages.device)[None, :]
    t = torch.clamp(lengths.to(torch.int64)[:, None] + i, 0, nb * bs - 1)
    valid = i < n_valid.to(torch.int64)[:, None]
    page = torch.gather(block_table.long(), 1, t // bs)
    page = torch.where(valid, page, 0)
    off = torch.where(valid, t % bs, 0)
    flat = new.reshape(b * sc, *new.shape[2:]).to(pages.dtype)
    pages[page.reshape(-1), off.reshape(-1)] = flat
    return pages


def paged_copy_blocks(pages, src, dst):
    """Copy whole pool blocks ``src[i] -> dst[i]`` on every layer, IN
    PLACE (the device half of copy-on-write).  pages: ``{"k", "v"}``
    (layers, P, bs, kv, d) tensors; returns the same dict."""
    dev = pages["k"].device
    src = torch.as_tensor(src, dtype=torch.int64, device=dev)
    dst = torch.as_tensor(dst, dtype=torch.int64, device=dev)
    for name in ("k", "v"):
        pool = pages[name]
        pool[:, dst] = pool[:, src]
    return pages


def paged_attention_block(
    x,
    p,
    cfg,
    positions,
    key,
    k_pages,
    v_pages,
    block_table,
    lengths,
    n_valid,
):
    """Self-attention over the paged KV cache (chunked decode/prefill).

    x: (b, sc, d) chunk activations; the chunk's K/V scatter into the
    pool first (in place), then attention runs over each row's pages.
    ``cfg.paged_attn`` selects ``"unfused"``, ``"fused"`` or
    ``"fused_sc"`` (needs per-token keys; draws under salt 29).
    Returns (out, k_pages, v_pages).
    """
    q, k, v = _project_qkv(x, p, cfg, positions, key)
    paged_scatter(k_pages, block_table, k, lengths, n_valid)
    paged_scatter(v_pages, block_table, v, lengths, n_valid)
    mode = cfg.paged_attn
    if mode == "fused":
        out = paged_attention.paged_attention_fused(
            q, k_pages, v_pages, block_table, lengths
        )
    elif mode == "fused_sc":
        if key is None or key.dim() <= 1:
            raise ValueError(
                "paged_attn='fused_sc' needs per-token rng keys (pass "
                "rng to decode_paged) so attention draws stay pinned to "
                "(request, position)"
            )
        out = paged_attention.paged_attention_fused_sc(
            layers.fold_keys(key, 29),
            q,
            k_pages,
            v_pages,
            block_table,
            lengths,
            nbit=cfg.sc_nbit,
        )
    elif mode == "unfused":
        kc = paged_gather(k_pages, block_table)
        vc = paged_gather(v_pages, block_table)
        out = chunk_decode_attention(q, kc, vc, lengths)
    else:
        raise ValueError(
            f"unknown cfg.paged_attn={mode!r} "
            "(expected 'unfused', 'fused', or 'fused_sc')"
        )
    b, s = out.shape[:2]
    okey = layers.fold_keys(key, 7)
    y = layers.dense(out.reshape(b, s, -1), p["wo"], cfg, okey)
    return y, k_pages, v_pages
