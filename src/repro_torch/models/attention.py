"""GQA attention: full and blockwise (online-softmax) attention over a
whole sequence for training, and the paged KV cache for chunked decode
and prefill.

Port of ``repro.models.attention``.  :func:`attention_block` also
decodes one token against the fixed-slot engine's per-row cache (a
``(k, v)`` pair of (b, L, kv, d) buffers, written in place).  The paged
decode path (:func:`paged_attention_block`) routes through ``cfg.paged_attn``:
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
from repro_torch.sharding import tp as tp_lib

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


def _project_qkv(x, p, cfg, positions, key=None, q_cols=None,
                 kv_cols=None):
    """q, k, v ``(b, s, heads, hd)`` after the norms and RoPE.  With
    ``q_cols`` / ``kv_cols`` (``sharding.rules.ColBlock``s of the
    projections' columns) q / k and v hold this rank's heads block."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if q_cols is not None:
        h = q_cols.width // hd
    if kv_cols is not None:
        kv = kv_cols.width // hd
    if key is None:
        keys = [None] * 3
    elif key.dim() > 1:
        # Per-token keys (paged/chunked decode): one fold per projection,
        # so each token's draw stays a function of its own key alone.
        keys = [layers.fold_keys(key, 23 + j) for j in range(3)]
    else:
        keys = list(ctr_rng.split(key, 3))
    q = layers.dense(x, p["wq"], cfg, keys[0], p.get("bq"), cols=q_cols)
    k = layers.dense(x, p["wk"], cfg, keys[1], p.get("bk"), cols=kv_cols)
    v = layers.dense(x, p["wv"], cfg, keys[2], p.get("bv"), cols=kv_cols)
    q, k = q.reshape(b, s, h, hd), k.reshape(b, s, kv, hd)
    if cfg.qk_norm:
        # a whole norm weight on a rank's heads: its gradient is partial
        qn, kn = p["q_norm"], p["k_norm"]
        q = layers.rms_norm(q, qn if q_cols is None
                            else tp_lib.enter(qn, q_cols))
        k = layers.rms_norm(k, kn if kv_cols is None
                            else tp_lib.enter(kn, kv_cols))
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v.reshape(b, s, kv, hd)


def _grouped(q, kv_heads: int):
    b, s, h, hd = q.shape
    return q.reshape(b, s, kv_heads, h // kv_heads, hd)


def full_attention(q, k, v, *, causal: bool = True, q_offset=None):
    """Reference O(S²) attention. q: (b,s,h,d), k/v: (b,t,kv,d).  The
    queries sit at positions ``q_offset + i`` of the KV timeline (default
    the last s positions)."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = _grouped(q, kv).to(torch.float32)  # (b,s,kv,g,d)
    scale = paged_attention._scale(hd)
    kf = k.to(torch.float32)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, kf) * scale
    if causal:
        t = k.shape[1]
        off = t - s if q_offset is None else q_offset
        mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
        mask = torch.tril(mask, diagonal=off)
        logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    vf = v.to(torch.float32)
    out = torch.einsum("bkgst,btkd->bskgd", w, vf)
    return out.reshape(b, s, h, hd).to(q.dtype)


def blockwise_attention(q, k, v, *, causal: bool = True, chunk: int = 1024,
                        q_chunk=None, q_offset=None):
    """Flash-style attention: query chunks outside, KV chunks inside, with
    an online softmax (running max, denominator, accumulator).  Matches
    :func:`full_attention` to float tolerance; the peak intermediate is
    one (b, kv, g, cq, ckv) logits tile.  Queries are the LAST s
    positions of the KV timeline, or start at ``q_offset`` (context
    parallelism: a rank's block of the query sequence); ``q_chunk``
    (default ``chunk``) is the query tile, the reference's argument.
    """
    b, s, h, hd = q.shape
    kv = k.shape[2]
    t = k.shape[1]
    ckv = min(chunk, t)
    cq = min(chunk if q_chunk is None else q_chunk, s)
    g = h // kv
    scale = paged_attention._scale(hd)
    qg = _grouped(q, kv).to(torch.float32).permute(0, 2, 3, 1, 4)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    q_off = t - s if q_offset is None else q_offset
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


def attention_block(x, p, cfg, positions, key=None, *, cache=None,
                    cache_length=None, seq=None, constrain=None,
                    need_kv: bool = False):
    """Self-attention sub-block.  Returns ``(out, (k, v))``.

    Without a cache (training, eval, prefill): causal attention over the
    sequence through ``cfg.attn_impl`` (``"blockwise"`` or ``"full"``),
    returning the sequence's K/V so prefill can build a cache.  With
    ``cache=(k_cache, v_cache)`` (b, L, kv, d) buffers, the chunk's K/V
    are written IN PLACE at ``positions[:, 0]`` and the queries attend
    to everything up to ``cache_length - 1`` (:func:`decode_attention`);
    the returned pair is the cache.  With ``seq`` (a
    ``sharding.rules.SeqBlock``) the buffers hold this rank's block of
    the cache's sequence: the write keeps the positions inside it and
    the attention combines the ranks' partials.  The output projection
    draws under the key folded with 7.

    Under a mesh step's in-layer layout (``constrain.tp``,
    ``sharding/tp.py``), the reference's choice per architecture x mesh:

    * ``"heads"`` where the query heads divide ``model``: q is this
      rank's heads block (``wq`` column-parallel), k / v its kv heads
      block where those divide too and nothing needs them whole, else
      whole, of which the rank uses the kv heads its q heads group into;
      ``wo`` is row-parallel.  Decode takes this branch only on a whole
      cache: where the cache's sequence lies over ``model`` (``seq``)
      the heads stay whole (one mesh axis a tensor);
    * ``"cp"`` (context parallelism) where they do not: q keeps this
      rank's block of the sequence and k / v stay whole, one query tile
      (the reference's ``q_chunk=q.shape[1]``) at the block's global
      positions; the output's blocks are gathered before ``wo``.
      A sequence that does not divide stays whole.

    ``need_kv`` (prefill) returns k / v whole for the cache.
    """
    tp = tp_lib.of(constrain)
    layout = None
    if tp is not None:
        layout = tp.heads(cfg)
        if cache is not None and (layout == "cp" or seq is not None):
            layout = None
        elif layout == "cp" and tp.block(x.shape[1]) is None:
            layout = None
    if layout == "heads":
        return _heads_block(x, p, cfg, positions, key, tp, cache=cache,
                            cache_length=cache_length, need_kv=need_kv)
    q, k, v = _project_qkv(x, p, cfg, positions, key)
    if cache is not None:
        kc, vc = cache
        _write_rows(kc, k, positions[:, 0], seq)
        _write_rows(vc, v, positions[:, 0], seq)
        out = decode_attention(q, kc, vc, cache_length, seq)
        kv = (kc, vc)
    elif layout == "cp":
        sb = tp.block(x.shape[1])  # the query sequence's block
        ke, ve = tp_lib.enter(k, sb), tp_lib.enter(v, sb)
        out = _attend(sb.slice(q, 1), ke, ve, cfg, q_offset=sb.start,
                      q_chunk=sb.size)
        out = sb.gather(out, 1)
        kv = (k, v)
    else:
        out = _attend(q, k, v, cfg)
        kv = (k, v)
    b, s = out.shape[:2]
    okey = layers.fold_keys(key, 7)
    y = layers.dense(out.reshape(b, s, -1), p["wo"], cfg, okey)
    return y, kv


def _attend(q, k, v, cfg, *, q_offset=None, q_chunk=None):
    """Causal attention over a whole sequence through ``cfg.attn_impl``."""
    if cfg.attn_impl == "full":
        return full_attention(q, k, v, causal=True, q_offset=q_offset)
    if cfg.attn_impl == "blockwise":
        return blockwise_attention(q, k, v, causal=True, chunk=cfg.attn_chunk,
                                   q_chunk=q_chunk, q_offset=q_offset)
    raise ValueError(
        f"unknown cfg.attn_impl={cfg.attn_impl!r} "
        "(expected 'blockwise' or 'full')"
    )


def _pick_kv(t, cfg, hb):
    """The kv heads of a whole ``t`` (b, L, kv, d) that this rank's query
    heads block ``hb`` groups into: a contiguous run of them where the
    rank's heads cover whole groups or sit in one, else one kv head per
    query head.  Several ranks may use one kv head, so ``t`` is entered
    (its gradient is the ranks' partials summed); where the kv heads
    divide the span each rank's run is its block (a slice)."""
    hd = cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    g = h // kv
    hq = hb.width // hd
    h0 = hb.start // hd
    kb = tp_lib.col_block(hb.mesh, hb.axes, kv)
    if kb is not None:
        return kb.slice(t, 2)
    t = tp_lib.enter(t, hb)
    if (h0 % g == 0 and hq % g == 0) or (g % hq == 0):
        lo, hi = h0 // g, (h0 + hq - 1) // g + 1
        return t.narrow(2, lo, hi - lo)
    idx = (h0 + torch.arange(hq, device=t.device)) // g
    return t.index_select(2, idx)


def _heads_block(x, p, cfg, positions, key, tp, *, cache=None,
                 cache_length=None, need_kv=False):
    """:func:`attention_block`'s ``"heads"`` branch."""
    hd = cfg.resolved_head_dim
    hb = tp.block(cfg.n_heads * hd)
    kvb = None
    if cache is None and not need_kv and cfg.n_kv_heads % tp.span == 0:
        kvb = tp.block(cfg.n_kv_heads * hd)
    q, k, v = _project_qkv(x, p, cfg, positions, key, q_cols=hb,
                           kv_cols=kvb)
    if cache is not None:
        kc, vc = cache
        _write_rows(kc, k, positions[:, 0])
        _write_rows(vc, v, positions[:, 0])
        out = decode_attention(q, _pick_kv(kc, cfg, hb),
                               _pick_kv(vc, cfg, hb), cache_length)
        kv = (kc, vc)
    else:
        ka, va = (k, v) if kvb is not None else (_pick_kv(k, cfg, hb),
                                                 _pick_kv(v, cfg, hb))
        out = _attend(q, ka, va, cfg)
        kv = (k, v)
    b, s = out.shape[:2]
    okey = layers.fold_keys(key, 7)
    y = layers.dense(out.reshape(b, s, -1), p["wo"], cfg, okey, rows=hb)
    return y, kv


def _write_rows(cache, new, start, seq=None):
    """``cache[r, start[r] : start[r] + s] = new[r]`` for every row, IN
    PLACE.  A start past ``L - s`` is clamped to ``L - s``, as
    ``jax.lax.dynamic_update_slice`` clamps it: a request at the cache's
    last position overwrites that position instead of writing past the
    end.  With ``seq`` the cache holds the block ``[seq.start,
    seq.stop)`` of a sequence of ``seq.length``: the start is clamped
    against that global length, and only the positions inside the block
    are written."""
    b, s = new.shape[:2]
    length = cache.shape[1] if seq is None else seq.length
    start = torch.clamp(start.to(torch.int64), 0, length - s)
    rows = torch.arange(b, device=cache.device)
    if seq is None:
        cols = start[:, None] + torch.arange(s, device=cache.device)[None]
        cache[rows[:, None], cols] = new.to(cache.dtype)
        return
    for i in range(s):  # one position a row at a time: no duplicate index
        t = start + i - seq.start
        inside = (t >= 0) & (t < seq.size)
        col = torch.clamp(t, 0, seq.size - 1)
        keep = cache[rows, col]
        mask = inside.reshape((b,) + (1,) * (keep.dim() - 1))
        cache[rows, col] = torch.where(mask, new[:, i].to(cache.dtype), keep)


def decode_attention(q, k_cache, v_cache, length, seq=None):
    """One-token decode: q (b, 1, h, d) against a (b, L, kv, d) cache,
    masked past ``length - 1`` (the query's own position)."""
    return chunk_decode_attention(q, k_cache, v_cache, length - 1, seq)


def chunk_decode_attention(q, k_cache, v_cache, lengths, seq=None):
    """A chunk of queries against a per-sequence cache.

    q: (b, sc, h, d) — chunk token i of row r sits at ABSOLUTE position
    ``lengths[r] + i`` (its K/V already in the cache); k/v_cache:
    (b, L, kv, d).  Causal within the chunk, masked beyond each row's
    fill.  Serves both decode (sc = 1) and chunked prefill.

    With ``seq`` (a ``sharding.rules.SeqBlock``) the cache is this
    rank's block of the sequence (its positions ``seq.start + t``):
    each rank computes its block's partial — the running max, the sum
    of exponentials and the unnormalised output, masked by absolute
    position — and the partials of every rank over ``seq.axes`` merge in
    coordinate order (:func:`_combine`), as kernel 2's combine pass
    merges its splits.
    """
    b, sc, h, hd = q.shape
    kv = k_cache.shape[2]
    qg = q.reshape(b, sc, kv, h // kv, hd).to(torch.float32)
    scale = paged_attention._scale(hd)
    kf = k_cache.to(torch.float32)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, kf) * scale
    t_idx = torch.arange(k_cache.shape[1], device=q.device)
    if seq is not None:
        t_idx = t_idx + seq.start
    steps = torch.arange(sc, device=q.device)
    q_pos = lengths.to(torch.int64)[:, None] + steps[None, :]  # (b, sc)
    mask = t_idx[None, None, :] <= q_pos[:, :, None]  # (b, sc, L)
    mask = mask[:, None, None]
    logits = torch.where(mask, logits, NEG_INF)
    vf = v_cache.to(torch.float32)
    if seq is None:
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkgst,btkd->bskgd", w, vf)
        return out.reshape(b, sc, h, hd).to(q.dtype)
    m = logits.amax(dim=-1)  # NEG_INF where the block holds no position
    # a masked position contributes exactly zero, also where the whole
    # block is masked (exp(NEG_INF - NEG_INF) would be 1)
    p = torch.where(mask, torch.exp(logits - m[..., None]), 0.0)
    part = torch.cat([torch.einsum("bkgst,btkd->bkgsd", p, vf),
                      m[..., None], p.sum(dim=-1)[..., None]], dim=-1)
    out = _combine(part, seq)  # (b, kv, g, sc, d)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sc, h, hd).to(q.dtype)


def _combine(part, seq):
    """Every rank's partial ``(..., d + 2)`` (unnormalised output, max,
    sum of exponentials) over ``seq``'s axes, merged in coordinate
    order: the attention output ``(..., d)``.  A partial of an empty
    block (max NEG_INF, sum 0) adds exactly zero."""
    from repro_torch.sharding.seq import stack_blocks

    parts = stack_blocks(part, seq)
    d = part.shape[-1] - 2
    m = parts[..., d].amax(dim=0)
    acc = torch.zeros_like(parts[0, ..., :d])
    den = torch.zeros_like(m)
    for i in range(parts.shape[0]):
        w = torch.exp(parts[i, ..., d] - m)
        acc = acc + parts[i, ..., :d] * w[..., None]
        den = den + parts[i, ..., d + 1] * w
    return acc / torch.clamp_min(den, 1e-30)[..., None]


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
