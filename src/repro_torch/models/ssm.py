"""Mamba2 (SSD — state-space duality) layer: chunked train/prefill scan and
O(1)/token recurrent decode.  [arXiv:2405.21060]

Port of ``repro.models.ssm``.  The projections are kept split
(wz/wx/wB/wC/wdt instead of one fused in_proj), each a ``layers.dense``
call under its own site salt, so every one of them runs on the SC
substrate (kernel 1 under ``pallas_bitexact``).  The scan and the
recurrence are plain float32 torch ops, as the reference's are plain
``jnp`` (it has no Pallas kernel for them).

The chunked SSD algorithm (chunk length L):
  intra-chunk:  y_t += Σ_{j≤t}  (C_t·B_j) · exp(cum_t − cum_j) · dt_j · x_j
  chunk state:  S_c  = Σ_j exp(cum_L − cum_j) · dt_j · B_j ⊗ x_j
  carry:        H_c  = exp(Σ_chunk dA) · H_{c−1} + S_c
  inter-chunk:  y_t += exp(cum_t) · C_t · H_{c−1}
with cum the within-chunk cumulative sum of dA = dt·A (A < 0).  Decode
keeps H directly: H ← exp(dA)·H + dt·B⊗x, y = C·H + D·x.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models import layers
from repro_torch.models.params import ParamSpec
from repro_torch.sharding import tp as tp_lib


def ssm_specs(cfg):
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    k = cfg.ssm_conv
    return {
        "wz": ParamSpec((d, di), ("embed", "ssm_inner"), "scaled"),
        "wx": ParamSpec((d, di), ("embed", "ssm_inner"), "scaled"),
        "wB": ParamSpec((d, n), ("embed", "ssm_state"), "scaled"),
        "wC": ParamSpec((d, n), ("embed", "ssm_state"), "scaled"),
        "wdt": ParamSpec((d, h), ("embed", "heads"), "scaled"),
        "conv_x": ParamSpec((k, di), ("conv", "ssm_inner"), "scaled"),
        "conv_B": ParamSpec((k, n), ("conv", "ssm_state"), "scaled"),
        "conv_C": ParamSpec((k, n), ("conv", "ssm_state"), "scaled"),
        "A_log": ParamSpec((h,), ("heads",), "zeros"),
        "D": ParamSpec((h,), ("heads",), "ones"),
        "dt_bias": ParamSpec((h,), ("heads",), "zeros"),
        "norm": ParamSpec((di,), ("ssm_inner",), "ones"),
        "out": ParamSpec((di, d), ("ssm_inner", "embed"), "scaled"),
    }


def _causal_conv(x, w, cache=None):
    """Depthwise causal conv over seq.  x: (b, s, c), w: (k, c).

    With a cache (b, k-1, c) it streams (s == 1 in decode) and returns
    the updated cache; without, it pads with zeros (train / prefill).
    The cache and ``x`` concatenate in their promoted dtype (a float32
    cache beside bf16 activations gives float32, as ``jnp.concatenate``
    promotes), and the k taps add in the reference's order, from 0.
    """
    k = w.shape[0]
    if cache is None:
        pad = torch.zeros(x.shape[0], k - 1, x.shape[2], dtype=x.dtype,
                          device=x.device)
        xp = torch.cat([pad, x], dim=1)
        new_cache = None
    else:
        dt = torch.promote_types(cache.dtype, x.dtype)
        xp = torch.cat([cache.to(dt), x.to(dt)], dim=1)
        new_cache = xp[:, -(k - 1):, :] if k > 1 else cache
    s = x.shape[1]
    out = sum(xp[:, i:i + s, :] * w[i] for i in range(k))
    return out, new_cache


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``torch.nn.functional.
    softplus`` switches to ``x`` above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _project(x, p, cfg, key=None, hb=None, ib=None):
    """Input / B / C / dt projections through the substrate, one site
    each.  ``key`` is None, a raw (2,) key, or per-token (b, s, 2) keys:
    each projection folds its own site salt.  With ``hb`` / ``ib`` (the
    rank's blocks of the SSM heads and of ``d_inner``) z / xin are its
    ``d_inner`` block and dt its heads block (column-parallel); B and C
    stay whole."""

    def proj(name, cols=None):
        site = "ssm_" + name
        return layers.dense(x, p[name], cfg, layers.site_key(key, site),
                            site=site, cols=cols)

    z, xin, B, C = proj("wz", ib), proj("wx", ib), proj("wB"), proj("wC")
    bias = p["dt_bias"] if hb is None else hb.slice(p["dt_bias"], 0)
    dt = _softplus(proj("wdt", hb).to(torch.float32)
                   + bias.to(torch.float32))
    return z, xin, B, C, dt


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """Chunked SSD scan.  x: (b, s, h, p); dt: (b, s, h); A: (h,) < 0;
    B, C: (b, s, n).  Returns (y (b, s, h, p) float32, H_final
    (b, h, n, p))."""
    b, s, h, pdim = x.shape
    n = B.shape[-1]
    L = min(chunk, s)
    # Front-pad to a chunk multiple: zero inputs add nothing to any state
    # or output.
    pad = (-s) % L
    if pad:
        def front(v):
            z = torch.zeros((b, pad) + v.shape[2:], dtype=v.dtype,
                            device=v.device)
            return torch.cat([z, v], dim=1)

        x, dt, B, C = front(x), front(dt), front(B), front(C)
        s = s + pad
    nc = s // L

    def ch(v):
        return v.reshape((b, nc, L) + v.shape[2:])

    xc = ch(x).to(torch.float32)
    dtc = ch(dt)  # (b, nc, L, h)
    Bc = ch(B).to(torch.float32)  # (b, nc, L, n)
    Cc = ch(C).to(torch.float32)
    dA = dtc * A  # (b, nc, L, h), negative
    cum = torch.cumsum(dA, dim=2)  # within-chunk cumsum

    # Intra-chunk (the dual, attention-like form).  The decay exponent is
    # masked BEFORE exp, so non-causal pairs (positive exponents) cannot
    # overflow.
    att = torch.einsum("bcln,bcjn->bclj", Cc, Bc)  # (b, nc, L, L)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b,nc,L,L,h)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    decay = torch.exp(torch.where(causal, diff,
                                  torch.full_like(diff, -torch.inf)))
    w = att[..., None] * decay  # (b, nc, L, L, h)
    y_intra = torch.einsum("bcljh,bcjh,bcjhp->bclhp", w, dtc, xc)

    # Chunk states and the inter-chunk carry.
    last = cum[:, :, -1:, :]  # (b, nc, 1, h)
    sdecay = torch.exp(last - cum)  # (b, nc, L, h)
    S = torch.einsum("bcln,bclh,bclhp->bchnp", Bc, sdecay * dtc, xc)
    chunk_decay = torch.exp(last[:, :, 0, :])  # (b, nc, h)

    H = torch.zeros((b, h, n, pdim), dtype=torch.float32, device=x.device)
    prevs = []
    for c in range(nc):
        prevs.append(H)
        H = chunk_decay[:, c, :, None, None] * H + S[:, c]
    Hprevs = torch.stack(prevs, dim=1)  # (b, nc, h, n, p)

    y_inter = torch.einsum("bcln,bclh,bchnp->bclhp", Cc, torch.exp(cum),
                           Hprevs)
    y = (y_intra + y_inter).reshape(b, s, h, pdim)
    if pad:
        y = y[:, pad:]
    return y, H


def _outer(Bf, dt, xh):
    """``einsum("bn,bh,bhp->bhnp")`` in the reference's rounding: XLA
    multiplies the smaller pair first (dt·x when n > p, else dt·B)."""
    if Bf.shape[-1] > xh.shape[-1]:
        return (dt[:, :, None] * xh)[:, :, None, :] * Bf[:, None, :, None]
    return (dt[:, :, None] * Bf[:, None, :])[..., None] * xh[:, :, None, :]


def _blocks(cfg, constrain, cache):
    """This rank's blocks ``(heads, d_inner)`` of the in-layer layout, or
    ``(None, None)``: training lays them out wherever the SSM heads
    divide ``model``; prefill and decode only where the decode state
    holds the block (``constrain.state``, ``cst.lay_out_cache``)."""
    tp = tp_lib.of(constrain) if cache is None \
        else getattr(constrain, "state", None)
    hb = None if tp is None else tp.block(cfg.ssm_heads)
    if hb is None:
        return None, None
    return hb, tp.block(cfg.d_inner)


def _gated_norm(y, gate, p, cfg, key, ib):
    """``rms_norm(y · gate)`` then the ``out`` projection.  On a block
    ``ib`` of ``d_inner``: where ``out`` runs row-parallel the norm's sum
    of squares is summed over ``model`` (``tp.all_sum``) and the norm's
    weight sliced; where it takes per-row keys the block is gathered
    whole first and the norm is the whole layout's."""
    okey = layers.site_key(key, "ssm_out")
    yg = y * gate
    if ib is None or not layers.contract_local_ok(cfg, okey, ib):
        if ib is not None:
            yg = ib.gather(yg, -1)
        yn = layers.rms_norm(yg, p["norm"])
        return layers.dense(yn, p["out"], cfg, okey, site="ssm_out")
    dt = yg.dtype
    xf = yg.to(torch.float32)
    var = tp_lib.all_sum((xf * xf).sum(dim=-1, keepdim=True),
                         ib) / ib.length
    yn = (xf * torch.rsqrt(var + 1e-6)).to(dt) * ib.slice(p["norm"], 0)
    return layers.dense(yn, p["out"], cfg, okey, site="ssm_out", rows=ib)


def ssm_block(x, p, cfg, key=None, *, cache=None, constrain=None):
    """The full Mamba2 block.  Returns ``(out, new_cache)``.

    ``cache`` None -> train (no cache out); the string ``"prefill"`` ->
    the chunked pass, also returning a decode cache (the raw conv tails
    and the final SSD state); a dict (``conv_x``, ``conv_B``, ``conv_C``,
    ``state``) -> one-token decode, returning a new dict.

    Keys: a raw (2,) key with s > 1 fans out PER SSD CHUNK (position t
    draws from ``fold_in(key, t // ssm_chunk)``); decode (s == 1) keeps
    the raw key; per-token (b, s, 2) keys pass through.

    Under the in-layer layout (``constrain``, ``sharding/tp.py``; see
    :func:`_blocks`) z, xin, ``conv_x``, y and the gated norm's weight
    run on the rank's ``d_inner`` block, dt, A, D and the SSD on its
    heads block, and B and C stay whole (entered: each rank's heads use
    them); the decode cache's ``conv_x`` and ``state`` are the blocks.
    """
    b, s, _ = x.shape
    hb, ib = _blocks(cfg, constrain, cache)
    h, pdim = cfg.ssm_heads, cfg.ssm_headdim
    di = cfg.d_inner
    if hb is not None:
        h, di = hb.width, ib.width
    if key is not None and key.dim() == 1 and s > 1:
        # folded where the key lies (the trainer's keys stay on the host;
        # the substrate moves each draw's keys to the operands' device)
        ck = torch.arange(s, device=key.device) // cfg.ssm_chunk
        key = layers.fold_keys(key.expand(b, s, 2), ck[None].expand(b, s))
    z, xin, B, C, dt = _project(x, p, cfg, key, hb, ib)
    a_log, d_skip, conv_x = p["A_log"], p["D"], p["conv_x"]
    if hb is not None:
        a_log, d_skip = hb.slice(a_log, 0), hb.slice(d_skip, 0)
        conv_x = ib.slice(conv_x, 1)
    A = -torch.exp(a_log.to(torch.float32))  # (h,) negative
    D = d_skip.to(torch.float32)[None, None, :, None]

    if cache is None or isinstance(cache, str):
        k = cfg.ssm_conv
        raw = (xin, B, C)
        xin, _ = _causal_conv(xin, conv_x)
        B, _ = _causal_conv(B, p["conv_B"])
        C, _ = _causal_conv(C, p["conv_C"])
        if hb is not None:
            B, C = tp_lib.enter(B, hb), tp_lib.enter(C, hb)
        xin = torch.nn.functional.silu(xin.to(torch.float32)).to(x.dtype)
        xh = xin.reshape(b, s, h, pdim)
        y, H_final = ssd_chunked(xh, dt, A, B.to(torch.float32),
                                 C.to(torch.float32), cfg.ssm_chunk)
        y = y + D * xh.to(torch.float32)
        new_cache = None
        if cache == "prefill":
            rx, rB, rC = raw
            new_cache = {
                "conv_x": rx[:, -(k - 1):, :],
                "conv_B": rB[:, -(k - 1):, :],
                "conv_C": rC[:, -(k - 1):, :],
                "state": H_final,
            }
    else:
        xin, cx = _causal_conv(xin, conv_x, cache["conv_x"])
        B, cB = _causal_conv(B, p["conv_B"], cache["conv_B"])
        C, cC = _causal_conv(C, p["conv_C"], cache["conv_C"])
        xin = torch.nn.functional.silu(xin.to(torch.float32)).to(x.dtype)
        xh = xin.reshape(b, 1, h, pdim).to(torch.float32)
        dA = torch.exp(dt[:, 0] * A)  # (b, h)
        Bf = B[:, 0].to(torch.float32)  # (b, n)
        Cf = C[:, 0].to(torch.float32)
        state = dA[..., None, None] * cache["state"] + _outer(
            Bf, dt[:, 0], xh[:, 0])
        y = torch.einsum("bn,bhnp->bhp", Cf, state)[:, None]
        y = y + D * xh
        new_cache = {"conv_x": cx, "conv_B": cB, "conv_C": cC,
                     "state": state}

    y = y.reshape(b, s, di).to(x.dtype)
    gate = torch.nn.functional.silu(z.to(torch.float32)).to(x.dtype)
    return _gated_norm(y, gate, p, cfg, key, ib), new_cache


def ssm_stream(x, p, cfg, key, cache, valid):
    """Chunk-width-invariant SSM feed for the paged engine.

    Runs :func:`ssm_block`'s one-token recurrent update over the chunk
    axis, merging the cache only at VALID positions, so a request's
    state (and its tokens) is bit-identical whether its context arrives
    in one chunk, many, or is replayed after an eviction.  Invalid
    positions (chunk padding, idle rows) compute and are discarded.  The
    merge is a ``torch.where`` on the device: no host sync.

    x: (b, sc, d); key: None or per-token (b, sc, 2); cache: the dict of
    :func:`init_ssm_cache`; valid: (b, sc) bool.  Returns (y (b, sc, d),
    new_cache).
    """
    ys = []
    for t in range(x.shape[1]):
        kt = None if key is None else key[:, t]
        yt, nc = ssm_block(x[:, t:t + 1], p, cfg, kt, cache=cache)
        vt = valid[:, t]
        cache = {
            name: torch.where(
                vt.reshape((-1,) + (1,) * (old.dim() - 1)), nc[name], old)
            for name, old in cache.items()
        }
        ys.append(yt[:, 0])
    return torch.stack(ys, dim=1), cache


def init_ssm_cache(cfg, batch: int, dtype=torch.float32, *, device=None,
                   heads=None):
    """Zero conv tails in ``dtype`` and a float32 SSD state for ``batch``
    rows; with ``heads`` (a block of the SSM heads) the state holds that
    block of the heads and ``conv_x`` the matching block of ``d_inner``."""
    device = resolve_device(device)
    k, di, n = cfg.ssm_conv, cfg.d_inner, cfg.ssm_state
    h = cfg.ssm_heads if heads is None else heads.width
    di = di if heads is None else h * cfg.ssm_headdim

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    return {
        "conv_x": zeros((batch, k - 1, di), dtype),
        "conv_B": zeros((batch, k - 1, n), dtype),
        "conv_C": zeros((batch, k - 1, n), dtype),
        "state": zeros((batch, h, n, cfg.ssm_headdim), torch.float32),
    }
