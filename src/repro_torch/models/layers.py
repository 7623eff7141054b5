"""Primitive layers: RMSNorm, Linear (SC-routable), the SwiGLU / GELU
MLP, RoPE, embed.

Port of ``repro.models.layers``.  Every weight matmul goes through
:func:`dense` (the MoE capacity buffers through :func:`expert_dense`),
which routes to the SC substrate registry when
``cfg.sc_backend != "exact"`` — under a NAMED SITE whose salt folds into
the caller's key (the salts are part of the bit-reproducibility contract
and equal the reference's).  Keys are explicit ``uint32`` tensors.
Every function here is differentiable: stochastic matmuls carry the
straight-through gradient of ``sc.sc_dot`` / ``sc.sc_dot_rows``.
"""

from __future__ import annotations

import torch

from repro_torch import sc
from repro_torch.models.params import ParamSpec
from repro_torch.sc import ctr_rng


def rms_norm(x, weight, eps: float = 1e-6):
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * weight


# ----------------------------- Matmul sites ---------------------------------
#
# A site's salt is folded into the caller's key before the stochastic
# draw, so two sites fed the same (request, position) key still draw
# independent SC bits.  ``None`` means the site consumes the caller's key
# unfolded.  Folds applied outside this table: per-layer index folds,
# 11/13 (attn/ffn inside a block), 23+j (qkv per-token path), 7 (attn
# out), 29 (fused_sc attention draw), 0x5EED (sampling).

SITES: dict = {
    "mlp_wi": None,  # raw block key (pre-table convention)
    "mlp_wo": 1,
    "attn_qkv": None,  # _project_qkv folds 23+j / splits internally
    "attn_wo": None,  # attention folds its own okey
    "ssm_out": 3,
    "moe_router": 31,
    "moe_wi": 37,
    "moe_wo": 41,
    "ssm_wz": 47,
    "ssm_wx": 53,
    "ssm_wB": 59,
    "ssm_wC": 61,
    "ssm_wdt": 67,
    "unembed": 71,
    "frontend_proj": 73,
}


def site_key(key, site: str, data=None):
    """``key`` folded with ``site``'s salt, then (optionally) ``data``."""
    salt = SITES[site]
    k = key if salt is None else fold_keys(key, salt)
    return k if data is None else fold_keys(k, data)


def fold_keys(key, data):
    """``jax.random.fold_in`` broadcast over an array of raw keys.

    ``key`` is None (passed through), one raw ``(2,)`` key, or ``(..., 2)``
    keys; ``data`` an int or an int tensor matching the leading dims.
    """
    if key is None:
        return None
    return ctr_rng.fold_in(key, data)


def _dense_rows(keys, x, w, sc_cfg):
    """Per-row SC dispatch: row i of ``x`` draws its bits (and its max-abs
    encoding scale) from ``keys[i]`` alone."""
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
    kf = keys.reshape(-1, keys.shape[-1])
    yf = sc.sc_dot_rows(kf, xf, w.to(torch.float32), sc_cfg)
    return yf.reshape(*lead, w.shape[-1]).to(x.dtype)


def _sc_config(cfg):
    """The substrate of a stochastic matmul: ``fast_backend`` upgrades
    pallas_bitexact to the bit-identical fused engine; the ambient device
    profile rides along (array realizes it, every other backend models
    the ideal device)."""
    return sc.ScConfig(
        backend=sc.fast_backend(cfg.sc_backend, cfg.sc_nbit),
        nbit=cfg.sc_nbit,
        device=sc.current_device_profile(),
    )


def dense(x, w, cfg, key=None, bias=None, site: str = "dense"):
    """x @ w with the configured multiplication substrate.

    Stochastic backends REQUIRE a key (raw ``(2,)``, or per-row keys whose
    leading dims match ``x``'s, making each row's output a function of its
    own key and data only).
    """
    if cfg.sc_backend == "exact":
        y = x @ w.to(x.dtype)
    elif key is None:
        raise ValueError(
            f"layers.dense at site {site!r}: sc_backend="
            f"{cfg.sc_backend!r} is stochastic but key=None"
        )
    else:
        sc_cfg = _sc_config(cfg)
        if key.dim() > 1:
            y = _dense_rows(key, x, w, sc_cfg)
        else:
            xf = x.to(torch.float32)
            y = sc.sc_dot(key, xf, w.to(torch.float32), sc_cfg).to(x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


# ----------------------------- MLP (SwiGLU / GELU) -------------------------


def mlp_specs(cfg):
    d, f = cfg.d_model, cfg.d_ff
    wi_cols = 2 * f if cfg.mlp_variant == "swiglu" else f
    return {
        "wi": ParamSpec((d, wi_cols), ("embed", "mlp"), "scaled"),
        "wo": ParamSpec((f, d), ("mlp", "embed"), "scaled"),
    }


def mlp(x, p, cfg, key=None):
    """SwiGLU on a (d, 2·d_ff) ``wi``, or (``mlp_variant="gelu"``) the
    tanh-approximated GELU on a (d, d_ff) ``wi`` — ``jax.nn.gelu``'s
    default, as the reference calls it."""
    h = dense(x, p["wi"], cfg, site_key(key, "mlp_wi"), site="mlp_wi")
    if cfg.mlp_variant == "swiglu":
        gate, up = torch.chunk(h, 2, dim=-1)
        act = torch.nn.functional.silu(gate.to(torch.float32)).to(x.dtype)
        act = act * up
    else:
        act = torch.nn.functional.gelu(h.to(torch.float32),
                                       approximate="tanh").to(x.dtype)
    return dense(act, p["wo"], cfg, site_key(key, "mlp_wo"), site="mlp_wo")


# ----------------------------- RoPE -----------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    i = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (b, s, h, d); positions: (b, s) int."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # (d/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (b, s, d/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------- Embedding ------------------------------------


def embed_specs(cfg):
    return {"table": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"))}


def embed(tokens, p):
    return p["table"][tokens.long()]


def unembed(x, p, cfg, key=None):
    return dense(x, p["table"].T, cfg, key, site="unembed")


# ----------------------------- Expert matmul --------------------------------


def expert_dense(x, w, cfg, key=None, site: str = "moe_wi"):
    """Per-expert batched matmul: (b, e, c, d) @ (e, d, f) -> (b, e, c, f).

    The MoE capacity-buffer contraction.  Under ``exact`` it is one
    einsum.  Stochastic backends loop over the experts, one
    ``sc_dot_rows`` call per expert (one launch of the fused kernel in
    row-key mode), and every capacity slot draws from its own key folded
    with ``site``'s salt and the expert index.

    ``key`` is None (``exact`` only: a stochastic backend raises naming
    the site), one raw (2,) key (broadcast to every slot), or a
    (b, e, c, 2) buffer of per-slot keys dispatched alongside ``x``.
    """
    if cfg.sc_backend == "exact":
        return torch.einsum("becd,edf->becf", x, w.to(x.dtype))
    if key is None:
        raise ValueError(
            f"layers.expert_dense at site {site!r}: sc_backend="
            f"{cfg.sc_backend!r} is stochastic but key=None — pass a key "
            "so expert matmuls draw on the substrate"
        )
    b, e, c, _ = x.shape
    if key.dim() == 1:
        key = key.expand(b, e, c, 2)
    eidx = torch.arange(e, device=x.device)[None, :, None].expand(b, e, c)
    keys = site_key(key, site, eidx)  # (b, e, c, 2)
    sc_cfg = _sc_config(cfg)
    ys = [_dense_rows(keys[:, i], x[:, i], w[i], sc_cfg) for i in range(e)]
    return torch.stack(ys, dim=1)
