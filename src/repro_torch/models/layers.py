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

import dataclasses

import torch

from repro_torch import sc
from repro_torch.models.params import ParamSpec
from repro_torch.sc import ctr_rng
from repro_torch.sharding import tp as tp_lib
from repro_torch.sharding.rules import col_block


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


def dense(x, w, cfg, key=None, bias=None, site: str = "dense", *,
          cols=None, rows=None, w_rows=None):
    """x @ w with the configured multiplication substrate.

    Stochastic backends REQUIRE a key (raw ``(2,)``, or per-row keys whose
    leading dims match ``x``'s, making each row's output a function of its
    own key and data only).  Inside ``sc.use_mesh`` a one-key call goes
    through ``sc.sc_dot_sharded`` on that mesh; per-row keys keep
    precedence.

    The in-layer layout (``sharding/tp.py``): with ``cols`` (a
    ``sharding.rules.ColBlock`` of w's columns) the call is
    column-parallel and returns this rank's block of the output; with
    ``rows`` (a block of w's rows) ``x`` holds this rank's block of the
    contraction and the call is row-parallel, returning the whole
    output.  Either way ``w`` (and ``bias``) is the whole leaf or the
    rank's block of that dimension (``sharding.tp.is_block``: the FSDP
    step gathers it so); any other size raises.  ``w_rows``: the K
    block of a block ``w``, relaid already (``sharding.tp.cols_to_rows``:
    the loss relays the unembed's once for all its chunks).  See
    :func:`_dense_cols` and :func:`_dense_contract`.
    """
    if cols is not None:
        return _dense_cols(x, w, cfg, key, bias, site, cols, w_rows)
    if rows is not None:
        return _dense_contract(x, w, cfg, key, bias, site, rows)
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
            xf, wf = x.to(torch.float32), w.to(torch.float32)
            scope = sc.active_mesh()
            if scope is not None:
                mesh, rules = scope
                y = sc.sc_dot_sharded(key, xf, wf, sc_cfg, mesh=mesh,
                                      rules=rules)
            else:
                y = sc.sc_dot(key, xf, wf, sc_cfg)
            y = y.to(x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


class _ScCols(torch.autograd.Function):
    """The SC substrate's column-parallel call on the rank's block ``w``
    ``(K, width)`` of the columns: the forward relays it to its K block
    with every column (``sharding.tp.cols_to_rows``, ``tp.relayout``)
    and runs the whole layout's sharded call on it (``w_local``: the
    same K block, key folds and merge, so the product's bits are the
    whole layout's), keeping the output's block in ``dtype``.  The
    backward is the whole layout's straight-through jacobian, each rank
    computing its part from the same operands: the output's gradient
    gathered whole over ``model`` (``tp.gather``, as the whole weight's
    slice gathers it), the input's gradient the K block ``g·w_Kᵀ`` of
    it, gathered (``tp.gather``), and the weight's the block ``xᵀ·g``
    of the columns, which needs no collective."""

    @staticmethod
    def forward(ctx, x, w, key, sc_cfg, cols, dtype, wk):
        mesh, rules = sc.active_mesh()
        if wk is None:
            wk = tp_lib.cols_to_rows(w, cols).to(torch.float32)
        ctx.save_for_backward(x, wk)
        ctx.cols, ctx.w_dtype = cols, w.dtype
        y = sc.sc_dot_sharded(
            key, x, wk, sc_cfg, mesh=mesh,
            rules=dataclasses.replace(rules, w_local=True))
        return tp_lib._block(y, cols, -1).to(dtype)

    @staticmethod
    def backward(ctx, g):
        x, wk = ctx.saved_tensors
        cols = ctx.cols
        gb = g.to(torch.float32)
        whole = tp_lib._gather_dim(g, cols, -1).to(torch.float32)
        gx = (whole @ wk.T).to(g.dtype)
        kb = col_block(cols.mesh, cols.axes, x.shape[-1])
        gx = tp_lib._gather_dim(gx, kb, -1).to(x.dtype)
        x2 = x.reshape(-1, x.shape[-1])
        gw = (x2.T @ gb.reshape(-1, gb.shape[-1])).to(ctx.w_dtype)
        return gx, gw, None, None, None, None, None


def _sc_cols_ok(key, k: int, cols) -> bool:
    """Whether an SC column-parallel call can run on its weight's block:
    one key inside ``sc.use_mesh`` whose K split resolves to exactly
    ``cols``' axes."""
    scope = sc.active_mesh()
    if key is None or key.dim() != 1 or scope is None:
        return False
    mesh, rules = scope
    return tuple(sc.resolve_rules(mesh, 1, k, rules).contract) == \
        tuple(cols.axes)


def _dense_cols(x, w, cfg, key, bias, site, cols, w_rows=None):
    """Column-parallel: this rank's block of ``x @ w``'s columns.  On
    ``exact`` only the block is computed (``x`` entered: its gradient is
    the ranks' partials summed), on ``w``'s block as it arrives or
    sliced from the whole leaf.  On the SC substrate the product is the
    whole layout's (every one-key call's K split merged over ``model``
    already), so no bit changes: a whole ``w`` runs the whole call and
    the block is a slice of it; a block of ``w`` runs it on its K block
    (:class:`_ScCols`, whose gradients are the whole call's too), which
    needs a one-key call whose K split is ``cols``' (per-row keys are
    never split: such a block raises)."""
    if cfg.sc_backend == "exact":
        y = tp_lib.enter(x, cols) @ tp_lib.local(w, cols, 1).to(x.dtype)
    elif not tp_lib.is_block(w, cols, 1):
        return cols.slice(dense(x, w, cfg, key, bias, site), -1)
    elif key is None:
        raise ValueError(
            f"layers.dense at site {site!r}: sc_backend="
            f"{cfg.sc_backend!r} is stochastic but key=None")
    elif not _sc_cols_ok(key, x.shape[-1], cols):
        raise ValueError(
            f"layers.dense at site {site!r}: a block of the weight's "
            "columns needs a one-key call inside sc.use_mesh whose K "
            f"split is {cols.axes}")
    else:
        y = _ScCols.apply(x.to(torch.float32), w, key, _sc_config(cfg),
                          cols, x.dtype, w_rows)
    if bias is not None:
        y = y + tp_lib.local(bias, cols, 0).to(y.dtype)
    return y


def contract_local_ok(cfg, key, rows) -> bool:
    """Whether a row-parallel call on the block ``rows`` of the
    contraction runs on the block itself: always on ``exact``; on the SC
    substrate a one-key call inside ``sc.use_mesh`` whose K split
    resolves to exactly ``rows``' axes (``sc_dot_sharded`` then cuts the
    same block and folds the same coordinate into the key, so no bit
    changes).  Elsewhere (per-row keys, no mesh scope) the block is
    gathered back whole first."""
    if cfg.sc_backend == "exact":
        return True
    scope = sc.active_mesh()
    if key is None or key.dim() != 1 or scope is None:
        return False
    mesh, rules = scope
    r = sc.resolve_rules(mesh, 1, rows.length, rules)
    return tuple(r.contract) == tuple(rows.axes)


def _dense_contract(x, w, cfg, key, bias, site, rows):
    """Row-parallel: ``x`` holds this rank's block of the contraction.
    On ``exact`` each rank's partial product is summed over ``model`` in
    coordinate order (``tp.row_sum``); on the SC substrate
    ``sc_dot_sharded`` takes the block as its K block
    (``ScShardRules.contract_local``)."""
    if not contract_local_ok(cfg, key, rows):
        if tp_lib.is_block(w, rows, 0):
            raise ValueError(
                f"layers.dense at site {site!r}: a block of the weight's "
                "rows, but the call cannot run on the block of its "
                "contraction")
        return dense(rows.gather(x, -1), w, cfg, key, bias, site)
    ws = tp_lib.local(w, rows, 0)
    if cfg.sc_backend == "exact":
        y = tp_lib.row_sum(x @ ws.to(x.dtype), rows)
    else:
        mesh, rules = sc.active_mesh()
        y = sc.sc_dot_sharded(
            key, x.to(torch.float32), ws.to(torch.float32), _sc_config(cfg),
            mesh=mesh, rules=dataclasses.replace(rules, contract_local=True))
        y = y.to(x.dtype)
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


def mlp(x, p, cfg, key=None, constrain=None):
    """SwiGLU on a (d, 2·d_ff) ``wi``, or (``mlp_variant="gelu"``) the
    tanh-approximated GELU on a (d, d_ff) ``wi`` — ``jax.nn.gelu``'s
    default, as the reference calls it.

    Under a mesh step's in-layer layout (``constrain.tp``) the hidden is
    this rank's ``"mlp"`` block: ``wi`` column-parallel on the f-block
    of ``gate`` and the same f-block of ``up`` (two slices of its
    columns), ``wo`` row-parallel; a ``d_ff`` that does not divide stays
    whole."""
    tp = tp_lib.of(constrain)
    fb = None if tp is None else tp.block(cfg.d_ff)
    wi_cols = None
    if fb is not None:
        wi_cols = (tp.block(2 * cfg.d_ff, parts=2)
                   if cfg.mlp_variant == "swiglu" else fb)
    h = dense(x, p["wi"], cfg, site_key(key, "mlp_wi"), site="mlp_wi",
              cols=wi_cols)
    if cfg.mlp_variant == "swiglu":
        gate, up = torch.chunk(h, 2, dim=-1)
        act = torch.nn.functional.silu(gate.to(torch.float32)).to(x.dtype)
        act = act * up
    else:
        act = torch.nn.functional.gelu(h.to(torch.float32),
                                       approximate="tanh").to(x.dtype)
    return dense(act, p["wo"], cfg, site_key(key, "mlp_wo"), site="mlp_wo",
                 rows=fb)


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


def embed(tokens, p, vocab=None):
    """The table's rows of ``tokens``; with ``vocab`` (a rank's block of
    the vocabulary) the table may be that block: the vocabulary-parallel
    lookup (``sharding.tp.lookup``)."""
    return tp_lib.lookup(p["table"], tokens, vocab)


def unembed(x, p, cfg, key=None, cols=None, w_rows=None):
    table = p["table"]
    if cols is None and table.shape[0] != cfg.vocab:
        raise ValueError(f"an embedding table of {table.shape[0]} rows: "
                         f"the whole vocabulary is {cfg.vocab}")
    return dense(x, table.T, cfg, key, site="unembed", cols=cols,
                 w_rows=w_rows)


# ----------------------------- Expert matmul --------------------------------


def expert_dense(x, w, cfg, key=None, site: str = "moe_wi", *,
                 experts=None):
    """Per-expert batched matmul: (b, e, c, d) @ (e, d, f) -> (b, e, c, f).

    The MoE capacity-buffer contraction.  Under ``exact`` it is one
    einsum.  Stochastic backends loop over the experts, one
    ``sc_dot_rows`` call per expert (one launch of the fused kernel in
    row-key mode, or of the moment kernel's row-key route), and every
    capacity slot draws from its own key folded with ``site``'s salt and
    the expert's GLOBAL index.  A per-row call is never split over a
    mesh (``sc.use_mesh`` shards one-key calls only), so an expert's K
    stays whole on a rank.

    ``key`` is None (``exact`` only: a stochastic backend raises naming
    the site), one raw (2,) key (broadcast to every slot), or a
    (b, e, c, 2) buffer of per-slot keys dispatched alongside ``x``.
    ``experts`` (a ``sharding.rules.ColBlock`` of the expert axis) says
    that ``x`` and ``w`` hold this rank's block of the experts
    (``models/moe.py`` under the expert-parallel layout): expert ``i``
    here is global expert ``experts.start + i``, so its outputs are the
    whole layout's for that expert, bit for bit.
    """
    if w.shape[0] != x.shape[1]:
        raise ValueError(f"layers.expert_dense: {x.shape[1]} experts' "
                         f"buffers but {w.shape[0]} experts' weights")
    if cfg.sc_backend == "exact":
        return torch.einsum("becd,edf->becf", x, w.to(x.dtype))
    if key is None:
        raise ValueError(
            f"layers.expert_dense at site {site!r}: sc_backend="
            f"{cfg.sc_backend!r} is stochastic but key=None — pass a key "
            "so expert matmuls draw on the substrate"
        )
    b, e, c, _ = x.shape
    # one copy of the trainer's host key, not one a row-key call
    key = key.to(x.device)
    if key.dim() == 1:
        key = key.expand(b, e, c, 2)
    first = 0 if experts is None else experts.start
    eidx = torch.arange(first, first + e, device=x.device)
    eidx = eidx[None, :, None].expand(b, e, c)
    keys = site_key(key, site, eidx)  # (b, e, c, 2)
    sc_cfg = _sc_config(cfg)
    # unbind, not x[:, i] / w[i]: the backward stacks the experts'
    # gradients once instead of adding a whole-leaf zero tensor for each
    ys = [_dense_rows(ki, xi, wi, sc_cfg) for ki, xi, wi in
          zip(keys.unbind(1), x.unbind(1), w.unbind(0))]
    return torch.stack(ys, dim=1)
