"""Mixture-of-Experts FFN with capacity-bounded sort dispatch.

Port of ``repro.models.moe``.  Routing, sort and capacity bookkeeping
happen per batch row; dispatch gathers tokens into (b, e, cap, d)
capacity buffers (the one-hot dispatch tensor is never built); top-k
gates are renormalized, and tokens beyond an expert's capacity drop.

Three places where PyTorch differs from the reference's primitives, and
what is done about each:

* **Top-k ties.**  ``jax.lax.top_k`` breaks ties by the lower index;
  ``torch.topk`` promises no order.  Router logits under the bit-exact
  substrates are discrete (pop-count totals times a scale), so exact
  ties are real: the experts are the first k of a *stable* descending
  sort.
* **Keys.**  Per-token keys ride the token -> slot dispatch; ``uint32``
  tensors take no advanced indexing on CUDA, so they are gathered and
  scattered as int64.
* **Combine.**  The reference's ``out.at[token].add(ytk)`` sums a
  token's k contributions in the activation dtype in update order (the
  expert-sorted order).  Here each token's contributions are gathered in
  that order and added one by one, which is deterministic; CUDA's
  ``index_add_`` is not (its atomics reorder bf16 sums from run to run).
* **Dispatch's gradient.**  A token sits in up to k capacity slots, so
  the dispatch's backward sums up to k slot gradients a token.
  ``torch.gather``'s own backward (``scatter_add_``) sums them with
  CUDA atomics, in an order that changes from run to run, and a
  training step's gradient with it.  Here the backward gathers each
  token's slots and adds them one by one in slot order
  (:class:`_TakeRows`), the order the CPU's serial scatter adds them in.

Under a mesh's in-layer layout (``constrain.tp``) the experts are laid
out over ``model`` (expert parallelism, ``sharding/ep.py``): the routing
and the capacity run on the whole rows as before, each rank fills and
runs only its block of the experts, and their outputs are all-gathered
in coordinate order before the same combine, so the output is the whole
layout's bit for bit on the SC substrates.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.models.params import ParamSpec
from repro_torch.sharding import ep as ep_lib


def moe_specs(cfg):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    sp = {
        "router": ParamSpec((d, e), ("embed", None), "scaled"),
        "wi": ParamSpec(
            (e, d, 2 * f), ("experts", "embed", "expert_mlp"), "scaled"
        ),
        "wo": ParamSpec((e, f, d), ("experts", "expert_mlp", "embed"),
                        "scaled"),
    }
    if cfg.shared_expert:
        sp["shared"] = layers.mlp_specs(cfg)
    return sp


def capacity(cfg, tokens_per_row: int) -> int:
    c = int(
        tokens_per_row * cfg.top_k * cfg.capacity_factor
        / max(cfg.n_experts, 1)
    )
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def _top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _slot_sources(n_rows: int, slot, token):
    """The source token of each of ``n_rows`` capacity slots, from the
    sorted entries' ``slot`` and ``token`` (b, sk): (b, n_rows) int64,
    -1 where no entry lands.  Duplicate slots occur only at the trash
    row, which the caller drops."""
    b = slot.shape[0]
    src = torch.full((b, n_rows + 1), -1, dtype=torch.int64,
                     device=slot.device)
    src.scatter_(1, slot, token)
    return src[:, :n_rows]


class _TakeRows(torch.autograd.Function):
    """``t`` (b, s, ...) gathered at the slots' sources ``src`` (b, n),
    zero where a slot is empty; a source token fills at most ``most``
    slots, and the backward sums a token's slot gradients in slot order
    by gathers."""

    @staticmethod
    def forward(ctx, t, src, most):
        b, n = src.shape
        tail = tuple(t.shape[2:])
        idx = src.clamp_min(0).reshape(b, n, *([1] * len(tail)))
        rows = torch.gather(t, 1, idx.expand(b, n, *tail))
        full = (src >= 0).reshape(b, n, *([1] * len(tail)))
        ctx.save_for_backward(src)
        ctx.s, ctx.most = t.shape[1], most
        return torch.where(full, rows, torch.zeros((), dtype=t.dtype,
                                                   device=t.device))

    @staticmethod
    def backward(ctx, g):
        (src,) = ctx.saved_tensors
        b, n = src.shape
        tail = tuple(g.shape[2:])
        ones = [1] * len(tail)
        # a token's slots side by side, in slot order (empty slots first)
        order = torch.argsort(src, dim=1, stable=True)
        ssrc = torch.gather(src, 1, order).contiguous()
        tok = torch.arange(ctx.s, device=src.device).expand(b, ctx.s)
        first = torch.searchsorted(ssrc, tok.contiguous())
        count = torch.searchsorted(ssrc, tok.contiguous(), right=True) - first
        out = g.new_zeros((b, ctx.s, *tail))
        for j in range(ctx.most):
            at = torch.gather(order, 1, (first + j).clamp_max(n - 1))
            rows = torch.gather(g, 1, at.reshape(b, ctx.s, *ones)
                                .expand(b, ctx.s, *tail))
            has = (count > j).reshape(b, ctx.s, *ones)
            out = out + torch.where(has, rows, torch.zeros(
                (), dtype=g.dtype, device=g.device))
        return out, None, None


_take_rows = _TakeRows.apply


def moe_ffn(x, p, cfg, key=None, constrain=None):
    """x: (b, s, d) -> (b, s, d).

    ``key`` is None (exact substrate), one raw (2,) key, or per-token
    (b, s, 2) keys (the paged engine's contract): per-token keys follow
    the same token -> slot dispatch as ``x``, so a token's expert
    matmuls draw from its own key whatever slot it lands in.

    ``constrain`` (a mesh step's, prefill's or decode's constraint, as
    the reference takes it): under its in-layer layout each rank fills
    and runs only its block of the experts (``sharding/ep.py``), taking
    ``p["wi"]`` / ``p["wo"]`` whole (sliced here) or as that block (the
    FSDP layout's gather); the shared expert's MLP takes the MLP's
    in-layer layout.
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, s)
    dev = x.device

    router_logits = layers.dense(
        x.to(torch.float32),
        p["router"].to(torch.float32),
        cfg,
        layers.site_key(key, "moe_router"),
        site="moe_router",
    )  # (b, s, e)
    probs = torch.softmax(router_logits, dim=-1)
    gates, eidx = _top_k(probs, k)  # (b, s, k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    # --- per-row capacity assignment via a stable sort ---------------
    flat_e = eidx.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    experts = torch.arange(e, device=dev).expand(b, e).contiguous()
    first = torch.searchsorted(sorted_e.contiguous(), experts)  # (b, e)
    rank = torch.arange(s * k, device=dev)[None] - torch.gather(
        first, 1, sorted_e
    )
    slot = torch.where(rank < cap, sorted_e * cap + rank, e * cap)
    token = order // k  # source token of each sorted entry

    # --- dispatch into (b, e, cap, d) capacity buffers: under the
    # expert-parallel layout only this rank's experts' (b, e/m, cap, d) --
    blk = ep_lib.expert_block(constrain, cfg)
    xin, n, lslot = x, e, slot
    if blk is not None:
        xin, n = ep_lib.enter(x, blk), blk.size
        lo = blk.start * cap
        mine = (slot >= lo) & (slot < lo + n * cap)
        lslot = torch.where(mine, slot - lo, n * cap)
    src = _slot_sources(n * cap, lslot, token)  # (b, n·cap)
    buf = _take_rows(xin, src, k).reshape(b, n, cap, d)

    ekey = key
    if key is not None and key.dim() == 3:
        # empty slots keep zero keys; their x rows are zero, so their
        # outputs are zero whatever they draw
        kbuf = _take_rows(key.to(torch.int64), src, k)
        ekey = kbuf.reshape(b, n, cap, 2).to(torch.uint32)

    # --- expert FFN (SwiGLU) on the substrate, per-expert keys --------
    wi = ep_lib.local_experts(p["wi"], blk, e)
    wo = ep_lib.local_experts(p["wo"], blk, e)
    h = layers.expert_dense(buf, wi, cfg, ekey, site="moe_wi", experts=blk)
    gate, up = torch.chunk(h, 2, dim=-1)
    act = torch.nn.functional.silu(gate.to(torch.float32)).to(buf.dtype)
    y = layers.expert_dense(act * up, wo, cfg, ekey, site="moe_wo",
                            experts=blk)
    if blk is not None:
        y = ep_lib.GatherOutputs.apply(y, blk)  # every expert, in order

    # --- combine: gather per (token, k), weight, add in sorted order --
    yflat = torch.cat([y.reshape(b, e * cap, d), y.new_zeros(b, 1, d)], 1)
    ytk = torch.gather(yflat, 1, slot[..., None].expand(b, s * k, d))
    gate_sorted = torch.gather(gates.reshape(b, s * k), 1, order)
    ytk = ytk * gate_sorted[..., None].to(ytk.dtype)
    # token t's k entries of the sorted list, in ascending list order
    by_token = torch.argsort(token, dim=-1, stable=True).reshape(b, s, k)
    out = torch.zeros((b, s, d), dtype=x.dtype, device=dev)
    for j in range(k):
        idx = by_token[:, :, j, None].expand(b, s, d)
        out = out + torch.gather(ytk, 1, idx)

    if cfg.shared_expert:
        out = out + layers.mlp(x, p["shared"], cfg, key,
                               constrain=constrain)
    return out


def load_balancing_loss(router_probs, eidx, n_experts: int):
    """Switch-style auxiliary loss: E · Σ_e f_e · P_e."""
    b, s, k = eidx.shape
    # a scatter-add count (``bincount`` has no meta kernel: the dry-run
    # traces this on ``meta``)
    idx = eidx.reshape(-1).long()
    counts = torch.zeros(n_experts, dtype=torch.int64, device=idx.device)
    counts = counts.scatter_add(0, idx, torch.ones_like(idx))
    f = counts.to(torch.float32) / (b * s * k)
    pmean = router_probs.mean(dim=(0, 1))
    return n_experts * torch.sum(f * pmean)
