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
"""

from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.models.params import ParamSpec


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


def _scatter_rows(n_rows: int, slot, rows):
    """A (b, n_rows, ...) zero buffer with ``rows`` (b, sk, ...) set at
    ``slot`` (b, sk).  Duplicate slots occur only at the trash row."""
    b = slot.shape[0]
    buf = rows.new_zeros((b, n_rows) + tuple(rows.shape[2:]))
    bidx = torch.arange(b, device=slot.device)[:, None]
    buf[bidx, slot] = rows
    return buf


def moe_ffn(x, p, cfg, key=None):
    """x: (b, s, d) -> (b, s, d).

    ``key`` is None (exact substrate), one raw (2,) key, or per-token
    (b, s, 2) keys (the paged engine's contract): per-token keys follow
    the same token -> slot dispatch as ``x``, so a token's expert
    matmuls draw from its own key whatever slot it lands in.
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

    # --- dispatch into (b, e, cap, d) capacity buffers ----------------
    xg = torch.gather(x, 1, token[..., None].expand(b, s * k, d))
    buf = _scatter_rows(e * cap + 1, slot, xg)[:, : e * cap]
    buf = buf.reshape(b, e, cap, d)

    ekey = key
    if key is not None and key.dim() == 3:
        # empty slots keep zero keys; their x rows are zero, so their
        # outputs are zero whatever they draw
        kg = torch.gather(
            key.to(torch.int64), 1, token[..., None].expand(b, s * k, 2)
        )
        kbuf = _scatter_rows(e * cap + 1, slot, kg)[:, : e * cap]
        ekey = kbuf.reshape(b, e, cap, 2).to(torch.uint32)

    # --- expert FFN (SwiGLU) on the substrate, per-expert keys --------
    h = layers.expert_dense(buf, p["wi"], cfg, ekey, site="moe_wi")
    gate, up = torch.chunk(h, 2, dim=-1)
    act = torch.nn.functional.silu(gate.to(torch.float32)).to(buf.dtype)
    y = layers.expert_dense(act * up, p["wo"], cfg, ekey, site="moe_wo")

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
        out = out + layers.mlp(x, p["shared"], cfg, key)
    return out


def load_balancing_loss(router_probs, eidx, n_experts: int):
    """Switch-style auxiliary loss: E · Σ_e f_e · P_e."""
    b, s, k = eidx.shape
    counts = torch.bincount(eidx.reshape(-1).long(), minlength=n_experts)
    f = counts.to(torch.float32) / (b * s * k)
    pmean = router_probs.mean(dim=(0, 1))
    return n_experts * torch.sum(f * pmean)
