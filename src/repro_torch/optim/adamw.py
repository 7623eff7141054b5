"""AdamW with cosine schedule, global-norm clipping, and quantized state.

Port of ``repro.optim.adamw``.  Optimizer-state dtype is configurable
(``f32`` | ``bf16`` | ``int8``); int8 states store a per-tensor absmax
scale beside the payload (``{"q": int8, "scale": f32}``), and the
decode-update-encode runs in float32, so quantization error stays in the
storage and out of the math.

State and parameters are dict trees of tensors, updated leaf by leaf in
sorted-key order.  The reference slices its depth-stacked leaves into
chunks only to bound XLA's staging buffers; the update is elementwise,
so eager PyTorch, which stages one leaf at a time, needs no chunks.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.params import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    state_dtype: str = "f32"  # f32 | bf16 | int8


def cosine_lr(cfg: AdamWConfig, step):
    """Linear warmup then cosine decay, in float32 (``step`` an int or a
    tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    span = max(cfg.total_steps - cfg.warmup_steps, 1)
    progress = torch.clamp((step - cfg.warmup_steps) / span, 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * progress))


# ---------------------------- state (de)quantization ------------------------


def _encode(v, kind: str):
    if kind == "f32":
        return v.to(torch.float32)
    if kind == "bf16":
        return v.to(torch.bfloat16)
    if kind != "int8":
        raise ValueError(f"unknown state_dtype {kind!r} (f32 | bf16 | int8)")
    scale = torch.clamp_min(v.abs().amax(), 1e-20) / 127.0
    q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.to(torch.float32)}


def _decode(enc, kind: str):
    if kind in ("f32", "bf16"):
        return enc.to(torch.float32)
    return enc["q"].to(torch.float32) * enc["scale"]


# ---------------------------- init / update ---------------------------------


def adamw_init(params, cfg: AdamWConfig):
    def zeros(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return _encode(z, cfg.state_dtype)

    dev = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _global_norm(tree):
    total = 0.0
    for v in tree_leaves(tree):
        total = total + torch.sum(torch.square(v.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def adamw_update(grads, state, params, cfg: AdamWConfig):
    """One AdamW step.  Returns ``(new_params, new_state, metrics)``;
    ``metrics`` holds the pre-clip ``grad_norm`` and the step's ``lr``."""
    step = state["step"] + 1
    gnorm = _global_norm(grads)
    clip = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
    lr = cosine_lr(cfg, step).to(gnorm.device)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
    kind = cfg.state_dtype

    def upd(p, g, m_enc, v_enc):
        g = g.to(torch.float32) * clip
        m = cfg.b1 * _decode(m_enc, kind) + (1 - cfg.b1) * g
        v = cfg.b2 * _decode(v_enc, kind) + (1 - cfg.b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        pf = p.to(torch.float32)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * pf
        new_p = (pf - lr * delta).to(p.dtype)
        return new_p, _encode(m, kind), _encode(v, kind)

    out = tree_map(upd, params, grads, state["m"], state["v"])
    pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
    metrics = {"grad_norm": gnorm, "lr": lr}
    new_state = {"m": pick(1), "v": pick(2), "step": step}
    return pick(0), new_state, metrics
