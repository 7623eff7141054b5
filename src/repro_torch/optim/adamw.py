"""AdamW with cosine schedule, global-norm clipping, and quantized state.

Port of ``repro.optim.adamw``.  Optimizer-state dtype is configurable
(``f32`` | ``bf16`` | ``int8``); int8 states store a per-tensor absmax
scale beside the payload (``{"q": int8, "scale": f32}``), and the
decode-update-encode runs in float32, so quantization error stays in the
storage and out of the math.

State and parameters are dict trees of tensors, updated leaf by leaf in
sorted-key order.  The update is elementwise, so a leaf larger than
``UPDATE_CHUNK_BYTES`` of float32 is updated in blocks of its leading
dimension (the layer axis of a stacked leaf), as the reference slices
its depth-stacked leaves into chunks: the same bits, with the float32
temporaries of one block live at a time instead of about nine of the
whole leaf (llama4-maverick's stacked expert shard is 4 GB in bf16 and
8 GB in float32 a temporary).  An int8 state's scale needs the whole
leaf's new moments, so its leaves are updated whole.

Under the train step's FSDP ∘ TP layout the leaves are a rank's shards
and ``placements`` says where each lies.  The update runs on the shards
as it is; the two reductions that span a whole leaf span the ranks: the
gradient norm adds each distinct shard's sum of squares once (a leaf
replicated over an axis, its dimension not dividing it, counts on
coordinate 0 of that axis alone; the pods hold the same gradient), and
an int8 state's per-tensor scale takes the absmax over the leaf's
shards (a MAX all-reduce).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.launch.mesh import all_reduce
from repro_torch.models.params import _leaves, tree_leaves, tree_map


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


def _encode(v, kind: str, amax=None):
    """``v`` in the state's dtype; int8 takes its scale from ``amax``
    (the whole leaf's absmax) where given, else from ``v``'s own."""
    if kind == "f32":
        return v.to(torch.float32)
    if kind == "bf16":
        return v.to(torch.bfloat16)
    if kind != "int8":
        raise ValueError(f"unknown state_dtype {kind!r} (f32 | bf16 | int8)")
    amax = v.abs().amax() if amax is None else amax
    scale = torch.clamp_min(amax, 1e-20) / 127.0
    q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.to(torch.float32)}


def _decode(enc, kind: str):
    if kind in ("f32", "bf16"):
        return enc.to(torch.float32)
    return enc["q"].to(torch.float32) * enc["scale"]


# ---------------------------- init / update ---------------------------------

UPDATE_CHUNK_BYTES = 1 << 28  # float32 bytes of a leaf updated at once


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


def _counts_once(pl, ndim: int) -> bool:
    """Whether this rank's shard of a leaf placed by ``pl`` is the one
    copy the norm counts: coordinate 0 on every axis of size > 1 but
    ``pod`` that does not split the leaf."""
    live = pl.live_axes(ndim)
    return all(pl.mesh.coords[a] == 0 for a, n in pl.mesh.shape.items()
               if n > 1 and a != "pod" and a not in live)


def _global_norm(tree, placements=None):
    """The gradient's L2 norm; with ``placements`` the leaves are shards
    and the sum of squares runs over the ranks (see the module doc)."""
    pls = dict(_leaves(placements)) if placements is not None else {}
    total = 0.0
    for path, v in _leaves(tree):
        if path in pls and not _counts_once(pls[path], v.dim()):
            continue
        total = total + torch.sum(torch.square(v.to(torch.float32)))
    if not pls:
        return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
    mesh = next(iter(pls.values())).mesh
    total = torch.as_tensor(total, dtype=torch.float32,
                            device=tree_leaves(tree)[0].device)
    total = total.reshape(1).clone()
    for a, n in mesh.shape.items():
        if n > 1 and a != "pod":
            all_reduce(total, mesh, a)
    return torch.sqrt(total[0])


def adamw_update(grads, state, params, cfg: AdamWConfig, *,
                 placements=None):
    """One AdamW step.  Returns ``(new_params, new_state, metrics)``;
    ``metrics`` holds the pre-clip ``grad_norm`` and the step's ``lr``.
    ``placements`` (``sharding.param_shardings``) marks the leaves as
    the rank's FSDP shards (see the module doc)."""
    step = state["step"] + 1
    gnorm = _global_norm(grads, placements)
    clip = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
    lr = cosine_lr(cfg, step).to(gnorm.device)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
    kind = cfg.state_dtype

    def rows(p, g, m_enc, v_enc):
        """The new parameter, ``m`` and ``v`` (float32) of a block."""
        g = g.to(torch.float32) * clip
        m = cfg.b1 * _decode(m_enc, kind) + (1 - cfg.b1) * g
        v = cfg.b2 * _decode(v_enc, kind) + (1 - cfg.b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        pf = p.to(torch.float32)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * pf
        return (pf - lr * delta).to(p.dtype), m, v

    def upd(p, g, m_enc, v_enc, pl=None):
        pieces = min(-(-4 * p.numel() // UPDATE_CHUNK_BYTES),
                     p.shape[0] if p.dim() else 1)
        if kind != "int8" and pieces > 1:
            new_p, new_m, new_v = (torch.empty_like(t)
                                   for t in (p, m_enc, v_enc))
            n = p.shape[0]
            for i in range(pieces):
                b = slice(n * i // pieces, n * (i + 1) // pieces)
                pb, mb, vb = rows(p[b], g[b], m_enc[b], v_enc[b])
                new_p[b], new_m[b], new_v[b] = (pb, _encode(mb, kind),
                                                _encode(vb, kind))
            return new_p, new_m, new_v
        new_p, m, v = rows(p, g, m_enc, v_enc)
        amax_m = amax_v = None
        if kind == "int8" and pl is not None and pl.live_axes(p.dim()):
            amax = torch.stack([m.abs().amax(), v.abs().amax()])
            for a in pl.live_axes(p.dim()):
                all_reduce(amax, pl.mesh, a, op="max")
            amax_m, amax_v = amax[0], amax[1]
        return new_p, _encode(m, kind, amax_m), _encode(v, kind, amax_v)

    if placements is None:
        out = tree_map(upd, params, grads, state["m"], state["v"])
    else:
        out = tree_map(upd, params, grads, state["m"], state["v"],
                       placements)
    pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
    metrics = {"grad_norm": gnorm, "lr": lr}
    new_state = {"m": pick(1), "v": pick(2), "step": step}
    return pick(0), new_state, metrics
