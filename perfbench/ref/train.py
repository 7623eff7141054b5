"""Plain reference of the training step: the loss of the family's plain
model (``<family>_lm.py``), its gradient by autograd, the global-norm clip
and AdamW with linear warm-up and cosine decay, float32 state.

``run`` follows the program's first steps from the same weights and
batches and returns what the benchmark compares: each step's loss, the
first step's gradient per leaf as the optimizer took it (recovered from
the first moment, ``m_1 / (1 - b1)``), and each leaf's change after the
last step.

:class:`UnembedProbe` records one step's first unembed call, in the
program or in the reference, and :func:`unembed_dx_gap` judges the
gradient that call handed back against ``g @ w.T`` in float32.
"""

from __future__ import annotations

import importlib
import math

import torch

from perfbench.ref import rng


def family(name: str):
    """The reference module of a model family: ``ref/<family>_lm.py``,
    with ``param_shapes``, ``matmul_params`` and ``loss``."""
    return importlib.import_module(f"perfbench.ref.{name}_lm")


def cosine_lr(opt: dict, step: int) -> torch.Tensor:
    t = torch.tensor(float(step), dtype=torch.float32)
    warm = torch.clamp_max(t / max(opt["warmup_steps"], 1), 1.0)
    span = max(opt["total_steps"] - opt["warmup_steps"], 1)
    prog = torch.clamp((t - opt["warmup_steps"]) / span, 0.0, 1.0)
    return opt["lr"] * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def adamw(params: dict, grads: dict, m: dict, v: dict, opt: dict,
          step: int):
    """One AdamW step in place of ``params``, ``m`` and ``v`` (``step``
    counts from 1)."""
    names = sorted(params)
    total = sum(torch.sum(grads[k] * grads[k]) for k in names)
    clip = torch.clamp_max(
        opt["clip_norm"] / torch.clamp_min(torch.sqrt(total), 1e-12), 1.0)
    dev = clip.device
    lr = cosine_lr(opt, step).to(dev)
    t = torch.tensor(float(step), device=dev)
    bc1 = 1.0 - torch.pow(torch.tensor(opt["b1"], device=dev), t)
    bc2 = 1.0 - torch.pow(torch.tensor(opt["b2"], device=dev), t)
    for k in names:
        g = grads[k] * clip
        m[k] = opt["b1"] * m[k] + (1 - opt["b1"]) * g
        v[k] = opt["b2"] * v[k] + (1 - opt["b2"]) * g * g
        delta = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + opt["eps"])
        params[k] = params[k] - lr * (delta + opt["weight_decay"] * params[k])


class UnembedProbe:
    """``probe(x, y)`` on an unembed call ``y = x @ w`` made with a
    gradient: the gradient that reaches ``y`` (``g``) and the one that
    leaves through ``x`` (``dx``), copied to the host as the backward
    passes.  Only the first call it is handed counts."""

    def __init__(self):
        self.taken = False
        self.g = self.dx = None

    def __call__(self, x, y) -> None:
        if self.taken:
            return
        self.taken = True
        y.register_hook(lambda g: setattr(self, "g", _host(g)))
        x.register_hook(lambda d: setattr(self, "dx", _host(d)))


def _host(t):
    return t.detach().to("cpu", torch.float32, copy=True)


def unembed_dx_gap(probe: UnembedProbe, w) -> float:
    """Largest gap between the recorded call's ``dx`` and ``g @ w.T`` in
    float32 (TF32 off) on ``w``'s device, over the largest entry of the
    latter; ``w`` (d_model, vocab) is the reference's own unembedding.
    A call never recorded, or of another shape, reads infinite."""
    if probe.g is None or probe.dx is None:
        return math.inf
    g = probe.g.reshape(-1, probe.g.shape[-1])
    dx = probe.dx.reshape(-1, probe.dx.shape[-1])
    if g.shape != (dx.shape[0], w.shape[1]) or dx.shape[1] != w.shape[0]:
        return math.inf
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = g.to(w.device) @ w.float().T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
    gap = (dx.to(w.device) - want).abs().amax() / want.abs().amax()
    return float(gap)


def run(params: dict, batches: list, c: dict, sub: dict, seed: int,
        opt: dict, probe=None) -> dict:
    """The reference's readings over ``len(batches)`` steps from
    ``params`` (a flat ``{path: tensor}``; not modified); ``probe`` sees
    the first step's unembed call."""
    model = family(c["family"])
    params = {k: v.detach().clone() for k, v in params.items()}
    first = {k: v.clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(t) for k, t in params.items()}
    root = rng.prng_key(seed, params["final_norm"].device)
    losses, grad_norms = [], None
    for i, batch in enumerate(batches):
        key = None if sub["backend"] == "exact" else rng.fold_in(root, i)
        leaves = {k: t.requires_grad_(True) for k, t in params.items()}
        value = model.loss(leaves, batch, c, sub, key,
                           probe=probe if i == 0 else None)
        grads = dict(zip(leaves, torch.autograd.grad(
            value, list(leaves.values()), allow_unused=True)))
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in grads.items()}
        params = {k: t.detach() for k, t in params.items()}
        losses.append(float(value.detach()))
        adamw(params, grads, m, v, opt, i + 1)
        if grad_norms is None:
            grad_norms = {k: float(torch.linalg.vector_norm(m[k]))
                          / (1 - opt["b1"]) for k in m}
    change = {k: float(torch.linalg.vector_norm(params[k] - first[k]))
              for k in params}
    return {"losses": losses, "grad_norms": grad_norms, "change": change}
