"""Cross-pod int8 gradient compression with error feedback.

Port of ``repro.distributed.compression``.  The ``pod`` mesh axis is
pure data parallelism over the slow links between pods, so the gradient
crosses it int8-compressed (per-tensor absmax scale), with **error
feedback**: the quantization residual is carried to the next step, so
the compressed trajectory converges to the uncompressed one
(Karimireddy et al., 2019).  Within a pod the caller's gradient function
has already reduced over ``data`` (the train step's all-reduce).

Every rank of pod p quantizes ``g + ef[p]`` alike; the pods' int8
payloads and scales cross the pod group as exact copies (an integer SUM
over zero-padded slots, ``sc/sharded.py``'s gather), each rank
dequantizes every pod's payload and adds them in pod order, as XLA's
``psum`` adds on the reference's CPU devices, then divides by the pod
count: so every rank holds the reference's bits.  The residual keeps the
reference's layout, ``(n_pods, ...)`` per leaf on every rank (the pods'
new rows are exchanged after each step), so a checkpoint written by any
one rank holds them all.

The per-tensor scale is the whole leaf's: each leaf's absmax is
MAX-reduced over the pod's ranks first.  Where every rank holds the
whole gradient that changes no bit; under the train step's FSDP ∘ TP
layout each rank compresses its shard of the data-reduced gradient (its
residual ``(n_pods, *shard)``; the pod group of a rank holds the same
shard in every pod, so the exchange is unchanged), and every element
quantizes as in the replicated step.
"""

from __future__ import annotations

import torch

from repro_torch.launch.mesh import all_reduce, collective_span
from repro_torch.models.params import _leaves, _set
from repro_torch.sc.sharded import _gather, sum_in_order


def _quantize(g, amax):
    """int8 payload and per-tensor scale (``amax``, the whole leaf's
    absmax, / 127); rounding halves to even, as ``jnp.round`` does."""
    scale = torch.clamp_min(amax, 1e-20) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def init_error_feedback(grads_like, n_pods: int):
    """Residual buffers: ``(n_pods, *leaf.shape)`` float32 zeros per
    leaf of ``grads_like`` (parameters or gradients), on its device."""
    out: dict = {}
    for path, g in _leaves(grads_like):
        _set(out, path, torch.zeros((n_pods, *g.shape), dtype=torch.float32,
                                    device=g.device))
    return out


def _pod_gather(t, mesh):
    """Every pod's ``t`` stacked in pod order: ``(n_pods, *t.shape)``,
    bits copied exactly."""
    return _gather(t, mesh, ("pod",))


def _leaf_absmax(gs, mesh):
    """Each leaf's absmax over the pod's ranks: one MAX all-reduce of the
    ranks' absmaxes over every other axis of size > 1 (a rank holding a
    replica changes no maximum)."""
    amax = torch.stack([g.abs().max() for g in gs])
    for a, n in mesh.shape.items():
        if n > 1 and a != "pod":
            all_reduce(amax, mesh, a, op="max")
    return amax


def compressed_grads(grad_fn, mesh):
    """Wrap ``grad_fn(params, batch) -> (loss, grads)`` (this pod's
    rows, reduced over the pod's other ranks) so the gradient crosses
    the pod axis int8-compressed with error feedback.

    Returns ``fn(params, batch, ef) -> (loss, grads, new_ef)``, ``ef``
    from :func:`init_error_feedback`.  Without a ``pod`` axis the wrapper
    is a pass-through (``ef`` is returned as given)."""
    if "pod" not in mesh.axis_names:
        def passthrough(params, batch, ef):
            loss, grads = grad_fn(params, batch)
            return loss, grads, ef
        return passthrough

    n_pods = mesh.shape["pod"]

    def wrapped(params, batch, ef):
        if ef is None:
            raise ValueError(
                "compressed_grads: the error-feedback residual is None; "
                "fill state['ef'] with init_error_feedback(params, n_pods)")
        pod = mesh.coords["pod"]
        loss, grads = grad_fn(params, batch)
        items = list(_leaves(grads))
        efs = dict(_leaves(ef))
        gs = [g.to(torch.float32) + efs[path][pod] for path, g in items]
        qs, scales = [], []
        for g, a in zip(gs, _leaf_absmax(gs, mesh)):
            q, scale = _quantize(g, a)
            qs.append(q)
            scales.append(scale)
        scales = torch.stack(scales)
        # the residual g - q·s rounded once, as the reference's fused
        # multiply-subtract gives it (exact in float64: q has 8 bits)
        resid = torch.cat([
            (g.double() - q.double() * s.double()).float().reshape(-1)
            for g, q, s in zip(gs, qs, scales)])
        del gs
        payload = torch.cat([q.reshape(-1) for q in qs])
        with collective_span(
                "train.pod_exchange", payload,
                bytes=payload.numel() + 4 * (scales.numel() + 1)):
            payload = _pod_gather(payload, mesh)
            scales = _pod_gather(scales, mesh)
            losses = _pod_gather(loss.to(torch.float32).reshape(1), mesh)
        with collective_span(
                "train.ef_exchange", resid, bytes=4 * resid.numel()):
            resid = _pod_gather(resid, mesh)
        grads_c: dict = {}
        new_ef: dict = {}
        off = 0
        for i, (path, g) in enumerate(items):
            n = g.numel()
            parts = [payload[p, off:off + n].to(torch.float32) * scales[p, i]
                     for p in range(n_pods)]
            _set(grads_c, path, (sum_in_order(parts) / n_pods).view(g.shape))
            _set(new_ef, path,
                 resid[:, off:off + n].reshape(n_pods, *g.shape).clone())
            off += n
        loss = sum_in_order(list(losses[:, 0])) / n_pods
        return loss, grads_c, new_ef

    return wrapped

