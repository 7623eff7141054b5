"""The train step: straight-through gradients of ``lm.lm_loss``,
microbatched accumulation, and the AdamW update.

Port of ``repro.train.step`` on one device.  ``make_train_step`` returns
a ``step(state, batch) -> (state, metrics)`` function; PyTorch runs it
eagerly, so there is no ``jit`` around it.  Sharding (``mesh``,
``make_constrain``, ``make_param_constrain``) and the cross-pod int8
gradient compression are the scale-out slice (ROADMAP queue 1 item 10)
and raise here.  Every family trains: the attention stacks, MoE, the
SSM and hybrid families (autograd through ``ssd_chunked``, the causal
conv and zamba2's shared block), and the audio family on frame
embeddings (``data.make_embedding_batch``).

RNG: the step's root key is ``fold_in(PRNGKey(seed), opt.step)`` (none
under the ``exact`` backend), microbatch ``i`` folds ``i`` into it, and
the model folds layers, chunks and sites below that — the reference's
key chain, so both packages draw the same noise for the same step.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.models import lm
from repro_torch.models import params as params_lib
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.sc import ctr_rng

_SCALE_OUT = "ROADMAP queue 1 item 10 (scale-out)"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    cross_pod_compress: bool = False
    seed: int = 0


def train_state_init(key, cfg, tcfg: TrainConfig, *, device=None):
    """The full train state ``{"params", "opt"}`` on ``device`` (the card
    unless the caller asks for the CPU).  ``key`` is an int seed or a
    ``torch.Generator``; weights are drawn on the generator's device, so
    one seed gives the same weights on every target."""
    if tcfg.cross_pod_compress:
        raise NotImplementedError(f"cross_pod_compress: {_SCALE_OUT}")
    device = resolve_device(device)
    gen = key
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(key))
    specs = lm.lm_param_specs(cfg)
    params = params_lib.init_params(specs, gen, device, cfg.param_dtype)
    return {"params": params, "opt": adamw_init(params, tcfg.optimizer)}


def _value_and_grad(loss_fn, params, *args):
    """(loss, grads) of ``loss_fn(params, *args)`` w.r.t. every leaf."""
    tracked = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = loss_fn(tracked, *args)
    loss.backward()
    grads = tree_map(
        lambda t: torch.zeros_like(t) if t.grad is None else t.grad, tracked
    )
    return loss.detach(), grads


def _to_device(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(cfg, tcfg: TrainConfig, mesh=None):
    """Returns ``step(state, batch) -> (state, metrics)``."""
    if mesh is not None:
        raise NotImplementedError(f"a device mesh: {_SCALE_OUT}")
    if tcfg.cross_pod_compress:
        raise NotImplementedError(f"cross_pod_compress: {_SCALE_OUT}")

    def loss_fn(params, batch, rng):
        return lm.lm_loss(params, batch, cfg, rng=rng)

    def grads_of(params, batch, rng):
        n = tcfg.microbatches
        if n <= 1:
            return _value_and_grad(loss_fn, params, batch, rng)
        micro = {
            k: v.reshape((n, v.shape[0] // n) + v.shape[1:])
            for k, v in batch.items()
        }
        loss = 0.0
        g_acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                          params)
        for i in range(n):
            mb = {k: v[i] for k, v in micro.items()}
            key = None if rng is None else ctr_rng.fold_in(rng, i)
            li, gi = _value_and_grad(loss_fn, params, mb, key)
            g_acc = tree_map(lambda a, b: a + b.to(torch.float32), g_acc, gi)
            loss = loss + li
        return loss / n, tree_map(lambda g: g / n, g_acc)

    def step(state, batch):
        params = state["params"]
        device = tree_leaves(params)[0].device
        batch = _to_device(batch, device)
        # the SC substrate is the only rng consumer in the loss
        rng = None
        if cfg.sc_backend != "exact":
            root = ctr_rng.prng_key(tcfg.seed)
            rng = ctr_rng.fold_in(root, int(state["opt"]["step"]))
        loss, grads = grads_of(params, batch, rng)
        grads = tree_map(lambda g, p: g.to(p.dtype), grads, params)
        new_params, new_opt, metrics = adamw_update(
            grads, state["opt"], params, tcfg.optimizer
        )
        metrics["loss"] = loss
        return {"params": new_params, "opt": new_opt}, metrics

    return step


def make_eval_step(cfg, mesh=None):
    if mesh is not None:
        raise NotImplementedError(f"a device mesh: {_SCALE_OUT}")

    def eval_step(params, batch):
        device = tree_leaves(params)[0].device
        with torch.no_grad():
            return lm.lm_loss(params, _to_device(batch, device), cfg)

    return eval_step
