"""The window loop of a training cell.

Set-up builds the program's kernels (or finds them built), makes the
weights from the seed, builds one train step with its AdamW state and
drives it through the mix's ``checked_steps`` first steps on batches
from the seed, reading each step's loss, the first gradient from the
optimizer's state right after step 1, each leaf's change after the last
step against a copy of the weights it started from, and, in step 1, the
first unembed call's backward (``ref/train.py:UnembedProbe``).  Those
steps also warm up every shape the window uses.  The window then calls
the same step on fresh batches for ``--seconds``; with ``--trace 1`` its
first ``traced_steps`` steps run under the profiler.  Once the window
has closed and the program's state is freed, the plain reference
(``ref/train.py``) follows the same first steps from the same weights
and batches, and the readings are compared.
"""

from __future__ import annotations

import contextlib
import gc
import math
import statistics
import time

import torch

from perfbench import trace as trace_lib
from perfbench import weights
from perfbench.ref import train as ref_train
from perfbench.traffic import gen as traffic

M32 = 0xFFFFFFFF
#: the paper's 10-bit LUT / DTC operand grid, fixed in the program
OPERAND_BITS = 10


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_config(cell):
    from repro_torch.configs import get_config

    mix, dt = cell.mix, getattr(torch, cell.mix["dtype"])
    return get_config(cell.config["arch"]).replace(
        **cell.config["sizes"], sc_backend=mix["sc_backend"],
        sc_nbit=mix["nbit"], param_dtype=dt, act_dtype=dt,
        remat=mix["remat"])


def shapes(cell) -> dict:
    sizes = cell.config["sizes"]
    return ref_train.family(sizes["family"]).param_shapes(sizes)


def make_weights(cell) -> dict:
    return weights.make(shapes(cell), cell.seed, cell.device,
                        getattr(torch, cell.mix["dtype"]))


def batch_source(cell):
    """The mix's batches, in order, from the seed (its own stream)."""
    mix = cell.mix
    gen = torch.Generator(device=cell.device).manual_seed(cell.seed ^ 0x5EED)
    vocab = cell.config["sizes"]["vocab"]
    return lambda: traffic.lm_batch(gen, mix["batch"], mix["seq"], vocab,
                                    mix["zipf_a"])


def _check_shapes(cell, pcfg) -> None:
    from repro_torch.models import lm

    want = {k: tuple(v.shape) for k, v in
            weights.flatten(lm.lm_param_specs(pcfg)).items()}
    have = {k: tuple(s) for k, (s, _) in shapes(cell).items()}
    if want != have:
        raise RuntimeError(f"the reference declares {have}, the program "
                           f"{want}")


def _norms(tree: dict) -> dict:
    return {k: torch.linalg.vector_norm(v.float())
            for k, v in weights.flatten(tree).items()}


def _faulty(step, fault):
    """The train step with ``fault`` planted underneath (for the check
    of the comparison): ``frozen`` returns the state unchanged,
    ``half_batch`` trains on the first half of the rows."""
    if fault is None:
        return step
    if fault == "frozen":
        return lambda state, batch: (state, step(state, batch)[1])
    if fault == "half_batch":
        def half(state, batch):
            rows = next(iter(batch.values())).shape[0] // 2
            return step(state, {k: v[:rows] for k, v in batch.items()})
        return half
    raise ValueError(f"unknown fault {fault!r}")


@contextlib.contextmanager
def probing(cell, probe):
    """``probe`` on the program's unembed calls: those through
    ``repro_torch.sc.sc_dot`` or ``sc_dot_rows`` with a (d_model, vocab)
    weight and a gradient (the probe keeps the first)."""
    from repro_torch import sc

    sizes = cell.config["sizes"]
    shape = (sizes["d_model"], sizes["vocab"])
    saved = sc.sc_dot, sc.sc_dot_rows

    def watch(fn):
        def call(key, x, w, *args, **kwargs):
            y = fn(key, x, w, *args, **kwargs)
            if tuple(w.shape) == shape and y.requires_grad:
                probe(x, y)
            return y
        return call

    sc.sc_dot, sc.sc_dot_rows = watch(saved[0]), watch(saved[1])
    try:
        yield
    finally:
        sc.sc_dot, sc.sc_dot_rows = saved


def judge_unembed(cell, probe) -> float:
    """The recorded unembed call's ``dx`` against ``g @ w.T`` on the
    reference's own weights (``ref/train.py:unembed_dx_gap``)."""
    sizes = cell.config["sizes"]
    w = ref_train.family(sizes["family"]).unembed_weight(make_weights(cell),
                                                         sizes)
    return ref_train.unembed_dx_gap(probe, w)


def run(cell) -> dict:
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import TrainConfig, make_train_step

    dev, mix = cell.device, cell.mix
    parts = {}
    t = time.perf_counter()
    if dev.type == "cuda":
        from repro_torch.kernels import cuda_lib

        cuda_lib.build()
    parts["build_s"] = time.perf_counter() - t

    t = time.perf_counter()
    pcfg = program_config(cell)
    _check_shapes(cell, pcfg)
    first = make_weights(cell)
    params = weights.nest({k: v.clone() for k, v in first.items()})
    sync(dev)
    parts["weights_s"] = time.perf_counter() - t

    t = time.perf_counter()
    ocfg = AdamWConfig(**mix["optimizer"])
    step = _faulty(make_train_step(pcfg, TrainConfig(
        optimizer=ocfg, seed=cell.seed & M32)), cell.fault)
    state = {"params": params, "opt": adamw_init(params, ocfg)}
    del params
    next_batch = batch_source(cell)
    probe = ref_train.UnembedProbe()
    batches, losses, grad_norms = [], [], None
    for i in range(mix["checked_steps"]):
        batches.append(next_batch())
        with probing(cell, probe) if i == 0 else contextlib.nullcontext():
            state, out = step(state, batches[-1])
        losses.append(out["loss"])
        if grad_norms is None:
            grad_norms = {k: float(v) / (1 - ocfg.b1)
                          for k, v in _norms(state["opt"]["m"]).items()}
        sync(dev)
        parts[f"step{len(losses)}_s"] = time.perf_counter() - t
    now = weights.flatten(state["params"])
    change = {k: float(torch.linalg.vector_norm(now[k] - first[k]))
              for k in now}
    del now, first
    program = {"losses": [float(v) for v in losses],
               "grad_norms": grad_norms, "change": change}
    sync(dev)
    parts["warmup_s"] = time.perf_counter() - t

    setup_peak = 0
    if dev.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    tokens = mix["batch"] * mix["seq"]
    steps, window = 0, None
    sync(dev)
    t0 = time.perf_counter()
    if cell.trace:
        def traced():
            nonlocal state
            for _ in range(mix["traced_steps"]):
                state, _ = step(state, next_batch())

        n = mix["traced_steps"]
        window = trace_lib.record(traced, {"steps": n, "tokens": n * tokens})
        steps += n
    while time.perf_counter() - t0 < cell.seconds:
        state, _ = step(state, next_batch())
        steps += 1
    sync(dev)
    t1 = time.perf_counter()
    window_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)

    del state, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    reference = reference_readings(cell, batches)
    program["dx"] = judge_unembed(cell, probe)
    return {
        "window_start": t0,
        "e2e": {"train_tok_s": steps * tokens / (t1 - t0),
                "train_peak_gib": window_peak / 2**30},
        "attempted": steps,
        "failed": 0,
        "memory_peak_bytes": max(setup_peak, window_peak),
        "setup_parts": parts,
        "window": window,
        "checks": compare(program, reference, cell.limits),
    }


def reference_readings(cell, batches, tf32: bool = False,
                       probe=None) -> dict:
    """The plain reference's readings over ``batches``; ``tf32`` runs its
    float32 matmuls in TF32 (the control, ``control.py``), ``probe``
    sees its first step's unembed call."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        mix = cell.mix
        sub = {"backend": mix["sc_backend"], "nbit": mix["nbit"],
               "bits": OPERAND_BITS}
        return ref_train.run(make_weights(cell), batches,
                             cell.config["sizes"], sub, cell.seed & M32,
                             mix["optimizer"], probe=probe)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def _leaf_gap(prog: dict, ref: dict, keep) -> float:
    """Worst leaf's gap of norms, against the larger of the leaf's
    reference norm and the median leaf's."""
    med = statistics.median(ref.values())
    return max(abs(prog[k] - ref[k]) / max(ref[k], med)
               for k in ref if keep(k))


def gaps(program: dict, reference: dict) -> dict:
    """The numbers a training cell compares: the losses' largest
    relative gap, the first gradient's and the change's worst leaf, and
    the program's first unembed backward against float32 (``dx``, set
    by the caller from ``judge_unembed``).  Leaves whose reference
    gradient is under a thousandth of the median leaf's move by
    round-off alone and are left out of the change."""
    lp, lr = program["losses"], reference["losses"]
    g = reference["grad_norms"]
    floor = 1e-3 * statistics.median(g.values())
    out = {"loss": max(abs(a - b) / abs(b) for a, b in zip(lp, lr)),
           "grad": _leaf_gap(program["grad_norms"], g, lambda k: True),
           "change": _leaf_gap(program["change"], reference["change"],
                               lambda k: g[k] >= floor),
           "dx": program.get("dx", math.inf)}
    return {k: v if math.isfinite(v) else math.inf for k, v in out.items()}


def compare(program: dict, reference: dict, limits: dict) -> list:
    """``[(name, value, limit)]`` of the numbers the cell's limits name."""
    return [(k, v, limits[k]) for k, v in gaps(program, reference).items()
            if k in limits]
