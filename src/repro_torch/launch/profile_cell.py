"""Per-cell profile: where one rank's bytes / FLOPs / collectives live,
and the same cell cut to one card, measured against its account.

Port of ``repro.launch.profile_cell``.  :func:`profile` traces one
(arch x shape) cell for rank 0 of the production mesh on ``meta``
(``launch/dryrun.py``) and prints its roofline, the bytes by aten op and
the collectives by (kind, operand bytes).  :func:`sc_trace` prices the
cell's ``dense()`` workload on the SOT-MRAM array simulator.

The port's entry points run on the card, so :func:`measure` also runs a
cell's step there, cut in depth and batch to fit one H100, under
``torch.profiler``: device ms by kernel class (GEMM, attention,
elementwise, other), ``max_memory_allocated`` and the matmul FLOPs
``FlopCounterMode`` counts on the card, beside the cost account's terms,
FLOPs and predicted peak for the same cut cell on one rank.

    PYTHONPATH=src python -m repro_torch.launch.profile_cell \\
        --arch llama4-maverick-400b-a17b --shape train_4k [--multipod]
    PYTHONPATH=src python -m repro_torch.launch.profile_cell \\
        --arch qwen2-0.5b --shape decode_32k --measure --layers 2 \\
        --batch 128 --seq 32768            # on the card

``--sc-trace`` also prices the cell on the array simulator; ``--device
cpu`` runs ``--measure`` on the CPU (the tests' size only).
"""

from __future__ import annotations

import argparse
import contextlib
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import resolve_device
from repro_torch.configs import SHAPES, ShapeConfig, get_config
from repro_torch.launch import cost_analysis
from repro_torch.launch.dryrun import lower_cell, trace_cell, train_config
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.models import params as params_lib
from repro_torch.optim import adamw_init
from repro_torch.train import make_train_step


def profile(arch: str, shape: str, multi_pod: bool = False, top: int = 18):
    mesh = make_production_mesh(multi_pod=multi_pod)
    result, hc = lower_cell(arch, shape, mesh, compile_=True,
                            return_cost=True)
    rf = result["roofline"]
    print(f"\n== {arch} x {shape} x {result['mesh']} (one rank) ==")
    print(f"bound={rf['bound']}  compute_s={rf['compute_s']:.3f}  "
          f"memory_s={rf['memory_s']:.3f}  "
          f"collective_s={rf['collective_s']:.3f}  "
          f"useful={rf['useful_fraction']:.3f}")
    mem = result["memory"]
    print(f"mem/dev={mem['total_per_device_gb']}GB  (reference layout "
          f"{mem['reference_layout_gb']}GB)  ops={hc.ops}")

    total_b = sum(hc.bytes_by_op.values()) or 1
    print(f"\n-- bytes by aten op (per rank, total "
          f"{total_b / 1e12:.2f} TB) --")
    for op, b in sorted(hc.bytes_by_op.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {op:<32s} {b / 1e12:9.3f} TB  {b / total_b * 100:5.1f}%")

    total_c = sum(hc.coll_by_shape.values()) or 1
    print(f"\n-- collectives by (kind, operand bytes) (per rank, total "
          f"{total_c / 1e9:.2f} GB) --")
    for sk, b in sorted(hc.coll_by_shape.items(), key=lambda kv: -kv[1])[:top]:
        kind, sz = sk.rsplit(":", 1)
        print(f"  {kind:<20s} op={int(sz) / 1e6:10.1f} MB   total "
              f"{b / 1e9:9.2f} GB  {b / total_c * 100:5.1f}%")
    return result, hc


def sc_trace(arch: str, shape: str, nbit: int = 1024, top: int = 12):
    """Price the cell's dense() workload on the SOT-MRAM array simulator
    (``repro_torch.arch``): static, per matmul site, with explicit layer
    multiplicity, so production shapes price in milliseconds."""
    from repro_torch import arch as arch_sim

    cfg = get_config(arch)
    sh = SHAPES[shape]
    tokens = sh.global_batch * (1 if sh.kind == "decode" else sh.seq_len)
    sites = arch_sim.dense_workload(cfg, tokens)
    per_site, total = arch_sim.price_workload(sites, nbit)
    print(f"\n-- SOT-MRAM array trace: {arch} x {shape} "
          f"({tokens} tokens, nbit={nbit}, spec={arch_sim.DEFAULT_SPEC}) --")
    per_site.sort(key=lambda sr: -sr[1].cycles)
    for s, r in per_site[:top]:
        print(f"  {s.label:<14s} {s.m}x{s.k}x{s.n} x{s.count:<3d} "
              f"{r.cycles:>14,d} cyc  {r.energy_pj / 1e6:10.2f} µJ  "
              f"util={r.subarray_util:.2f}")
    print(f"  {'TOTAL':<14s} {total.products:,} MULs  "
          f"{total.cycles:>14,d} cyc  {total.energy_pj / 1e6:10.2f} µJ  "
          f"util={total.subarray_util:.2f}")
    return total


# ---------------------------------------------------------------------------
# One cell, cut to one card, measured against its account
# ---------------------------------------------------------------------------


def kernel_class(name: str) -> str:
    """A device kernel's class by its name: GEMM (cuBLAS / CUTLASS),
    attention (softmax, fused attention), elementwise, or other."""
    low = name.lower()
    if any(k in low for k in ("gemm", "cutlass", "xmma", "nvjet",
                              "matmul")):
        return "gemm"
    if any(k in low for k in ("softmax", "attention", "fmha", "flash")):
        return "attention"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def _real_step(cfg, shape, tcfg, device, seed: int):
    """``(fn, args)``: the cell's step on tensors on ``device``, random
    weights and inputs from ``seed`` (what ``dryrun.cell_step`` traces on
    ``meta`` for one rank)."""
    gen = torch.Generator().manual_seed(seed)
    params = params_lib.init_params(lm.lm_param_specs(cfg), gen, device,
                                    cfg.param_dtype)
    b, s = shape.global_batch, shape.seq_len

    def tokens(*size):
        return torch.randint(0, cfg.vocab, size, generator=gen,
                             dtype=torch.int32).to(device)

    if cfg.frontend == "embeddings" and shape.kind != "decode":
        inputs = torch.randn((b, s, cfg.d_model), generator=gen).to(
            device=device, dtype=cfg.act_dtype)
    else:
        inputs = tokens(b, s)
    if shape.kind == "train":
        state = {"params": params, "opt": adamw_init(params, tcfg.optimizer)}
        return make_train_step(cfg, tcfg), (
            state, {"inputs": inputs, "labels": tokens(b, s)})
    if shape.kind == "prefill":
        return (lambda p, x: lm.prefill(p, x, cfg, s)), (params, inputs)
    cache = lm.init_cache(cfg, b, s, device=device)
    lengths = torch.full((b,), s - 1, dtype=torch.int32, device=device)
    return (lambda p, c, t, n: lm.decode_step(p, c, t, n, cfg)), (
        params, cache, tokens(b), lengths)


@contextlib.contextmanager
def _tf32_off():
    """The port's matmul precision: TF32 off (float32 on the CUDA
    cores), as the account's rates assume."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def measure(arch: str, shape: str, *, layers: int, batch: int, seq: int,
            device=None) -> dict:
    """Run ``arch`` x ``shape`` cut to ``layers`` deep and a batch of
    ``batch`` x ``seq`` on ``device`` (the card unless the caller asks
    for the CPU): one untimed run under ``FlopCounterMode``, then one
    under ``torch.profiler``.  Returns the card's numbers beside the cost
    account of the same cut cell on one rank (``predicted``).  Weights
    and inputs are random, from seed 0."""
    device = resolve_device(device)
    cfg = get_config(arch).replace(n_layers=layers)
    cell = ShapeConfig(f"{shape}_cut", seq, batch, SHAPES[shape].kind)
    tcfg = train_config(arch)
    cost, _, _ = trace_cell(cfg, cell, AbstractMesh((1, 1), ("data", "model")),
                            tcfg)
    rf = cost_analysis.roofline_from_cost(
        cost, 1, model_flops=cost_analysis.model_flops_estimate(cfg, cell))
    predicted = dict(flops=cost.flops, flops_by_dtype=cost.flops_by_dtype,
                     bytes=cost.bytes, peak_bytes=cost.peak_bytes,
                     compute_ms=rf.compute_s * 1e3,
                     memory_ms=rf.memory_s * 1e3, bound=rf.bound)
    fn, args = _real_step(cfg, cell, tcfg, device, 0)
    cuda = device.type == "cuda"
    from torch.profiler import ProfilerActivity, profile as tprofile

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    with _tf32_off():
        with FlopCounterMode(display=False) as fc:
            fn(*args)
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        with tprofile(activities=activities) as prof:
            fn(*args)
            if cuda:
                torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_class = {"gemm": 0.0, "attention": 0.0, "elementwise": 0.0,
                "other": 0.0}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and not ev.is_user_annotation:
            by_class[kernel_class(ev.name)] += ev.time_range.elapsed_us() / 1e3
    device_ms = sum(by_class.values())
    return dict(
        arch=arch, shape=shape, layers=layers, batch=batch, seq=seq,
        device=str(device),
        card=torch.cuda.get_device_name(device) if cuda else None,
        flops=float(fc.get_total_flops()),
        device_ms=device_ms if cuda and device_ms else None,
        by_class_ms=by_class if cuda else None,
        profiled_wall_ms=wall_ms,
        max_memory_allocated=(torch.cuda.max_memory_allocated(device)
                              if cuda else None),
        predicted=predicted,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--top", type=int, default=18)
    ap.add_argument("--sc-trace", action="store_true",
                    help="also price the dense() workload on the SOT-MRAM "
                         "array simulator (repro_torch.arch)")
    ap.add_argument("--sc-nbit", type=int, default=1024)
    ap.add_argument("--measure", action="store_true",
                    help="run the cell cut to --layers / --batch / --seq "
                         "on the card against its account")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cpu: run --measure on the CPU (tests only)")
    args = ap.parse_args(argv)
    if args.measure:
        sh = SHAPES[args.shape]
        out = measure(args.arch, args.shape, layers=args.layers,
                      batch=args.batch or sh.global_batch,
                      seq=args.seq or sh.seq_len, device=args.device)
        for k, v in out.items():
            print(f"{k}: {v}")
        return
    profile(args.arch, args.shape, args.multipod, args.top)
    if args.sc_trace:
        sc_trace(args.arch, args.shape, args.sc_nbit, args.top)


if __name__ == "__main__":
    main()
