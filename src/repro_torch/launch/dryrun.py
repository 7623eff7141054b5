"""Dry-run: trace every (architecture x input-shape) cell for one rank of
the production meshes and record its memory / cost / collective account.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell with XLA; the port traces its own step functions on ``meta``
tensors under ``launch/cost_analysis.py``'s counter (nothing is
allocated, nothing runs), as rank 0 of a
:class:`~repro_torch.launch.mesh.RecordingMesh` of the production sizes:

* ``train`` is ``train/step.py:make_train_step(cfg, tcfg, mesh)`` with
  ``TrainConfig(fsdp=True)`` on the global batch: the rank's shards of
  the parameters and AdamW state (bf16 state for the 400B config, as the
  reference's dry-run has it), each layer all-gathered inside its
  checkpointed function and the gradients reduce-scattered, the step
  keeping its rank's rows over ``pod`` x ``data``, its block of the
  residual stream's sequence over ``model`` between layers
  (``sharding/seq.py``) and, inside each layer, its block of the heads
  (or of the query sequence), the MLP hidden, the loss's vocabulary and
  the SSM's ``d_inner`` / heads (``sharding/tp.py``), each weight the
  layer runs on such a block gathered over ``data`` only, as that block
  (``sharding/fsdp.py:keep_blocks``);
* ``prefill`` is ``lm.prefill`` and ``decode`` ``lm.decode_step`` on the
  rank's rows of the batch over ``pod`` x ``data`` (the whole batch
  where it does not divide: ``long_500k``'s batch of 1), the rank's
  parameter shards, gathered as the train step gathers them (the leaves
  outside the layer stack once, each layer as it runs; the expert
  leaves alone keep their ``model`` block: prefill and decode run every
  dense weight whole), and the rank's
  block of the KV cache's sequence laid out as the reference's
  ``cache_shardings`` lays it (``make_constrain``'s
  ``lay_out_cache``): prefill writes the block, decode combines the
  ranks' attention partials; the SSM state holds the rank's block of
  its heads; the in-layer layout as in training (decode attention on a
  cache laid out by its sequence keeps the heads whole).

The gathers, reduce-scatters, the sequence's gathers and the in-layer
layout's collectives (sites ``tp.gather``, ``tp.sum``, ``tp.vocab``,
``tp.lookup``, ``tp.relayout``, ``fsdp.relayout``) enter the account's
collectives through the
``RecordingMesh``.
``memory.reference_layout_gb`` is the same rank's arguments under the
reference's layout (``launch/specs.py``).  A cell that does not fit a
card's 80 GB is recorded with its number.  The models run the ``exact``
substrate, as the zoo configs default to it.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun          # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
        --shape train_4k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --out results.json
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, supported_shapes
from repro_torch.launch import cost_analysis
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import RecordingMesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.models import params as params_lib
from repro_torch.models.params import _leaves
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import adamw_init
from repro_torch.sharding import fsdp
from repro_torch.sharding.rules import Placement
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train.step import make_constrain, make_param_constrain

DRYRUN_ARCHS = [a for a in ARCH_IDS if a != "paper-sc"]
CARD_BYTES = 80e9  # device memory of one H100 SXM (the datasheet's 80 GB)


def train_config(arch: str) -> TrainConfig:
    """The dry-run's optimizer: bf16 AdamW state for the 400B config
    (f32 Adam does not fit; the reference's rule), f32 elsewhere, on the
    FSDP ∘ TP layout."""
    state_dtype = "bf16" if "400b" in arch else "f32"
    return TrainConfig(optimizer=AdamWConfig(state_dtype=state_dtype),
                       fsdp=True)


def serve_rows(mesh, batch: int) -> int:
    """Rows of a serving batch one rank holds: its share over the
    data-parallel axes the reference's layout uses, or all of them."""
    dp = S._dp_axes(mesh, batch)
    return batch // math.prod(mesh.shape[a] for a in dp) if dp else batch


def _sharded_bytes(tree, placements) -> int:
    """Bytes one rank holds of ``tree`` laid out by ``placements``."""
    pls = dict(_leaves(placements))
    return sum(math.prod(pls[p].shard_shape(t.shape)) * t.element_size()
               for p, t in _leaves(tree))


def cell_step(cfg, shape, mesh, tcfg: TrainConfig | None = None):
    """One rank's step of a cell on ``meta``: ``(fn, args, inputs,
    reference_bytes)``, ``fn(*args)`` the port's step on the rank's
    inputs (``mesh`` a :class:`RecordingMesh`; one rank means no mesh),
    ``inputs`` the name, shape and dtype of each input, and
    ``reference_bytes`` the rank's argument bytes under the reference's
    layout (``launch/specs.py``)."""
    whole = params_lib.abstract_params(lm.lm_param_specs(cfg),
                                       cfg.param_dtype)
    p_sh = S.param_shardings(cfg, mesh)
    ref = _sharded_bytes(whole, p_sh)
    step_mesh = mesh if mesh.size > 1 else None
    # the rank's shards (meta, as the whole leaves are)
    params = fsdp.shard_tree(whole, p_sh)
    specs = S.input_specs(cfg, shape)
    b, s = shape.global_batch, shape.seq_len
    serve_kw = {}
    if step_mesh is not None:
        serve_kw["constrain_params"] = make_param_constrain(
            step_mesh, cfg, fsdp=True, train=False)
        if shape.kind != "train":
            serve_kw["constrain"] = make_constrain(step_mesh)
            serve_kw["constrain"].lay_out_cache(b, s)
    if shape.kind == "train":
        tcfg = tcfg or train_config(cfg.name)
        if not tcfg.fsdp:
            params = whole
        state = {"params": params, "opt": adamw_init(params, tcfg.optimizer)}
        batch = specs["batch"]
        ref += 2 * _sharded_bytes(adamw_init(whole, tcfg.optimizer)["m"],
                                  p_sh) + 4
        ref += _sharded_bytes(batch, S.batch_shardings(cfg, mesh, b))
        fn = make_train_step(cfg, tcfg, step_mesh)
        args = (state, batch)
        inputs = batch
    elif shape.kind == "prefill":
        inp = specs["inputs"]
        ref += _sharded_bytes({"inputs": inp},
                              {"inputs": S.batch_shardings(cfg, mesh, b)
                               ["inputs"]})
        rows = torch.empty_like(inp[:serve_rows(mesh, b)])

        def fn(p, x):
            return lm.prefill(fsdp.gather_params(p, p_sh), x, cfg, s,
                              **serve_kw)
        args = (params, rows)
        inputs = {"inputs": rows}
    else:
        cache_sh = S.cache_shardings(cfg, mesh, b, s)
        ref += _sharded_bytes(specs["cache"], cache_sh)
        vec = Placement(mesh, (S._dp_axes(mesh, b),))
        ref += _sharded_bytes({"t": specs["tokens"], "l": specs["lengths"]},
                              {"t": vec, "l": vec})
        rows = serve_rows(mesh, b)
        cache = lm.init_cache(cfg, rows, s, device="meta",
                              constrain=serve_kw.get("constrain"))
        tokens = torch.empty_like(specs["tokens"][:rows])
        lengths = torch.empty_like(specs["lengths"][:rows])

        def fn(p, c, t, l):  # noqa: E741
            return lm.decode_step(fsdp.gather_params(p, p_sh), c, t, l, cfg,
                                  **serve_kw)
        args = (params, cache, tokens, lengths)
        inputs = {"cache": cache, "tokens": tokens, "lengths": lengths}
    shapes = {"/".join(p): [list(t.shape), str(t.dtype).split(".")[-1]]
              for p, t in _leaves(inputs)}
    return fn, args, shapes, ref


def trace_cell(cfg, shape, mesh, tcfg: TrainConfig | None = None):
    """Trace one rank of a cell on ``meta`` (``mesh`` the production
    sizes).  Returns ``(StepCost, inputs, reference_bytes)``."""
    rec = RecordingMesh.of(mesh)
    fn, args, inputs, ref = cell_step(cfg, shape, rec, tcfg)
    _, cost = cost_analysis.trace_cost(fn, *args, mesh=rec)
    return cost, inputs, ref


def lower_cell(arch: str, shape_name: str, mesh, *, compile_: bool = True,
               return_cost: bool = False):
    """Trace one cell for rank 0 of ``mesh`` (``compile_=False``: record
    placements and input shapes only).  Returns a result dict (and the
    :class:`~repro_torch.launch.cost_analysis.StepCost` when
    ``return_cost``)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    chips = mesh.size
    t0 = time.time()
    tcfg = train_config(arch)
    result = {"arch": arch, "shape": shape_name, "chips": chips,
              "mesh": "x".join(map(str, mesh.shape.values()))}
    p_sh = S.param_shardings(cfg, mesh)
    result["placements"] = {"/".join(p): list(pl.spec)
                            for p, pl in _leaves(p_sh)}
    if not compile_:
        rec = RecordingMesh.of(mesh)
        _, _, inputs, ref = cell_step(cfg, shape, rec, tcfg)
        result["inputs"] = inputs
        result["memory"] = {"reference_layout_gb": round(ref / 2**30, 3)}
        result["lower_s"] = round(time.time() - t0, 1)
        return (result, None) if return_cost else result

    cost, inputs, ref = trace_cell(cfg, shape, mesh, tcfg)
    result["inputs"] = inputs
    result["lower_s"] = round(time.time() - t0, 1)
    total_gb = cost.peak_bytes / 2**30
    result["memory"] = {
        "argument_size_in_bytes": cost.arg_bytes,
        "output_size_in_bytes": cost.out_bytes,
        "temp_size_in_bytes": cost.temp_bytes,
        "total_per_device_gb": round(total_gb, 3),
        "reference_layout_gb": round(ref / 2**30, 3),
        "fits": cost.peak_bytes <= CARD_BYTES,
    }
    result["cost"] = {
        "flops_per_device": cost.flops, "bytes_per_device": cost.bytes,
        "collectives_by_kind": cost.coll_by_kind,
        "unresolved_loops": cost.unresolved_loops,
        "flops_by_dtype": cost.flops_by_dtype,
        "collectives_by_axis": cost.coll_by_axis,
        "collectives_by_site": cost.coll_by_site,
        "ops": cost.ops, "off_meta": cost.off_meta}
    mf = cost_analysis.model_flops_estimate(cfg, shape)
    rf = cost_analysis.roofline_from_cost(cost, chips, model_flops=mf)
    result["roofline"] = rf.row()
    return (result, cost) if return_cost else result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, choices=DRYRUN_ARCHS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--no-compile", action="store_true",
                    help="record placements and input shapes, no trace")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else DRYRUN_ARCHS
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]

    results, failures = [], []
    t0 = time.time()
    for arch in archs:
        cfg = get_config(arch)
        shapes = supported_shapes(cfg)
        for sk in (s for s in SHAPES if s not in shapes):
            if args.shape in (None, sk):
                results.append({"arch": arch, "shape": sk, "skipped":
                                "full-attention arch: long_500k needs "
                                "sub-quadratic attention"})
        for shape_name in shapes:
            if args.shape and shape_name != args.shape:
                continue
            for multi_pod in meshes:
                mesh = make_production_mesh(multi_pod=multi_pod)
                label = (f"{arch} × {shape_name} × "
                         f"{'x'.join(map(str, mesh.shape.values()))}")
                try:
                    r = lower_cell(arch, shape_name, mesh,
                                   compile_=not args.no_compile)
                    results.append(r)
                    rf = r.get("roofline", {})
                    mem = r["memory"]
                    print(f"[ok] {label}: trace={r['lower_s']}s "
                          f"mem/dev={mem.get('total_per_device_gb', '-')}GB "
                          f"(reference layout "
                          f"{mem['reference_layout_gb']}GB) "
                          f"bound={rf.get('bound', '-')}", flush=True)
                except Exception as e:  # record the cell, run the others
                    failures.append({"cell": label, "error": str(e)})
                    print(f"[FAIL] {label}: {type(e).__name__}: {e}",
                          flush=True)
                    traceback.print_exc()
                with open(args.out, "w") as f:
                    json.dump({"results": results, "failures": failures},
                              f, indent=1)
    print(f"\n{len(results)} cells recorded, {len(failures)} failures "
          f"in {time.time() - t0:.1f} s -> {args.out}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
