"""The port's cost account (``launch/cost_analysis.py``) and dry-run
(``launch/dryrun.py``) against the reference's ``hlo_analysis`` / dry-run.

* ``param_count``, ``active_param_count`` and ``model_flops_estimate``
  equal the reference's exactly, for every arch x shape;
* ``roofline_from_cost``: each term is its count over the H100's rate;
* on five tiny configs (dense, MoE, SSM, hybrid, audio; batch 2 x 32,
  cache 64) the meta trace's matmul FLOPs of ``prefill`` and
  ``decode_step`` equal the dot FLOPs of the reference's compiled HLO
  (``hlo_analysis.analyze_hlo``).  ``train`` FLOPs hold within one
  forward unembed (2·b·s·d·vocab) above XLA's, with equality on the
  dense, MoE and audio configs: the port's backward recomputes the loss
  chunk's logits under its checkpoint, and XLA merges that recompute
  with the forward's dot.  In the SSM and hybrid configs XLA's
  transpose of the SSD einsums also emits four batched dot products a
  layer (16,384 FLOPs each at this size) that the port's autograd forms
  as elementwise products and sums, so the port is above XLA by less;
* on a recording data 2 x model 2 mesh the train step records one
  float32 all-reduce over ``data`` of every gradient leaf and the loss
  (663,841,284 bytes for qwen2-0.5b at 2 layers: the bytes phase TM
  measured a step on the card) and the residual sequence's gathers over
  ``model`` that ``sharding.seq.seq_collective_plan`` counts;
* the dry-run's train cell on the FSDP ∘ TP layout (qwen2-0.5b at 2
  layers on both production meshes): its recorded all-gather and
  reduce-scatter bytes equal ``sharding.fsdp.collective_plan``'s count
  from ``param_shardings`` plus the sequence's gathers, and its argument
  bytes equal the reference layout's that ``cell_step`` returns, but for
  the rows of the global batch the port's step is handed beyond its
  own;
* the dry-run's decode cells hold the rank's block of the cache's
  sequence (the whole over the sequence's span, over ``model``, or over
  every axis at a batch of 1), and record the combine's gathers that
  ``sharding.seq.combine_plan`` counts;
* the counter's byte rules, peak live bytes and that nothing leaves
  ``meta``; the CLI writes the reference's keys.
"""

import json
import math
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_smoke
from repro.launch import hlo_analysis as H
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.optim.adamw import adamw_init as jadamw_init
from repro.train import TrainConfig as JTrain
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import (
    SHAPES,
    get_config,
    get_smoke_config,
    supported_shapes,
)
from repro_torch.launch import cost_analysis as C
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh, RecordingMesh, all_reduce
from repro_torch.models import lm
from repro_torch.models import params as params_lib
from repro_torch.optim import adamw_init
from repro_torch.train import TrainConfig, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("arch", dryrun.DRYRUN_ARCHS + ["paper-sc"])
def test_counts_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert C.param_count(cfg) == H.param_count(jcfg)
    assert C.active_param_count(cfg) == H.active_param_count(jcfg)
    for name in SHAPES:
        assert C.model_flops_estimate(cfg, SHAPES[name]) == \
            H.model_flops_estimate(jcfg, J_SHAPES[name]), name


def test_roofline_terms_and_bound():
    cost = C.StepCost(flops=3e12, bytes=6.7e12,
                      flops_by_dtype={"bf16": 2e12, "f32": 1e12},
                      coll_by_kind={"all-reduce": 5e9},
                      coll_by_axis={"data": 4e9, "model": 1e9},
                      axis_bw={"data": C.IB_BW, "model": C.NVLINK_BW})
    rf = C.roofline_from_cost(cost, 256, model_flops=1e14)
    assert rf.compute_s == pytest.approx(
        2e12 / C.PEAK_FLOPS_BF16 + 1e12 / C.PEAK_FLOPS_FP32)
    assert rf.memory_s == pytest.approx(2.0)
    assert rf.collective_s == pytest.approx(4e9 / 50e9 + 1e9 / 450e9)
    assert rf.bound == "memory"
    row = rf.row()
    assert set(row) == {"flops", "hbm_bytes", "coll_bytes", "chips",
                        "compute_s", "memory_s", "collective_s", "bound",
                        "model_flops", "useful_fraction"}
    assert row["flops"] == 3e12 * 256 and row["coll_bytes"] == 5e9 * 256
    assert row["useful_fraction"] == pytest.approx(1e14 / (3e12 * 256))
    # the H100's rates at 1,980 MHz and 132 SMs
    assert C.PEAK_FLOPS_BF16 == pytest.approx(1070.5e12, rel=1e-4)
    assert C.PEAK_FLOPS_FP32 == pytest.approx(66.9e12, rel=1e-3)
    assert C.collective_bytes(cost).total_bytes == 5e9


def test_axis_bandwidth_nvlink_within_a_node():
    pod = AbstractMesh((16, 16), ("data", "model"))
    assert C.axis_bandwidth(pod, "model") == C.IB_BW  # 16 ranks: 2 nodes
    assert C.axis_bandwidth(pod, "data") == C.IB_BW
    tm = AbstractMesh((2, 2), ("data", "model"))
    assert C.axis_bandwidth(tm, "model") == C.NVLINK_BW
    assert C.axis_bandwidth(tm, "data") == C.NVLINK_BW


B, S, L = 2, 32, 64
TINY = ["qwen2-0.5b", "moonshot-v1-16b-a3b", "mamba2-370m", "zamba2-7b",
        "musicgen-large"]


def _tiny(arch):
    jcfg, cfg = j_smoke(arch), get_smoke_config(arch)
    jp = jparams.abstract_params(jlm.lm_param_specs(jcfg), jcfg.param_dtype)
    tp = params_lib.abstract_params(lm.lm_param_specs(cfg), cfg.param_dtype)
    if cfg.frontend == "embeddings":
        jin = jax.ShapeDtypeStruct((B, S, jcfg.d_model), jcfg.act_dtype)
        tin = torch.empty((B, S, cfg.d_model), dtype=cfg.act_dtype,
                          device="meta")
    else:
        jin = jax.ShapeDtypeStruct((B, S), jnp.int32)
        tin = torch.empty((B, S), dtype=torch.int32, device="meta")
    return jcfg, cfg, jp, tp, jin, tin


def _xla_flops(fn, *args) -> float:
    return H.analyze_hlo(jax.jit(fn).lower(*args).compile().as_text()).flops


@pytest.mark.parametrize("arch", TINY)
def test_serving_flops_equal_xla(arch):
    jcfg, cfg, jp, tp, jin, tin = _tiny(arch)
    want = _xla_flops(lambda p, x: jlm.prefill(p, x, jcfg, L), jp, jin)
    _, cost = C.trace_cost(partial(lm.prefill, cfg=cfg, max_len=L), tp, tin)
    assert cost.flops == want > 0
    jc = jax.eval_shape(lambda: jlm.init_cache(jcfg, B, L))
    v = jax.ShapeDtypeStruct((B,), jnp.int32)
    want = _xla_flops(lambda p, c, t, n: jlm.decode_step(p, c, t, n, jcfg),
                      jp, jc, v, v)
    tv = torch.empty((B,), dtype=torch.int32, device="meta")
    _, cost = C.trace_cost(partial(lm.decode_step, cfg=cfg), tp,
                           lm.init_cache(cfg, B, L, device="meta"), tv, tv)
    assert cost.flops == want > 0
    assert cost.off_meta == 0


@pytest.mark.parametrize("arch", TINY)
def test_train_flops_within_one_unembed_of_xla(arch):
    jcfg, cfg, jp, tp, jin, tin = _tiny(arch)
    jt = JTrain()
    jstate = {"params": jp,
              "opt": jax.eval_shape(lambda p: jadamw_init(p, jt.optimizer),
                                    jp)}
    jb = {"inputs": jin, "labels": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    want = _xla_flops(jmake_train_step(jcfg, jt, None), jstate, jb)
    tt = TrainConfig()
    state = {"params": tp, "opt": adamw_init(tp, tt.optimizer)}
    tb = {"inputs": tin,
          "labels": torch.empty((B, S), dtype=torch.int32, device="meta")}
    _, cost = C.trace_cost(make_train_step(cfg, tt), state, tb)
    unembed = 2 * B * S * cfg.d_model * cfg.vocab  # the loss recompute
    if cfg.family in ("ssm", "hybrid"):
        assert 0 < cost.flops - want < unembed
    else:
        assert cost.flops - want == unembed
    assert cost.off_meta == 0


def _tm_cfg():
    return get_config("qwen2-0.5b").replace(n_layers=2)


def test_recorded_allreduce_is_the_gradient_and_loss():
    """One float32 all-reduce over ``data`` of every gradient leaf and
    the loss; over ``model`` the residual sequence's gathers (8 a step:
    the embedding's gradient, 3 a layer under remat, the final norm's
    input, of a rank's 4 rows x 32 positions x 896 in bf16) and the
    in-layer layout's gathers and sums (``sharding.tp.
    tp_collective_plan``; ``exact`` shards no SC contraction)."""
    from repro_torch.sharding import seq, tp
    cfg = _tm_cfg()
    mesh = RecordingMesh((2, 2), ("data", "model"))
    tt = TrainConfig()
    params = params_lib.abstract_params(lm.lm_param_specs(cfg),
                                        cfg.param_dtype)
    state = {"params": params, "opt": adamw_init(params, tt.optimizer)}
    tok = torch.empty((8, 64), dtype=torch.int32, device="meta")
    _, cost = C.trace_cost(make_train_step(cfg, tt, mesh), state,
                           {"inputs": tok, "labels": tok}, mesh=mesh)
    want = 4 * (C.param_count(cfg) + 1)
    assert want == 663_841_284  # phase TM's measured bytes a step
    plan = seq.seq_collective_plan(cfg, mesh, 8, 64)["all-gather"]
    assert plan == {"count": 8, "bytes": 8 * 229_376}
    gathers = plan["bytes"]
    tpp = tp.tp_collective_plan(cfg, mesh, 8, 64)
    assert set(tpp) == {"tp.gather", "tp.sum", "tp.vocab"}
    tp_bytes = sum(e["bytes"] for e in tpp.values())
    assert cost.coll_by_kind == {"all-reduce": want,
                                 "all-gather": gathers + tp_bytes}
    assert cost.coll_by_axis == {"data": want, "model": gathers + tp_bytes}
    assert cost.coll_by_site == {"all-reduce": want,
                                 "seq.all_gather": gathers,
                                 **{k: e["bytes"] for k, e in tpp.items()}}
    assert cost.coll_by_shape[f"all-reduce:{want}"] == want
    assert sum(cost.coll_by_shape.values()) == want + gathers + tp_bytes
    assert [r for r in mesh.records if r[0] == "all-reduce"] == [
        ("all-reduce", "data", want)]
    assert [r for r, site in zip(mesh.records, mesh.sites)
            if site == "seq.all_gather"] == [
                ("all-gather", "model", 229_376)] * 8
    assert cost.collective_seconds() == pytest.approx(
        (want + gathers + tp_bytes) / C.NVLINK_BW)
    assert cost.off_meta == 0


@pytest.mark.parametrize("multi_pod", [False, True])
def test_dryrun_train_cell_on_shards(multi_pod):
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding import fsdp

    cfg = _tm_cfg()
    mesh = make_production_mesh(multi_pod=multi_pod)
    shape = ShapeConfig("train_cut", 64, 64, "train")
    tcfg = dryrun.train_config("qwen2-0.5b")
    assert tcfg.fsdp
    from repro_torch.sharding import seq, tp

    cost, _, ref = dryrun.trace_cell(cfg, shape, mesh, tcfg)
    axes = ("pod", "data") if multi_pod else ("data",)
    plan = fsdp.collective_plan(cfg, mesh, reduce_axes=axes)
    gathers = seq.seq_collective_plan(cfg, mesh, 64, 64)["all-gather"]
    assert gathers["count"] == 8  # 4 rows (2) x 4 positions a rank
    assert cost.coll_by_site["seq.all_gather"] == gathers["bytes"]
    assert cost.coll_by_site["mesh.all_gather"] == plan["all-gather"][
        "bytes"]
    tpp = tp.tp_collective_plan(cfg, mesh, 64, 64)
    for site, e in tpp.items():
        assert cost.coll_by_site[site] == e["bytes"], site
    assert cost.coll_by_kind["all-gather"] == plan["all-gather"][
        "bytes"] + gathers["bytes"] + sum(e["bytes"] for e in tpp.values())
    assert cost.coll_by_kind["reduce-scatter"] == plan["reduce-scatter"][
        "bytes"]
    # the port's step is handed the global batch (it keeps its rows)
    batch = S.input_specs(cfg, shape)["batch"]
    whole = sum(t.numel() * t.element_size() for t in batch.values())
    rows = dryrun._sharded_bytes(batch, S.batch_shardings(
        cfg, mesh, shape.global_batch))
    assert cost.arg_bytes == ref - rows + whole
    assert cost.off_meta == 0


@pytest.mark.parametrize("batch,axes", [(32, ("model",)),
                                        (1, ("data", "model"))])
def test_dryrun_decode_cell_holds_the_cache_block(batch, axes):
    """A decode cell on 16 x 16 traces the rank's block of the cache:
    the whole over the sequence's span (``model``, or ``data`` x
    ``model`` at a batch of 1), and one combine gather an axis a layer,
    as ``sharding.seq.combine_plan`` counts."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding import rules, seq

    cfg = _tm_cfg()
    mesh = make_production_mesh()
    shape = ShapeConfig("decode_cut", 4096, batch, "decode")
    assert rules.cache_seq_axes(mesh, batch, 4096) == axes
    cost, inputs, _ = dryrun.trace_cell(cfg, shape, mesh)
    span = math.prod(mesh.shape[a] for a in axes)  # 16 or 256
    rows = batch // 16 if axes == ("model",) else batch
    assert inputs["cache/k"][0] == [2, rows, 4096 // span, 2, 64]
    whole = 2 * 2 * rows * 4096 * 2 * 64 * 2  # k and v, bf16
    cache_bytes = 2 * math.prod(inputs["cache/k"][0]) * 2
    assert cache_bytes * span == whole
    block = rules.seq_block(RecordingMesh.of(mesh), axes, 4096)
    plan = seq.combine_plan(cfg, rows, block)["all-gather"]
    assert plan["count"] == 2 * len(axes)
    assert cost.coll_by_site["seq.combine"] == plan["bytes"]
    assert cost.off_meta == 0


def test_all_reduce_records_and_leaves_the_input():
    mesh = RecordingMesh((2, 16, 16), ("pod", "data", "model"))
    assert mesh.coords == {"pod": 0, "data": 0, "model": 0}
    t = torch.arange(6, dtype=torch.float32)
    assert all_reduce(t, mesh, "pod") is t
    assert torch.equal(t, torch.arange(6, dtype=torch.float32))
    assert mesh.records == [("all-reduce", "pod", 24)]


def test_byte_rules_and_peak():
    x = torch.empty(1000, 64, device="meta")  # 256,000 bytes
    table = torch.empty(5000, 64, device="meta")
    idx = torch.empty(10, dtype=torch.int64, device="meta")

    def step(x, table, idx):
        v = x.view(64, 1000).t()  # views: free
        y = v * 2.0  # read + write: 512,000
        g = table[idx]  # gather: 80 index bytes + 2 x 2,560
        y[idx] = g[:, :1].expand(10, 64).contiguous()  # scatter
        z = y.sum()
        return z, g

    _, cost = C.trace_cost(step, x, table, idx)
    assert cost.bytes_by_op["aten.mul"] == 2 * 256_000
    assert cost.bytes_by_op["aten.index"] == 80 + 2 * 2_560
    assert cost.bytes_by_op["aten.index_put_"] == 80 + 2 * 2_560
    assert "aten.view" not in cost.bytes_by_op
    assert cost.arg_bytes == 256_000 + 1_280_000 + 80
    # y (256,000) and g (2,560) and the scatter's values (2,560) at once
    assert cost.peak_bytes == cost.arg_bytes + 256_000 + 2 * 2_560
    assert cost.out_bytes == 4 + 2_560
    assert cost.flops == 0 and cost.off_meta == 0


def test_memo_gives_the_meta_kernels_results():
    """The counter's memo of meta results changes no count: a repeated
    op costs what its first run did, and FlopCounterMode agrees."""
    a = torch.empty(64, 32, device="meta")
    b = torch.empty(32, 16, device="meta")

    def twice(a, b):
        y = torch.softmax(a @ b, -1)
        return torch.softmax(a @ b, -1) + y

    _, one = C.trace_cost(lambda a, b: torch.softmax(a @ b, -1), a, b)
    _, two = C.trace_cost(twice, a, b)
    with FlopCounterMode(display=False) as fc:
        twice(a, b)
    assert two.flops == 2 * one.flops == fc.get_total_flops()
    assert two.bytes_by_op["aten.mm"] == 2 * one.bytes_by_op["aten.mm"]
    assert two.bytes_by_op["aten._softmax"] == \
        2 * one.bytes_by_op["aten._softmax"]


def test_dryrun_cli_writes_the_reference_keys(tmp_path):
    out = tmp_path / "dry.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-0.5b", "--shape", "decode_32k", "--mesh", "pod", "--out",
         str(out)], capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(out.read_text())
    assert res["failures"] == []
    (r,) = res["results"]
    assert (r["arch"], r["shape"], r["chips"], r["mesh"]) == (
        "qwen2-0.5b", "decode_32k", 256, "16x16")
    assert {"total_per_device_gb", "reference_layout_gb",
            "argument_size_in_bytes", "temp_size_in_bytes"} <= set(
                r["memory"])
    assert set(r["roofline"]) == set(
        C.roofline_from_cost(C.StepCost(), 1).row())
    assert {"flops_per_device", "bytes_per_device", "collectives_by_kind",
            "unresolved_loops"} <= set(r["cost"])
    # the rank's rows: 128 over data 16; its block of the KV sequence
    # over model 16
    assert r["inputs"]["cache/k"][0] == [24, 8, 2048, 2, 64]
    assert r["cost"]["off_meta"] == 0
    assert r["memory"]["reference_layout_gb"] < r["memory"][
        "total_per_device_gb"]


def test_no_compile_records_placements_and_inputs():
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    r = dryrun.lower_cell("llama4-maverick-400b-a17b", "train_4k", mesh,
                          compile_=False)
    assert "cost" not in r and "roofline" not in r
    assert r["placements"]["blocks/ffn/wi"] == [None, "model", "data", None]
    assert r["inputs"]["inputs"] == [[256, 4096], "int32"]
    assert r["memory"]["reference_layout_gb"] > 0
    for arch in dryrun.DRYRUN_ARCHS:
        assert set(supported_shapes(get_config(arch))) <= set(SHAPES)


def test_profile_prints_the_cell(capsys):
    from repro_torch.launch import profile_cell

    result, cost = profile_cell.profile("qwen2-0.5b", "decode_32k", top=6)
    text = capsys.readouterr().out
    assert "qwen2-0.5b x decode_32k x 16x16" in text
    assert "bytes by aten op" in text and "aten.mm" in text
    assert cost.bytes == sum(cost.bytes_by_op.values())
    # a rank's block of the cache (1/16 of it) leaves the parameter
    # gathers the largest term
    assert result["roofline"]["bound"] == "collective"
    total = profile_cell.sc_trace("qwen2-0.5b", "decode_32k", top=2)
    assert total.products > 0 and "SOT-MRAM" in capsys.readouterr().out
