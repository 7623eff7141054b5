"""PyTorch port vs JAX reference: the array-level architecture simulator
(``repro_torch.arch``) and the §V cost model (``core/costmodel.py``,
``core/popcount.py``).

Everything here is pure Python or integer arithmetic in both packages,
so it is held EQUAL: specs, tile plans, command traces, priced reports
(``report_dict``) over a grid of shapes, specs and ``CostParams``; the
closed-form cycles / energy / area and the §V headline ratios; trace
collection and per-request attribution; the workload pricing of
qwen2-0.5b.  The ``array`` backend's numerics are held per size class:
the packed class bit for bit, the moment class to float tolerance, the
binomial class by its law.  Unlike the reference, which records at JAX
trace time, the port records every executed call.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import arch as jarch
from repro import sc as jsc
from repro.arch import backend as jback
from repro.configs import get_config as jax_config
from repro.core import costmodel as jcm
from repro.core import popcount as jpop
from repro_torch import arch as tarch
from repro_torch import obs
from repro_torch import sc as tsc
from repro_torch.arch import backend as tback
from repro_torch.configs import get_config as torch_config
from repro_torch.core import costmodel as tcm
from repro_torch.core import popcount as tpop
from repro_torch.sc import ctr_rng as trng


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


_SPECS = [
    dict(),
    dict(banks=2, subarrays_per_bank=4, rows_per_subarray=8),
    dict(banks=1, subarrays_per_bank=2, rows_per_subarray=8, row_length=128),
    dict(banks=3, subarrays_per_bank=5, rows_per_subarray=7),
]
_PARAMS = [
    dict(),
    dict(sa_read_cycles=3, bank_merge_per_level=2, pulse_tau_ns=0.7),
    dict(row_length=128, preset_cycles=2, apc_energy_pj=0.9),
]
_SHAPES = [(1, 1, 1), (1, 896, 128), (5, 1, 1), (8, 32, 8), (3, 17, 11)]


def _pair(spec_kw, params_kw):
    """Spec and params of one row length (the scheduler refuses a
    mismatch, as the reference does)."""
    row = spec_kw.get("row_length", params_kw.get("row_length", 256))
    spec_kw = {**spec_kw, "row_length": row}
    params_kw = {**params_kw, "row_length": row}
    return (
        (jarch.ArraySpec(**spec_kw), jcm.CostParams(**params_kw)),
        (tarch.ArraySpec(**spec_kw), tcm.CostParams(**params_kw)),
    )


def _plan_dict(plan):
    d = dataclasses.asdict(plan)
    d["products_per_wave"] = plan.products_per_wave
    d["tail_subarrays"] = plan.tail_subarrays
    d["cells_touched"] = plan.cells_touched
    return d


@pytest.mark.parametrize("spec_kw", _SPECS)
def test_spec_and_tiler_equal_reference(spec_kw):
    js, ts = jarch.ArraySpec(**spec_kw), tarch.ArraySpec(**spec_kw)
    assert dataclasses.asdict(js) == dataclasses.asdict(ts)
    for attr in ("subarrays", "rows", "cells", "cells_per_subarray"):
        assert getattr(js, attr) == getattr(ts, attr)
    for nbit in (32, 256, 1024):
        assert js.rows_per_product(nbit) == ts.rows_per_product(nbit)
        if js.rows_per_product(nbit) > js.rows_per_subarray:
            with pytest.raises(ValueError, match="cross-subarray"):
                ts.products_per_subarray(nbit)
            continue
        assert js.products_per_wave(nbit) == ts.products_per_wave(nbit)
        for m, k, n in _SHAPES:
            jp = jarch.tile_matmul(m, k, n, nbit, js)
            tp = tarch.tile_matmul(m, k, n, nbit, ts)
            assert _plan_dict(jp) == _plan_dict(tp)
            assert jarch.plan_summary(jp) == tarch.plan_summary(tp)
            assert jarch.occupancy(jp) == tarch.occupancy(tp)
            if m * k * n <= 2048:
                want = [dataclasses.asdict(t) for t in jarch.iter_tiles(jp)]
                got = [dataclasses.asdict(t) for t in tarch.iter_tiles(tp)]
                assert got == want


def test_spec_and_tiler_reject_what_the_reference_rejects():
    with pytest.raises(ValueError, match="positive int"):
        tarch.ArraySpec(banks=0)
    with pytest.raises(ValueError, match="positive"):
        tarch.tile_matmul(0, 4, 4, 1024)
    plan = tarch.tile_matmul(64, 64, 64, 1024)
    with pytest.raises(ValueError, match="max_tiles"):
        list(tarch.iter_tiles(plan, max_tiles=10))


@pytest.mark.parametrize("spec_kw", _SPECS)
@pytest.mark.parametrize("params_kw", _PARAMS)
def test_schedule_and_accounting_equal_reference(spec_kw, params_kw):
    (js, jp), (ts, tp) = _pair(spec_kw, params_kw)
    for nbit in (256, 1024):
        if js.rows_per_product(nbit) > js.rows_per_subarray:
            continue
        for m, k, n in _SHAPES:
            jrec = jback.schedule_call(m, k, n, nbit, js, jp)
            trec = tback.schedule_call(m, k, n, nbit, ts, tp)
            assert [dataclasses.asdict(c) for c in trec.trace] == [
                dataclasses.asdict(c) for c in jrec.trace
            ]
            assert tarch.makespan(trec.trace) == jarch.makespan(jrec.trace)
            assert tarch.format_trace(trec.trace) == jarch.format_trace(
                jrec.trace
            )
            assert tarch.report_dict(trec.report) == jarch.report_dict(
                jrec.report
            )
            assert dataclasses.asdict(trec.report) == dataclasses.asdict(
                jrec.report
            )
            assert trec.as_dict() == jrec.as_dict()


def test_schedule_rejects_row_length_mismatch():
    spec = tarch.ArraySpec(row_length=128)
    with pytest.raises(ValueError, match="row_length"):
        tback.schedule_call(1, 1, 1, 256, spec, tcm.CostParams())


def test_report_merges_equal_reference():
    shapes = [(1, 896, 128), (3, 17, 11), (8, 32, 8)]
    jreps = [jback.schedule_call(*s, 1024).report for s in shapes]
    treps = [tback.schedule_call(*s, 1024).report for s in shapes]
    for fn in ("merge_reports", "merge_concurrent_reports"):
        want = getattr(jarch, fn)(jreps)
        got = getattr(tarch, fn)(treps)
        assert tarch.report_dict(got) == jarch.report_dict(want)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(tarch.merge_reports([])) == dataclasses.asdict(
        jarch.merge_reports([])
    )
    for r in (0, 1, 3):
        assert dataclasses.asdict(
            tarch.scaled(treps[0], r)
        ) == dataclasses.asdict(jarch.scaled(jreps[0], r))
    with pytest.raises(ValueError):
        tarch.scaled(treps[0], -1)


def test_schedule_call_is_cached_per_shape_and_hardware():
    a = tback.schedule_call(2, 64, 32, 1024)
    assert tback.schedule_call(2, 64, 32, 1024) is a
    with tarch.use_spec(tarch.ArraySpec(banks=2)):
        b = tback.schedule_call(2, 64, 32, 1024)
    assert b is not a and b.plan.spec.banks == 2
    with tarch.use_params(tcm.CostParams(sa_read_cycles=5)):
        c = tback.schedule_call(2, 64, 32, 1024)
    assert c.report.cycles > a.report.cycles


@pytest.mark.parametrize("params_kw", _PARAMS)
def test_closed_form_costs_and_headline_ratios_equal_reference(params_kw):
    jp, tp = jcm.CostParams(**params_kw), tcm.CostParams(**params_kw)
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    for n_bits in (4, 8, 10, 12):
        for fn in ("cycles_scpim_apc", "cycles_sc", "cycles_pim"):
            assert getattr(tcm, fn)(n_bits, tp) == getattr(jcm, fn)(n_bits, jp)
        assert tcm.cycles_scpim_csa(n_bits, 37, tp) == jcm.cycles_scpim_csa(
            n_bits, 37, jp
        )
        for kind in ("apc", "csa"):
            assert tcm.energy_scpim(n_bits, kind, 50, tp) == jcm.energy_scpim(
                n_bits, kind, 50, jp
            )
            assert tcm.area_scpim(n_bits, kind, tp) == jcm.area_scpim(
                n_bits, kind, jp
            )
        for fn in ("energy_sc", "energy_pim", "area_sc", "area_pim"):
            assert getattr(tcm, fn)(n_bits, tp) == getattr(jcm, fn)(n_bits, jp)
        want = jcm.full_comparison(n_bits, 100, jp)
        got = tcm.full_comparison(n_bits, 100, tp)
        assert {k: dataclasses.asdict(v) for k, v in got.items()} == {
            k: dataclasses.asdict(v) for k, v in want.items()
        }
        assert tcm.headline_ratios(n_bits, tp) == jcm.headline_ratios(
            n_bits, jp
        )
    for name in ("preset_energy_pj_per_cell", "pulse_energy_pj_per_cell",
                 "conversion_energy_pj_per_operand"):
        assert getattr(tp, name)() == getattr(jp, name)()
    for rows in (1, 2, 4, 5, 64):
        assert tp.merge_cycles(rows) == jp.merge_cycles(rows)


def test_headline_ratios_reproduce_the_paper():
    """§V: ≈4× cycles vs SC, ≈18× vs PIM, ≈58 % energy saving, ≈10×
    area; and a single-MUL trace prices to the closed form."""
    r = tcm.headline_ratios()
    assert 3.0 < r["speedup_vs_sc"] < 5.0
    assert 15.0 < r["speedup_vs_pim"] < 21.0
    assert 0.5 < r["energy_saving_vs_sc"] < 0.66
    assert 8.0 < r["area_ratio_sc_over_ours"] < 12.0
    rec = tback.schedule_call(1, 1, 1, 1024)
    assert rec.report.cycles == tcm.cycles_scpim_apc(10)
    e, _ = tcm.energy_scpim(10, "apc")
    assert rec.report.energy_pj == pytest.approx(e, rel=1e-12)


def test_popcount_models_equal_reference():
    for n in (1, 2, 3, 4, 7, 100, 1000):
        assert tpop.csa_passes(n) == jpop.csa_passes(n)
        assert tpop.apc_cycles(n) == jpop.apc_cycles(n)
        assert tpop.csa_fold_cycles(n) == jpop.csa_fold_cycles(n)
    for n_mul, nbit in ((1, 1024), (100, 1024), (7, 300), (64, 256)):
        assert tpop.csa_fa_cycles(n_mul, nbit) == jpop.csa_fa_cycles(
            n_mul, nbit
        )
        assert tpop.csa_fa_cycles_per_mul(
            n_mul, nbit, 128
        ) == jpop.csa_fa_cycles_per_mul(n_mul, nbit, 128)
        assert tpop.rows_per_mul(nbit) == jpop.rows_per_mul(nbit)
    rng = np.random.default_rng(0)
    states = rng.integers(0, 2, (5, 9, 64)).astype(np.uint8)
    apc = tpop.apc_popcount(_t(states))
    np.testing.assert_array_equal(
        apc.numpy(), np.asarray(jpop.apc_popcount(jnp.asarray(states)))
    )
    fa = tpop.csa_fa_popcount(_t(states))
    np.testing.assert_array_equal(
        fa.numpy(), np.asarray(jpop.csa_fa_popcount(jnp.asarray(states)))
    )
    rows = _t(states[0])
    got = tpop.csa_compress(rows).numpy()
    want = np.asarray(jpop.csa_compress(jnp.asarray(states[0])))
    np.testing.assert_array_equal(got, want)


def test_workload_pricing_of_qwen2_0_5b_equals_reference():
    jcfg, tcfg = jax_config("qwen2-0.5b"), torch_config("qwen2-0.5b")
    for tokens in (1, 64):
        js = jarch.dense_workload(jcfg, tokens)
        ts = tarch.dense_workload(tcfg, tokens)
        assert [dataclasses.asdict(s) for s in ts] == [
            dataclasses.asdict(s) for s in js
        ]
        assert [s.products for s in ts] == [s.products for s in js]
        jper, jtot = jarch.price_workload(js, 1024)
        tper, ttot = tarch.price_workload(ts, 1024)
        assert tarch.report_dict(ttot) == jarch.report_dict(jtot)
        assert [tarch.report_dict(r) for _, r in tper] == [
            jarch.report_dict(r) for _, r in jper
        ]
    # the audio family with the embeddings frontend: the reference's
    # sites, the frontend's projection among them
    js = jarch.dense_workload(jax_config("musicgen-large"), 5)
    ts = tarch.dense_workload(torch_config("musicgen-large"), 5)
    assert [dataclasses.asdict(s) for s in ts] == [
        dataclasses.asdict(s) for s in js
    ]
    assert ("frontend.proj", 5, 2048, 2048, 1) in [
        dataclasses.astuple(s) for s in ts
    ]


# ---------------------------------------------------------------------------
# The ``array`` backend
# ---------------------------------------------------------------------------


def _xw(seed, m, k, n):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (m, k)).astype(np.float32),
            rng.uniform(-1, 1, (k, n)).astype(np.float32))


def test_array_backend_registers_lazily_and_records_every_call():
    assert "array" in tsc.available_backends()
    x, w = _xw(0, 2, 8, 4)
    cfg = tsc.ScConfig(backend="array", nbit=256)
    with tarch.collect() as outer:
        with tarch.collect() as inner:
            for _ in range(3):
                tsc.sc_dot(trng.prng_key(1), _t(x), _t(w), cfg)
        tsc.sc_dot(trng.prng_key(1), _t(x), _t(w), cfg)
    # eager: every executed call records (the jitted reference records
    # once per compiled shape); nested collectors both hear
    assert len(inner) == 3 and len(outer) == 4
    with jarch.collect() as jrecs:
        jsc.sc_dot(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(w),
                   jsc.ScConfig(backend="array", nbit=256))
    assert outer[0].as_dict() == jrecs[0].as_dict()
    assert outer[0].shape == (2, 8, 4)
    s = tarch.summarize(outer, tarch.DEFAULT_SPEC)
    want = jarch.summarize(jrecs * 4, jarch.DEFAULT_SPEC)
    assert s == want
    assert not tback.trace.active()


def test_array_backend_numerics_per_size_class():
    # packed class (<= 2^16 cells): bit-equal to the reference's
    x, w = _xw(1, 2, 4, 6)
    got = tsc.sc_dot(trng.prng_key(2), _t(x), _t(w),
                     tsc.ScConfig(backend="array", nbit=1024))
    want = jsc.sc_dot(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(w),
                      jsc.ScConfig(backend="array", nbit=1024))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # moment class (> 2^21 products): the reference's law to float
    # tolerance (the noise is jax.random.normal to ~2e-5, the matmuls
    # sum in another order)
    x, w = _xw(2, 1, 2048, 1025)
    got = tsc.sc_dot(trng.prng_key(3), _t(x), _t(w),
                     tsc.ScConfig(backend="array", nbit=64))
    want = jsc.sc_dot(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(w),
                      jsc.ScConfig(backend="array", nbit=64))
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4 * scale)
    # binomial class: its mean is the exact product
    x, w = _xw(3, 4, 256, 64)
    got = tsc.sc_dot(trng.prng_key(4), _t(x), _t(w),
                     tsc.ScConfig(backend="array", nbit=1024))
    exact = x @ w
    err = got.numpy() - exact
    assert abs(err.mean()) < 0.05 and err.std() < 0.2 * np.abs(exact).max()


def test_array_backend_respects_and_validates_the_ambient_spec():
    x, w = _xw(4, 2, 8, 4)
    small = tarch.ArraySpec(banks=1, subarrays_per_bank=1,
                            rows_per_subarray=4)
    cfg = tsc.ScConfig(backend="array", nbit=1024)
    with tarch.use_spec(small), tarch.collect() as recs:
        tsc.sc_dot(trng.prng_key(0), _t(x), _t(w), cfg)
    assert recs[0].plan.spec == small and recs[0].plan.waves == 64
    tiny_rows = tarch.ArraySpec(rows_per_subarray=2)
    with tarch.use_spec(tiny_rows):
        with pytest.raises(ValueError, match="cross-subarray"):
            tsc.sc_dot(trng.prng_key(0), _t(x), _t(w), cfg)


def test_array_backend_straight_through_gradient():
    x, w = _xw(5, 3, 8, 4)
    xt = _t(x).requires_grad_(True)
    wt = _t(w).requires_grad_(True)
    y = tsc.sc_dot(trng.prng_key(0), xt, wt,
                   tsc.ScConfig(backend="array", nbit=256))
    g = torch.ones_like(y)
    y.backward(g)
    np.testing.assert_allclose(xt.grad.numpy(), g.numpy() @ w.T, rtol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), x.T @ g.numpy(), rtol=1e-6)


def test_array_pricing_feeds_the_default_registry():
    reg = obs.default_registry()
    was = reg.enabled
    reg.enable()
    try:
        before = reg.value("arch_sc_dot_calls_total") or 0
        cyc = reg.value("arch_cycles_total") or 0
        x, w = _xw(6, 1, 8, 2)
        with tarch.collect() as recs:
            tsc.sc_dot(trng.prng_key(0), _t(x), _t(w),
                       tsc.ScConfig(backend="array", nbit=256))
        assert reg.value("arch_sc_dot_calls_total") == before + 1
        assert reg.value("arch_cycles_total") == cyc + recs[0].report.cycles
    finally:
        if not was:
            reg.disable()


def test_cost_per_request_equals_reference():
    jc, tc = jarch.TraceCollector(), tarch.TraceCollector()
    assert tc.cost_per_request() == {}
    for shape in ((1, 64, 32), (6, 64, 128), (1, 128, 64)):
        jc.records.append(jback.schedule_call(*shape, 1024))
        tc.records.append(tback.schedule_call(*shape, 1024))
    for c in (jc, tc):
        c.note_request(0, 12)
        c.note_request(1, 30)
        c.note_request(0, 10)  # re-stamping overwrites
    assert tc.cost_per_request() == jc.cost_per_request()
    assert tarch.report_dict(tc.aggregate()) == jarch.report_dict(
        jc.aggregate()
    )
    tc.clear()
    assert tc.records == [] and tc.cost_per_request() == {}
