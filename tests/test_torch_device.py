"""PyTorch port vs JAX reference: device realism — ``DeviceProfile``,
its frozen cell maps and fault census, the ``array`` backend's
``_device_numerics``, and serving on a faulty device.

Classes:

* bit for bit — the profiles, ``cell_maps`` (numpy float64 from the same
  Threefry words), ``cell_span``, ``stuck_counts``, ``bit_error_census``,
  ``subarray_error_masks``, the rate quantiles, and ``_device_numerics``'
  realized-cell branch (≤ 2^20 cells: ``split``, then ``uniform <
  p**rate``; the rare float32 ``pow`` ulp between XLA and ATen did not
  flip a bit at these inputs);
* 1e-5 of max |out| — the large branch (quantile powers averaged in
  another order, ``normal`` through ``erfinv`` within ~2e-5);
* tokens — serving on ``tiny`` and ``harsh``.  At the SMOKE widths
  (every call in the large branch) the greedy tokens equal the JAX
  engine's with the operand grid on.  At the narrow widths whose calls
  all take the realized-cell branch, an ulp of difference in an
  activation (XLA vs ATen rms_norm / softmax) can move an operand across
  a 10-bit grid step, and later layers turn the flip into another token
  (seen on the six-request workload of ``test_torch_serve.py``; ROADMAP
  "Facts"); with ``quantize_grid`` switched off in both packages every
  token is equal, which is what that test holds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import arch as jarch
from repro import obs as jobs
from repro import sc as jsc
from repro.arch import backend as jback
from repro.configs import get_smoke_config as jax_smoke
from repro.core import physics as jphys
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.sc import encoding as jenc
from repro.serve import Request as JaxRequest
from repro.serve import ServeOptions as JaxOptions
from repro.serve import build_engine as jax_build
from repro_torch import arch as tarch
from repro_torch import obs as tobs
from repro_torch import sc as tsc
from repro_torch.arch import backend as tback
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core import physics as tphys
from repro_torch.models import layers as tlayers
from repro_torch.models import params as tparams
from repro_torch.sc import ctr_rng as trng
from repro_torch.sc import encoding as tenc
from repro_torch.serve import Request as TorchRequest
from repro_torch.serve import ServeOptions as TorchOptions
from repro_torch.serve import build_engine as torch_build
from test_torch_serve import _drive


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


_MAP_FIELDS = ("delta", "i_c_ua", "rate", "stuck0", "stuck1", "cum0", "cum1")


# ---------------------------------------------------------------------------
# Profiles and maps
# ---------------------------------------------------------------------------


def test_profiles_equal_reference_and_validate():
    assert set(tphys.DEVICE_PROFILES) == set(jphys.DEVICE_PROFILES)
    for name, prof in tphys.DEVICE_PROFILES.items():
        ref = jphys.DEVICE_PROFILES[name]
        assert dataclasses.asdict(prof) == dataclasses.asdict(ref)
        assert (prof.is_ideal, prof.has_faults) == (ref.is_ideal,
                                                    ref.has_faults)
    assert tphys.DeviceProfile(delta=50.0, i_c_ua=90.0).is_ideal
    assert not tphys.DeviceProfile(sigma_ic=0.01).is_ideal
    assert tphys.DeviceProfile(ber_retention=1e-4).has_faults
    for bad in (dict(sigma_delta=-0.1), dict(ber_stuck0=-1e-3),
                dict(ber_stuck0=0.6, ber_stuck1=0.6), dict(map_cells=0)):
        with pytest.raises(ValueError):
            tphys.DeviceProfile(**bad)
    tiny = tphys.DEVICE_PROFILES["tiny"]
    assert tphys.resolve_profile(None) is None
    assert tphys.resolve_profile("tiny") is tiny
    assert tphys.resolve_profile(tiny) is tiny
    assert hash(tiny) == hash(tiny.replace())
    with pytest.raises(KeyError, match="unknown device profile"):
        tphys.named_profile("nope")


@pytest.mark.parametrize(
    "prof_kw",
    [
        dict(name="tiny"),
        dict(name="harsh"),
        dict(sigma_delta=0.1, sigma_ic=0.05, ber_stuck1=0.01, seed=7,
             map_cells=5000),
        dict(map_cells=1 << 10),
    ],
)
def test_cell_maps_bit_equal_reference(prof_kw):
    if "name" in prof_kw:
        tprof = tphys.DEVICE_PROFILES[prof_kw["name"]]
        jprof = jphys.DEVICE_PROFILES[prof_kw["name"]]
    else:
        tprof = tphys.DeviceProfile(**prof_kw)
        jprof = jphys.DeviceProfile(**prof_kw)
    got, want = tphys.cell_maps(tprof), jphys.cell_maps(jprof)
    for f in _MAP_FIELDS:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(tback._rate_quantiles(tprof),
                                  jback._rate_quantiles(jprof))
    if tprof.is_ideal:
        assert np.all(got.rate == 1.0) and int(got.cum0[-1]) == 0


@pytest.mark.parametrize("name", ["tiny", "harsh"])
def test_spans_stuck_counts_and_census_equal_reference(name):
    tprof, jprof = tphys.DEVICE_PROFILES[name], jphys.DEVICE_PROFILES[name]
    cases = [(100, 0), (1 << 14, 0), (5000, 777), (3, (1 << 14) - 1),
             (3 * (1 << 18) + 17, 12345), (0, 5)]
    for n_cells, start in cases:
        np.testing.assert_array_equal(
            tphys.cell_span(tprof, min(n_cells, 9000), start),
            jphys.cell_span(jprof, min(n_cells, 9000), start))
        assert tphys.stuck_counts(tprof, n_cells, start) == \
            jphys.stuck_counts(jprof, n_cells, start)
        assert tarch.bit_error_census(tprof, n_cells, start) == \
            jarch.accounting.bit_error_census(jprof, n_cells, start)
    # brute force over the realized maps
    maps = tphys.cell_maps(tprof)
    idx = tphys.cell_span(tprof, 70000, 33)
    assert tphys.stuck_counts(tprof, 70000, 33) == (
        int(maps.stuck0[idx].sum()), int(maps.stuck1[idx].sum()))
    spec_kw = dict(banks=2, subarrays_per_bank=3, rows_per_subarray=64)
    assert tarch.subarray_error_masks(tprof, tarch.ArraySpec(**spec_kw)) == \
        jarch.accounting.subarray_error_masks(jprof,
                                              jarch.ArraySpec(**spec_kw))
    assert tarch.bit_error_census(tphys.DeviceProfile(), 999) == {
        "cells": 999, "stuck0": 0, "stuck1": 0, "retention": 0}


def test_mul_cell_params_and_eq3_equal_reference():
    tprof = tphys.DeviceProfile(sigma_delta=0.1, map_cells=1 << 12)
    jprof = jphys.DeviceProfile(sigma_delta=0.1, map_cells=1 << 12)
    td, ti = tphys.mul_cell_params(tprof, 4, 64)
    jd, ji = jphys.mul_cell_params(jprof, 4, 64)
    assert td.shape == (4, 64) and td.dtype == torch.float32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    rng = np.random.default_rng(0)
    tau = rng.uniform(0.0, 5.0, 200).astype(np.float32)
    cur = rng.uniform(60.0, 100.0, 200).astype(np.float32)
    # float32 exp of the same expression: within a few ulps
    np.testing.assert_allclose(
        tphys.p_unswitched(_t(tau), _t(cur)).numpy(),
        np.asarray(jphys.p_unswitched(jnp.asarray(tau), jnp.asarray(cur))),
        rtol=2e-5, atol=1e-30)
    p = np.concatenate([rng.uniform(0, 1, 100), [0.0, 1.0]]).astype(
        np.float32)
    np.testing.assert_allclose(
        tphys.tau_for_probability(_t(p)).numpy(),
        np.asarray(jphys.tau_for_probability(jnp.asarray(p))), rtol=1e-6)
    # at I = I_c the survival is exp(-tau) and the inversion round-trips
    np.testing.assert_allclose(
        tphys.p_unswitched(tphys.tau_for_probability(_t(p[:100])),
                           tphys.I_C_UA).numpy(), p[:100], rtol=1e-5)


# ---------------------------------------------------------------------------
# The array backend's device numerics
# ---------------------------------------------------------------------------


def _xw(seed, m, k, n):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (m, k)).astype(np.float32),
            rng.uniform(-1, 1, (k, n)).astype(np.float32))


def _both(x, w, nbit, name, quantize=True, key=9):
    jcfg = jsc.ScConfig(backend="array", nbit=nbit, quantize=quantize,
                        device=jphys.DEVICE_PROFILES[name])
    tcfg = tsc.ScConfig(backend="array", nbit=nbit, quantize=quantize,
                        device=tphys.DEVICE_PROFILES[name])
    want = jsc.sc_dot(jax.random.PRNGKey(key), jnp.asarray(x),
                      jnp.asarray(w), jcfg)
    got = tsc.sc_dot(trng.prng_key(key), _t(x), _t(w), tcfg)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("name", ["tiny", "harsh"])
@pytest.mark.parametrize("m,k,n,nbit", [(1, 8, 4, 32), (2, 16, 8, 64),
                                        (3, 5, 7, 256)])
def test_realized_cell_branch_bit_equals_reference(name, m, k, n, nbit):
    x, w = _xw(m * k + n, m, k, n)
    assert m * k * n * nbit <= tback._DEVICE_CELL_CAP
    got, want = _both(x, w, nbit, name)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["tiny", "harsh"])
@pytest.mark.parametrize("quantize", [True, False])
def test_cell_population_branch_matches_reference(name, quantize):
    x, w = _xw(3, 2, 32, 64)
    assert 2 * 32 * 64 * 1024 > tback._DEVICE_CELL_CAP
    got, want = _both(x, w, 1024, name, quantize)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)


def test_cell_population_chunks_change_only_the_sum_order(monkeypatch):
    """Column chunks draw the same noise elements (``normal_at`` at the
    whole draw's flat indices); only the float32 order of the sums over
    K and the quantiles may change, by an ulp or so."""
    x, w = _xw(4, 2, 16, 48)
    cfg = tsc.ScConfig(backend="array", nbit=1024,
                       device=tphys.DEVICE_PROFILES["harsh"])
    whole = tsc.sc_dot(trng.prng_key(1), _t(x), _t(w), cfg)
    steps = []
    real = trng.normal_at

    def spy(key, index):
        steps.append(index.shape)
        return real(key, index)

    # 5 columns per step: 48 columns in 10 chunks
    monkeypatch.setattr(tback, "_DEVICE_CHUNK",
                        2 * 16 * tback._RATE_QUANTILES * 5)
    monkeypatch.setattr(trng, "normal_at", spy)
    chunked = tsc.sc_dot(trng.prng_key(1), _t(x), _t(w), cfg)
    assert steps == [(32, 5)] * 9 + [(32, 3)]
    scale = float(whole.abs().max())
    torch.testing.assert_close(chunked, whole, rtol=0, atol=1e-6 * scale)


def test_ideal_device_profile_is_bit_identical_everywhere():
    """The reference's contract (tests/test_sc_registry.py): a profile
    with sigma = 0 and no faults changes nothing on any backend."""
    x, w = _xw(5, 4, 32, 4)
    ideal = tphys.DeviceProfile()
    assert ideal.is_ideal
    for backend in tsc.available_backends():
        cfg = tsc.ScConfig(backend=backend, nbit=256)
        y0 = tsc.sc_dot(trng.prng_key(0), _t(x), _t(w), cfg)
        y1 = tsc.sc_dot(trng.prng_key(0), _t(x), _t(w),
                        cfg.replace(device=ideal))
        assert torch.equal(y0, y1), backend


def test_nonideal_profile_perturbs_only_the_array_backend():
    x, w = _xw(6, 4, 32, 4)
    tiny = tphys.DEVICE_PROFILES["tiny"]
    for backend in tsc.available_backends():
        cfg = tsc.ScConfig(backend=backend, nbit=256)
        y0 = tsc.sc_dot(trng.prng_key(0), _t(x), _t(w), cfg)
        y1 = tsc.sc_dot(trng.prng_key(0), _t(x), _t(w),
                        cfg.replace(device=tiny))
        assert torch.equal(y0, y1) == (backend != "array"), backend


def test_bit_error_census_reaches_the_default_registry():
    prof = "harsh"
    x, w = _xw(7, 1, 16, 8)
    regs = (tobs.default_registry(), jobs.default_registry())
    was = [r.enabled for r in regs]
    for r in regs:
        r.enable()
    try:
        before = [{k: r.value("arch_bit_errors_total", kind=k, shard="1")
                   or 0 for k in ("stuck0", "stuck1", "retention")}
                  for r in regs]
        _both(x, w, 1024, prof)
        after = [{k: r.value("arch_bit_errors_total", kind=k, shard="1")
                  for k in ("stuck0", "stuck1", "retention")} for r in regs]
    finally:
        for r, on in zip(regs, was):
            if not on:
                r.disable()
    census = tarch.bit_error_census(tphys.DEVICE_PROFILES[prof],
                                    16 * 8 * 1024)
    for b, a in zip(before, after):
        assert {k: a[k] - b[k] for k in a} == {
            k: census[k] for k in ("stuck0", "stuck1", "retention")}
    assert census["stuck0"] > 0 and census["retention"] > 0


def test_dense_reads_the_ambient_device_profile():
    cfg = torch_smoke("qwen2-0.5b").replace(sc_backend="array", sc_nbit=32)
    x = torch.randn((2, 8), generator=torch.Generator().manual_seed(0))
    w = torch.randn((8, 4), generator=torch.Generator().manual_seed(1))
    key = trng.prng_key(3)
    y0 = tlayers.dense(x, w, cfg, key)
    with tsc.use_device_profile(None):
        assert tsc.current_device_profile() is None
        assert torch.equal(y0, tlayers.dense(x, w, cfg, key))
    with tsc.use_device_profile(tphys.DEVICE_PROFILES["tiny"]):
        assert tsc.current_device_profile().map_cells == 1 << 14
        y1 = tlayers.dense(x, w, cfg, key)
    assert tsc.current_device_profile() is None
    assert not torch.equal(y0, y1)


# ---------------------------------------------------------------------------
# Serving on a faulty device
# ---------------------------------------------------------------------------


def test_build_engine_routes_fault_profiles_onto_array():
    cfg = torch_smoke("qwen2-0.5b")
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models import lm as tlm

    p = tparams.init_params(tlm.lm_param_specs(cfg), gen, "cpu")
    opts = TorchOptions(paged=True, slots=1, max_len=16, block_size=8)
    eng = torch_build(p, cfg, opts.replace(fault_profile="harsh"),
                      device="cpu")
    assert eng.cfg.sc_backend == "array"
    assert eng.device_profile is tphys.DEVICE_PROFILES["harsh"]
    eng = torch_build(p, cfg, opts.replace(fault_profile="ideal"),
                      device="cpu")
    assert eng.cfg.sc_backend == "exact" and eng.device_profile.is_ideal
    eng = torch_build(p, cfg.replace(sc_backend="moment"),
                      opts.replace(fault_profile="tiny"), device="cpu")
    assert eng.cfg.sc_backend == "moment"
    eng = torch_build(p, cfg, opts, device="cpu")
    assert eng.device_profile is None
    with pytest.raises(ValueError, match="unknown device profile"):
        torch_build(p, cfg, opts.replace(fault_profile="nope"),
                    device="cpu")
    with pytest.raises(ValueError, match="unknown device profile"):
        opts.replace(fault_profile="nope").validate()
    # the reference routes the same way
    jcfg = jax_smoke("qwen2-0.5b")
    jp = jparams.init_params(jax.random.PRNGKey(0), jlm.lm_param_specs(jcfg))
    jeng = jax_build(jp, jcfg, JaxOptions(paged=True, slots=1, max_len=16,
                                          block_size=8,
                                          fault_profile="harsh"))
    assert jeng.cfg.sc_backend == "array"


def _small_workload(vocab):
    rng = np.random.default_rng(4)
    arrivals = [0, 0, 2]
    specs = [dict(rid=r, prompt=rng.integers(3, vocab, n).tolist(),
                  max_new_tokens=t, temperature=0.0)
             for r, (n, t) in enumerate([(9, 4), (5, 3), (7, 4)])]
    return arrivals, specs


def _serve_both(dims, profile):
    jcfg = jax_smoke("qwen2-0.5b").replace(
        param_dtype=jnp.float32, act_dtype=jnp.float32, **dims)
    tcfg = torch_smoke("qwen2-0.5b").replace(
        param_dtype=torch.float32, act_dtype=torch.float32, **dims)
    params = jparams.init_params(jax.random.PRNGKey(0),
                                 jlm.lm_param_specs(jcfg), jnp.float32)
    np_params = jax.tree.map(np.asarray, params)
    opts = dict(paged=True, slots=2, max_len=32, block_size=8,
                prefill_chunk=6, fault_profile=profile)
    arrivals, specs = _small_workload(jcfg.vocab)
    jeng = jax_build(params, jcfg, JaxOptions(**opts),
                     collect_arch_trace=True)
    teng = torch_build(tparams.params_from_numpy(np_params, device="cpu"),
                       tcfg, TorchOptions(**opts), collect_arch_trace=True,
                       device="cpu")
    try:
        jtok = _drive(jeng, JaxRequest, arrivals, specs)
        ttok = _drive(teng, TorchRequest, arrivals, specs)
    finally:
        jeng.close()
        teng.close()
    return jeng, teng, jtok, ttok


@pytest.mark.parametrize("profile", ["tiny", "harsh"])
def test_serving_on_a_faulty_device_gives_the_reference_tokens(profile):
    """SMOKE widths (d_model 64, nbit 1024): every call takes the large
    branch; greedy tokens equal request for request, with the grid on."""
    jeng, teng, jtok, ttok = _serve_both({}, profile)
    assert sorted(ttok) == [0, 1, 2]
    assert ttok == jtok
    assert teng.ticks == jeng.ticks
    # eager billing: one record per executed row call, each priced as the
    # reference prices that shape; the shapes are the reference's
    trecs, jrecs = teng.arch_collector.records, jeng.arch_collector.records
    assert {r.shape for r in trecs} == {r.shape for r in jrecs}
    for r in trecs:
        assert r.as_dict() == jback.schedule_call(*r.shape, 1024).as_dict()
    rep = teng.arch_report()
    assert rep.cycles > 0 and rep.products == sum(r.plan.products
                                                  for r in trecs)
    costs = teng.arch_request_costs()
    assert sorted(costs) == [0, 1, 2]
    assert sum(c["share"] for c in costs.values()) == pytest.approx(1.0)
    assert {rid: c["tokens"] for rid, c in costs.items()} == {
        rid: c["tokens"] for rid, c in jeng.arch_request_costs().items()}


@pytest.mark.parametrize("profile", ["tiny", "harsh"])
def test_serving_realized_cells_gives_the_reference_tokens_off_grid(
        monkeypatch, profile):
    """Narrow widths (d_model 32, nbit 32): every call reads the realized
    per-cell maps.  The operand grid is switched off in both packages
    (see the module doc for why); every greedy token is equal."""
    def off(p, levels):
        return p

    monkeypatch.setattr(jenc, "quantize_grid", off)
    monkeypatch.setattr(tenc, "quantize_grid", off)
    dims = dict(d_model=32, d_ff=64, vocab=128, sc_nbit=32)
    _, _, jtok, ttok = _serve_both(dims, profile)
    assert sorted(ttok) == [0, 1, 2]
    assert ttok == jtok


def test_engine_detaches_its_collector_on_close_and_on_a_raise():
    cfg = torch_smoke("qwen2-0.5b").replace(
        d_model=32, d_ff=64, vocab=64, sc_nbit=32)
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models import lm as tlm

    p = tparams.init_params(tlm.lm_param_specs(cfg), gen, "cpu")
    opts = TorchOptions(paged=True, slots=1, max_len=16, block_size=8,
                        fault_profile="tiny")
    eng = torch_build(p, cfg, opts, collect_arch_trace=True, device="cpu")
    assert tback.trace.active()
    eng.submit(TorchRequest(rid=0, prompt=[3, 4, 5], max_new_tokens=2))
    eng.run_until_drained()
    n = len(eng.arch_collector.records)
    assert n > 0 and eng.arch_report().cycles > 0
    eng.close()
    eng.close()  # idempotent
    assert not tback.trace.active()
    assert len(eng.arch_collector.records) == n  # records stay readable
    # a raise mid-tick detaches too, and counts an error
    eng = torch_build(p, cfg, opts, collect_arch_trace=True, device="cpu")
    eng.submit(TorchRequest(rid=1, prompt=[3, 4], max_new_tokens=2))
    eng.params = {**eng.params, "embed": {}}
    with pytest.raises(KeyError):
        eng.step()
    assert not tback.trace.active()
    assert eng.metrics.value("serve_errors_total") == 1
    # no collector unless the model runs on array
    eng = torch_build(p, cfg, opts.replace(fault_profile=""),
                      collect_arch_trace=True, device="cpu")
    assert eng.arch_collector is None and eng.arch_report() is None
