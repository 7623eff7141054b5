"""PyTorch port vs JAX reference: the paper's cell model
(``core/conversion.py``, ``core/engine.py``, ``core/variance.py`` and the
rest of ``core/physics.py``).

Parity classes, on the same numpy- and seed-made inputs:

* the LUT, the DTC grid and ``operand_to_tau`` bit-equal on all 1,024
  operands;
* ``physics.p_unswitched`` (float32 ``exp``) within one ulp: XLA and
  ATen round ``exp`` differently for some pulses;
* cell states (``apply_pulse``, ``sc_multiply``, ``sc_multiply_states``
  with a device profile, ``mac_rows``) bit-equal except at cells whose
  uniform (itself bit-equal: ``ctr_rng.uniform``) lies between the two
  packages' survival probabilities; those cells are listed;
* the Gaussian variance studies through ``ctr_rng.normal`` (within ~1e-5
  of ``jax.random.normal``): ``log_multiplier`` within 1e-5, the SC
  paths' estimates within a few cells a MUL;
* ``DeviceParams``, ``scale_to_half_switching`` and
  ``switching_energy_aj`` to float tolerance.

Then the assertions of ``tests/test_engine.py``, ``tests/test_variance.py``
and ``tests/test_physics.py`` run against the port, one parametrised case
each (batched MULs under one key stand in for the reference's ``vmap``
over keys: every MUL has its own cells and uniforms either way).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import conversion as jconv
from repro.core import engine as jeng
from repro.core import physics as jphys
from repro.core import variance as jvar
from repro_torch.core import conversion as tconv
from repro_torch.core import engine as teng
from repro_torch.core import physics as tphys
from repro_torch.core import variance as tvar
from repro_torch.sc import ctr_rng

JCONV, TCONV = jconv.ConversionConfig(), tconv.ConversionConfig()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.astype(np.float32).view(np.int32).astype(np.int64)


def _tkey(jkey) -> torch.Tensor:
    return torch.tensor(np.asarray(jkey).astype(np.int64)).to(torch.uint32)


def _ulp_band(u, p_ref, p_port):
    """Cells whose ``u < p`` decision may differ between the packages:
    ``u`` in ``[min(p), max(p))``."""
    lo, hi = np.minimum(p_ref, p_port), np.maximum(p_ref, p_port)
    return (u >= lo) & (u < hi)


def _check_states(got, want, bands):
    """States equal except inside the listed pulses' ulp bands.  Returns
    (differing cells, band cells)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    band = np.zeros(want.shape, bool)
    for b in bands:
        band |= np.broadcast_to(b, want.shape)
    diff = got != want
    assert not (diff & ~band).any(), np.argwhere(diff & ~band)[:8]
    print(f"cells {want.size}: {int(band.sum())} in an ulp band "
          f"({np.argwhere(band)[:8].tolist()}), {int(diff.sum())} differ")
    return int(diff.sum()), int(band.sum())


def _same_params(a, b) -> bool:
    return (a.delta, a.i_c_ua) == (b.delta, b.i_c_ua)


def _pulse_probs(tau, **kw):
    """Both packages' survival probability of a pulse (float32)."""
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    i_ua = jkw.pop("i_ua", jphys.I_C_UA)
    tkw.pop("i_ua", None)
    p_ref = np.asarray(jphys.p_unswitched(jnp.asarray(tau), i_ua, **jkw))
    p_port = tphys.p_unswitched(torch.tensor(tau), i_ua, **tkw).numpy()
    return p_ref, p_port


# ---------------------------------------------------------------------------
# Conversion and physics: bit-equal or one ulp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_bits", [10, 8])
def test_lut_and_operand_to_tau_bit_equal(n_bits):
    jc, tc = jconv.ConversionConfig(n_bits=n_bits), \
        tconv.ConversionConfig(n_bits=n_bits)
    x = np.arange(jc.levels)
    assert (_bits(tconv.build_lut(tc, "cpu"))
            == _bits(jconv.build_lut(jc))).all()
    assert (_bits(tconv.operand_to_tau(torch.tensor(x), tc))
            == _bits(jconv.operand_to_tau(x, jc))).all()


def test_conversion_chain_matches_reference():
    x = np.arange(1024)
    y = x[::-1].copy()
    xt, yt = torch.tensor(x), torch.tensor(y)
    assert (_bits(tconv.encode_probability(xt, TCONV))
            == _bits(jconv.encode_probability(x, JCONV))).all()
    p = np.random.default_rng(0).random(4096).astype(np.float32)
    assert (tconv.decode_probability(torch.tensor(p), TCONV).numpy()
            == np.asarray(jconv.decode_probability(p, JCONV))).all()
    tau = np.random.default_rng(1).uniform(-1, 20, 4096).astype(np.float32)
    assert (_bits(tconv.dtc_quantize(torch.tensor(tau), TCONV))
            == _bits(jconv.dtc_quantize(tau, JCONV))).all()
    assert (_bits(tconv.ideal_product_probability(xt, yt, TCONV))
            == _bits(jconv.ideal_product_probability(x, y, JCONV))).all()
    # exp rounds differently: one ulp per factor at most
    d = _bits(tconv.quantized_product_probability(xt, yt, TCONV)) \
        - _bits(jconv.quantized_product_probability(x, y, JCONV))
    assert np.abs(d).max() <= 2


def test_p_unswitched_within_one_ulp():
    """On all 1,024 operand pulses, 10^5 random pulses, and per-cell I_c
    and Delta arrays: at most one ulp apart."""
    taus = [np.asarray(jconv.operand_to_tau(np.arange(1024), JCONV)),
            np.random.default_rng(2).uniform(0, 16, 100_000)
            .astype(np.float32)]
    for tau in taus:
        p_ref, p_port = _pulse_probs(tau)
        d = np.abs(_bits(p_port) - _bits(p_ref))
        assert d.max() <= 1
        print(f"{int((d > 0).sum())} of {tau.size} pulses one ulp apart")
    rng = np.random.default_rng(3)
    ic = (80.0 * (1 + 0.05 * rng.standard_normal(4096))).astype(np.float32)
    delta = (60.9 * (1 + 0.1 * rng.standard_normal(4096))).astype(np.float32)
    tau = rng.uniform(0, 3, 4096).astype(np.float32)
    p_ref, p_port = _pulse_probs(tau, i_c_ua=ic, delta=delta)
    # the inner exp's ulp is amplified by tau * rate in the outer one
    rel = np.abs(p_port.astype(np.float64) - p_ref) / np.maximum(p_ref, 1e-30)
    assert rel.max() <= 1e-5


def test_device_params_scaling_and_energy_match_reference():
    assert _same_params(tphys.DeviceParams(), jphys.DeviceParams())
    assert (tphys.PRESET_TAU_NS, tphys.PRESET_I_FACTOR) == \
        (jphys.PRESET_TAU_NS, jphys.PRESET_I_FACTOR)
    with pytest.warns(DeprecationWarning):
        t = tphys.DeviceParams().with_ic_fluctuation(0.1)
    with pytest.warns(DeprecationWarning):
        j = jphys.DeviceParams().with_ic_fluctuation(0.1)
    assert _same_params(t, j)
    tau = np.random.default_rng(4).uniform(0, 2, 64).astype(np.float32)
    ts, tsc = tphys.scale_to_half_switching(torch.tensor(tau))
    js, jsc = jphys.scale_to_half_switching(jnp.asarray(tau))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-6)
    i = np.linspace(40, 160, 64).astype(np.float32)
    np.testing.assert_allclose(
        tphys.switching_energy_aj(torch.tensor(tau), torch.tensor(i)).numpy(),
        np.asarray(jphys.switching_energy_aj(tau, i)), rtol=1e-6)


# ---------------------------------------------------------------------------
# Cell states: bit-equal except at the listed one-ulp cells
# ---------------------------------------------------------------------------


def test_apply_pulse_bit_equal_except_ulp_cells():
    jkey = jax.random.PRNGKey(5)
    tau = np.asarray(jconv.operand_to_tau(np.arange(0, 1024, 4), JCONV))
    shape = (tau.size, 512)
    want = jeng.apply_pulse(jkey, jeng.preset(shape), jnp.asarray(tau)[:, None])
    got = teng.apply_pulse(_tkey(jkey), teng.preset(shape, "cpu"),
                           torch.tensor(tau)[:, None])
    u = np.asarray(jax.random.uniform(jkey, shape))
    assert (u == ctr_rng.uniform(_tkey(jkey), shape).numpy()).all()
    p_ref, p_port = _pulse_probs(tau)
    _check_states(got, want, [_ulp_band(u, p_ref[:, None], p_port[:, None])])


def _two_pulse_bands(jkey, tau_x, tau_y, shape, **kw):
    kx, ky = jax.random.split(jkey)
    bands = []
    for k, tau in ((kx, tau_x), (ky, tau_y)):
        u = np.asarray(jax.random.uniform(k, shape))
        p_ref, p_port = _pulse_probs(np.broadcast_to(tau[..., None], shape)
                                     .copy(), **kw)
        bands.append(_ulp_band(u, p_ref, p_port))
    return bands


def test_sc_multiply_bit_equal_except_ulp_cells():
    """p_est and the decoded product of 512 MULs: equal wherever no cell
    of the MUL lies in an ulp band."""
    cfg, tcfg = jeng.EngineConfig(nbit=1024), teng.EngineConfig(nbit=1024)
    rng = np.random.default_rng(6)
    x, y = rng.integers(0, 1024, 512), rng.integers(0, 1024, 512)
    jkey = jax.random.PRNGKey(7)
    jp, jprod = jeng.sc_multiply(jkey, x, y, cfg)
    tp, tprod = teng.sc_multiply(_tkey(jkey), x, y, tcfg, device="cpu")
    tau_x = np.asarray(jconv.operand_to_tau(x, JCONV))
    tau_y = np.asarray(jconv.operand_to_tau(y, JCONV))
    bands = _two_pulse_bands(jkey, tau_x, tau_y, (512, 1024))
    clean = ~(bands[0] | bands[1]).any(-1)
    assert (tp.numpy()[clean] == np.asarray(jp)[clean]).all()
    assert (tprod.numpy()[clean] == np.asarray(jprod)[clean]).all()
    # a MUL with band cells differs by at most that many cells
    n_band = (bands[0] | bands[1]).sum(-1)
    assert (np.abs(tp.numpy() - np.asarray(jp)) * 1024 <= n_band).all()
    print(f"{int((~clean).sum())} of 512 MULs hold an ulp-band cell")


def test_sc_multiply_states_harsh_profile_bit_equal_except_ulp_cells():
    prof_j, prof_t = jphys.named_profile("harsh"), tphys.named_profile("harsh")
    cfg, tcfg = jeng.EngineConfig(nbit=256), teng.EngineConfig(nbit=256)
    rng = np.random.default_rng(8)
    tau_x = rng.uniform(0.05, 1.5, 64).astype(np.float32)
    tau_y = rng.uniform(0.05, 1.5, 64).astype(np.float32)
    jkey = jax.random.PRNGKey(9)
    want = jeng.sc_multiply_states(jkey, jnp.asarray(tau_x),
                                   jnp.asarray(tau_y), cfg, profile=prof_j)
    got = teng.sc_multiply_states(_tkey(jkey), torch.tensor(tau_x),
                                  torch.tensor(tau_y), tcfg, profile=prof_t,
                                  device="cpu")
    delta, ic = (np.asarray(a) for a in
                 jeng._profile_cells(prof_j, (64,), 256))
    tdelta, tic = teng._profile_cells(prof_t, (64,), 256, "cpu")
    assert (delta == tdelta.numpy()).all() and (ic == tic.numpy()).all()
    bands = _two_pulse_bands(jkey, tau_x, tau_y, (64, 256),
                             i_ua=prof_j.i_c_ua, i_c_ua=ic, delta=delta)
    _check_states(got, want, bands)


def test_mac_rows_bit_equal_except_ulp_cells():
    """The scan's key chain ``fold_in(k, 1)`` per step, step by step."""
    cfg, tcfg = jeng.EngineConfig(nbit=512), teng.EngineConfig(nbit=512)
    w = np.array([10, 200, 513, 1023, 0, 77])
    x = np.array([50, 600, 700, 1023, 900, 3])
    jkey = jax.random.PRNGKey(11)
    want = jeng.mac_rows(jkey, w, x, cfg)
    got = teng.mac_rows(_tkey(jkey), w, x, tcfg, device="cpu")
    bands, k = [], jkey
    for wi, xi in zip(w, x):
        tw = np.asarray(jconv.operand_to_tau(wi, JCONV))
        tx = np.asarray(jconv.operand_to_tau(xi, JCONV))
        b0, b1 = _two_pulse_bands(k, tw, tx, (512,))
        bands.append(b0 | b1)
        k = jax.random.fold_in(k, 1)
    _check_states(got, want, [np.stack(bands)])


# ---------------------------------------------------------------------------
# Variance studies: 1e-5 or a few cells a MUL
# ---------------------------------------------------------------------------


def test_log_multiplier_within_1e5():
    rng = np.random.default_rng(12)
    x, y = rng.integers(1, 1024, 256), rng.integers(1, 1024, 256)
    for sigma in (0.0, 0.04, 0.10):
        jkey = jax.random.PRNGKey(13)
        want = np.asarray(jvar.log_multiplier(jkey, x, y, JCONV, sigma))
        got = tvar.log_multiplier(_tkey(jkey), x, y, TCONV, sigma,
                                  device="cpu").numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("study", ["ic", "circuit", "profile"])
def test_sc_variance_paths_match_reference(study):
    """The SC estimates of 256 MULs: a MUL's p_est within 4 cells of the
    reference's (normal draws within ~1e-5 move a pulse's probability by
    ~1e-6, so a cell flips about once in 10^5 MULs) and the batch means
    within 1e-4."""
    cfg, tcfg = jeng.EngineConfig(nbit=1024), teng.EngineConfig(nbit=1024)
    rng = np.random.default_rng(14)
    x, y = rng.integers(0, 1024, 256), rng.integers(0, 1024, 256)
    jkey = jax.random.PRNGKey(15)
    tkey = _tkey(jkey)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        if study == "ic":
            want = jvar.sc_mul_with_ic_variance(jkey, x, y, cfg, 0.10)
            got = tvar.sc_mul_with_ic_variance(tkey, x, y, tcfg, 0.10,
                                               device="cpu")
        elif study == "circuit":
            want = jvar.sc_mul_with_circuit_variance(jkey, x, y, cfg, 0.10)
            got = tvar.sc_mul_with_circuit_variance(tkey, x, y, tcfg, 0.10,
                                                    device="cpu")
        else:
            want = jvar.sc_mul_with_profile(
                jkey, x, y, cfg, jphys.named_profile("calibrated"))
            got = tvar.sc_mul_with_profile(
                tkey, x, y, tcfg, tphys.named_profile("calibrated"),
                device="cpu")
    d = np.abs(got.numpy() - np.asarray(want))
    assert d.max() <= 4 / 1024
    assert abs(float(d.mean())) <= 1e-4
    print(f"{int((d > 0).sum())} of 256 estimates differ")


def test_ic_variance_is_deprecated():
    with pytest.warns(DeprecationWarning, match="sc_mul_with_profile"):
        tvar.sc_mul_with_ic_variance(ctr_rng.prng_key(0), 400, 700,
                                     teng.EngineConfig(nbit=64), 0.05,
                                     device="cpu")


# ---------------------------------------------------------------------------
# The reference's own assertions, against the port
# ---------------------------------------------------------------------------

CFG = teng.EngineConfig(nbit=1024)
KEY = ctr_rng.prng_key(0)


def _p_states(tau_x, tau_y, n, nbit, key=KEY):
    """p_est of ``n`` MULs of the given pulses (one key, own cells)."""
    cfg = teng.EngineConfig(nbit=nbit)
    tx = torch.full((n,), float(tau_x))
    ty = torch.full((n,), float(tau_y))
    return teng.readout(teng.sc_multiply_states(key, tx, ty, cfg,
                                                device="cpu"))


def _std(p):
    return float(torch.std(p, correction=0))


def _engine_preset_all_ones():
    s = teng.preset((4, 128), "cpu")
    assert s.dtype == torch.uint8 and int(s.sum()) == 4 * 128


def _engine_pulse_zero_duration_is_noop():
    s = teng.preset((2, 256), "cpu")
    assert torch.equal(teng.apply_pulse(KEY, s, 0.0), s)


def _engine_pulse_only_switches_toward_zero():
    s = torch.zeros((2, 256), dtype=torch.uint8)
    assert int(teng.apply_pulse(KEY, s, 0.5).sum()) == 0


def _engine_sc_multiply_shapes_and_range():
    p, prod = teng.sc_multiply(KEY, [100, 512, 1023], [512, 512, 1023], CFG,
                               device="cpu")
    assert p.shape == (3,) and prod.shape == (3,)
    assert bool(((p >= 0) & (p <= 1)).all())


def _engine_sc_multiply_mean_is_unbiased():
    iters = 400
    p, _ = teng.sc_multiply(KEY, torch.full((iters,), 400),
                            torch.full((iters,), 700), CFG, device="cpu")
    p_true = float(tconv.quantized_product_probability(400, 700, CFG.conv,
                                                       "cpu"))
    bias = float(p.mean()) - p_true
    assert abs(bias) < 3 * _std(p) / np.sqrt(iters) + 1e-4


def _engine_fig7a_sigma_at_nbit_1000():
    p = _p_states(0.3, 0.4, 1000, 1000)
    assert 0.013 < _std(p) < 0.019
    assert abs(float(p.mean()) - float(np.exp(-0.7))) < 0.002


def _engine_fig7b_sigma_scales_inverse_sqrt_nbit():
    s = {n: _std(_p_states(0.3, 0.4, 400, n, ctr_rng.fold_in(KEY, n)))
         for n in (256, 1024, 4096)}
    assert 1.6 < s[256] / s[1024] < 2.5 and 1.6 < s[1024] / s[4096] < 2.5


def _engine_fig7b_sigma_independent_of_input():
    sig = [_std(_p_states(0.3, ty, 300, 1024,
                          ctr_rng.fold_in(KEY, int(ty * 10))))
           for ty in (0.2, 0.4, 0.6)]
    assert max(sig) / min(sig) < 1.6


def _engine_mac_rows_states_shape():
    st = teng.mac_rows(KEY, [10, 20, 30, 40], [50, 60, 70, 80], CFG,
                       device="cpu")
    assert st.shape == (4, CFG.nbit) and st.dtype == torch.uint8


def _engine_rows_per_mul():
    assert teng.EngineConfig(nbit=1024, row_length=256).rows_per_mul == 4
    assert teng.EngineConfig(nbit=100, row_length=256).rows_per_mul == 1


def _var_sigma(fn, key, n=300):
    p = fn(key, torch.full((n,), 400), torch.full((n,), 700))
    return _std(p), float(p.mean())


def _ic(s):
    def fn(k, x, y):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return tvar.sc_mul_with_ic_variance(k, x, y, CFG, s,
                                                device="cpu")
    return fn


def _variance_fig8a_ic_variance_does_not_degrade_accuracy():
    sig = {s: _var_sigma(_ic(s), ctr_rng.fold_in(KEY, int(s * 100)))[0]
           for s in (0.0, 0.05, 0.10)}
    assert sig[0.10] < 1.5 * sig[0.0] and sig[0.05] < 1.5 * sig[0.0]


def _variance_fig8b_sc_flat_but_log_multiplier_degrades():
    sc_sig, log_sig = {}, {}
    for s in (0.04, 0.10):
        sc_sig[s], _ = _var_sigma(
            lambda k, x, y: tvar.sc_mul_with_circuit_variance(
                k, x, y, CFG, s, device="cpu"),
            ctr_rng.fold_in(KEY, int(s * 1000)))
        log_sig[s], _ = _var_sigma(
            lambda k, x, y: tvar.log_multiplier(k, x, y, CFG.conv, s,
                                                device="cpu"),
            ctr_rng.fold_in(KEY, 7000 + int(s * 1000)))
    assert sc_sig[0.10] < 2.0 * sc_sig[0.04]
    assert log_sig[0.10] > 2.0 * log_sig[0.04]
    assert log_sig[0.10] > 3.0 * sc_sig[0.10]


def _variance_ic_small_spread_keeps_mean_unbiased():
    p_true = float(tconv.quantized_product_probability(400, 700, CFG.conv,
                                                       "cpu"))
    _, small = _var_sigma(_ic(0.005), KEY)
    assert abs(small - p_true) < 0.01
    _, big = _var_sigma(_ic(0.10), ctr_rng.fold_in(KEY, 1))
    assert big > p_true + 0.05


def _variance_log_multiplier_exact_without_noise():
    p = tvar.log_multiplier(KEY, 400, 700, CFG.conv, 0.0, device="cpu")
    np.testing.assert_allclose(float(p), (400 / 1024) * (700 / 1024),
                               rtol=1e-5)


def _variance_mul_uncertainty_metric():
    p = torch.tensor([0.1, 0.2, 0.3])
    assert float(tvar.mul_uncertainty(p, p)) == 0.0
    s = float(tvar.mul_uncertainty(p, torch.tensor([0.2, 0.2, 0.2])))
    assert s == pytest.approx(float(np.std(p.numpy() - 0.2)))


def _physics_operating_point_collapses_to_exp():
    tau = torch.linspace(0.01, 5.0, 64)
    np.testing.assert_allclose(tphys.p_unswitched(tau, tphys.I_C_UA).numpy(),
                               np.exp(-tau.numpy()), rtol=1e-6)


def _physics_preset_pulse_switches_deterministically():
    p = tphys.p_unswitched(tphys.PRESET_TAU_NS,
                           tphys.I_C_UA * tphys.PRESET_I_FACTOR)
    assert float(p) < 1e-26


def _physics_two_pulse_and_equals_product():
    pa = tphys.p_unswitched(0.3, tphys.I_C_UA)
    pb = tphys.p_unswitched(0.4, tphys.I_C_UA)
    pab = tphys.p_unswitched(0.3 + 0.4, tphys.I_C_UA)
    np.testing.assert_allclose(float(pa * pb), float(pab), rtol=1e-6)


def _physics_scale_to_half_switching_targets_half():
    tau = torch.tensor([0.1, 0.2, 0.3, 0.4])
    scale, scaled = tphys.scale_to_half_switching(tau)
    np.testing.assert_allclose(float(torch.exp(-scaled.mean())), 0.5,
                               rtol=1e-6)
    np.testing.assert_allclose(scaled.numpy(), (tau * scale).numpy())


def _physics_switching_energy_scales_with_tau_and_current():
    e1 = float(tphys.switching_energy_aj(1.0, 80.0))
    np.testing.assert_allclose(float(tphys.switching_energy_aj(2.0, 80.0)),
                               2 * e1, rtol=1e-6)
    np.testing.assert_allclose(float(tphys.switching_energy_aj(1.0, 160.0)),
                               4 * e1, rtol=1e-6)


def _physics_monotone_on_dense_grids():
    tau = torch.linspace(1e-3, 16.0, 512)
    for i_ua in (40.0, tphys.I_C_UA, tphys.I_C_UA * 1.25):
        p = tphys.p_unswitched(tau, i_ua).numpy()
        assert np.all(np.diff(p) <= 1e-12) and np.all((p >= 0) & (p <= 1))
    i = torch.linspace(40.0, 120.0, 512)
    for t in (0.01, 0.5, tphys.PRESET_TAU_NS):
        assert np.all(np.diff(tphys.p_unswitched(t, i).numpy()) <= 1e-12)


def _physics_per_cell_ic_array_broadcasts():
    p = tphys.p_unswitched(0.5, 80.0, i_c_ua=torch.tensor([70.0, 80.0, 90.0]))
    assert p.shape == (3,) and float(p[2]) > float(p[1]) > float(p[0])


REFERENCE_CASES = {
    name: fn for name, fn in globals().items()
    if name.startswith(("_engine_", "_variance_", "_physics_"))
}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_reference_assertions_hold_on_the_port(case):
    REFERENCE_CASES[case]()
