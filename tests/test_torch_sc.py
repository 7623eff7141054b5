"""PyTorch port vs JAX reference: the bit-exact SC substrate.

The same numpy-seeded inputs go through ``repro`` and ``repro_torch``;
everything here is held BIT-exact — the Threefry stream, the key chain
(``PRNGKey`` / ``fold_in`` / ``split`` / ``fold_keys``), the operand
encoding, the Horner ladder and pop-count, the fused SC matmul totals
(against the Pallas kernel in interpret mode) and the ``pallas_fused``
backends' float outputs.  On the CPU every port wrapper runs its
kernel's plain PyTorch version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sc as jsc
from repro.kernels import ref as jref
from repro.kernels import sc_fused as jfused
from repro.kernels import sc_mul as jmul
from repro.models import layers as jlayers
from repro.sc import ctr_rng as jrng
from repro.sc import encoding as jenc
from repro_torch import sc as tsc
from repro_torch.kernels import sc_fused as tfused
from repro_torch.kernels import sc_mul as tmul
from repro_torch.models import layers as tlayers
from repro_torch.sc import ctr_rng as trng
from repro_torch.sc import encoding as tenc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel worker processes; torch's intra-op
    thread pool would oversubscribe the cores the JAX reference runs on
    (the plain versions' small ops run no slower on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_NBIT = 64  # 2 packed words per product: fast but fully exercised


def _u32(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Threefry and the key chain
# ---------------------------------------------------------------------------


def test_threefry_matches_reference_on_random_words():
    rng = np.random.default_rng(0)
    k0, k1, c0, c1 = (_u32(rng, (257,)) for _ in range(4))
    want = jrng.threefry2x32(k0, k1, c0, c1)
    got = trng.threefry2x32(_t(k0), _t(k1), _t(c0), _t(c1))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_key_chain_matches_jax_random(seed):
    jkey = jax.random.PRNGKey(seed)
    tkey = trng.prng_key(seed)
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(jkey))
    for d in (0, 1, 29, 0x5EED, 2**32 - 1):
        want = jax.random.fold_in(jkey, d)
        np.testing.assert_array_equal(
            trng.fold_in(tkey, d).numpy(), np.asarray(want)
        )
    np.testing.assert_array_equal(
        trng.split(tkey, 5).numpy(), np.asarray(jax.random.split(jkey, 5))
    )


def test_fold_keys_broadcasts_like_the_reference():
    rng = np.random.default_rng(1)
    keys = _u32(rng, (3, 4, 2))
    pos = rng.integers(0, 1000, (3, 4)).astype(np.int32)
    for data in (13, pos):
        want = jlayers.fold_keys(jnp.asarray(keys), jnp.asarray(data))
        got = tlayers.fold_keys(_t(keys), _t(data) if data is pos else data)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tlayers.fold_keys(None, 3) is None
    for site in ("mlp_wo", "unembed", "mlp_wi"):
        want = jlayers.site_key(jnp.asarray(keys), site)
        got = tlayers.site_key(_t(keys), site)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_operand_stream_matches_reference():
    key = _u32(np.random.default_rng(2), (2,))
    want = jrng.operand_stream(jnp.asarray(key), 5, 3)
    got = trng.operand_stream(_t(key), 5, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------


def _probe_values():
    """Exact half-way ties of the 10-bit and 16-bit grids, p = 1.0, 0,
    and random values."""
    ties = (np.arange(0, 1024) + 0.5) / 1024
    fx_ties = (np.arange(0, 4096, 7) + 0.5) / 65536
    rnd = np.random.default_rng(3).uniform(0, 1, 500)
    vals = np.concatenate([ties, fx_ties, rnd, [0.0, 1.0, 1 - 2**-11]])
    return vals.astype(np.float32)


@pytest.mark.parametrize("levels", [16, 1024])
def test_quantize_grid_and_fx16_bit_exact(levels):
    p = _probe_values()
    want_q = np.asarray(jenc.quantize_grid(jnp.asarray(p), levels))
    got_q = tenc.quantize_grid(_t(p), levels).numpy()
    np.testing.assert_array_equal(got_q, want_q)
    for v in (p, want_q):
        want = np.asarray(jenc.to_fx16(jnp.asarray(v)))
        np.testing.assert_array_equal(tenc.to_fx16(_t(v)).numpy(), want)
    assert int(tenc.to_fx16(torch.tensor([1.0]))[0]) == 65535
    w = tenc.to_fx16(_t(p))
    np.testing.assert_array_equal(
        tenc.from_fx16(w).numpy(),
        np.asarray(jenc.from_fx16(jnp.asarray(w.numpy(), jnp.uint32))),
    )


def test_encode_matches_reference():
    v = np.random.default_rng(4).normal(size=(7, 9)).astype(np.float32)
    cfg = jsc.ScConfig(operand_bits=10)
    js, jp, jscale = jenc.encode(jnp.asarray(v), cfg)
    ts, tp, tscale = tenc.encode(_t(v), tsc.ScConfig(operand_bits=10))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert float(tscale) == float(jscale)
    padded = tenc.pad_to(_t(v), 4, 1)
    np.testing.assert_array_equal(
        padded.numpy(), np.asarray(jenc.pad_to(jnp.asarray(v), 4, 1))
    )


def test_bernoulli_words_and_popcount_match_ref_oracles():
    rng = np.random.default_rng(5)
    p = rng.integers(0, 65536, (6,)).astype(np.uint32)
    u = _u32(rng, (6, tmul.NSLICES, 3))
    want = jref.bernoulli_words_ref(jnp.asarray(p), jnp.asarray(u))
    got = tmul.bernoulli_words(_t(p).long()[:, None], _t(u).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    v = _u32(rng, (300,))
    np.testing.assert_array_equal(
        tmul.popcount32(_t(v).long()).numpy(),
        np.asarray(jref.popcount32_ref(jnp.asarray(v))),
    )
    assert tmul.LANE_BITS == jmul.LANE_BITS
    assert tmul.NSLICES == jmul.NSLICES


# ---------------------------------------------------------------------------
# The fused SC matmul kernel (plain version vs the Pallas kernel)
# ---------------------------------------------------------------------------


def _jax_fused(keys, x, w, *, k_orig, n_orig, **kw):
    """The Pallas kernel on block-padded operands, as the JAX backends
    call it (padding is inert; the counters use k_orig / n_orig)."""
    x = jenc.pad_to(jenc.pad_to(jnp.asarray(x), 8, 0), 8, 1)
    w = jenc.pad_to(jenc.pad_to(jnp.asarray(w), 8, 0), 8, 1)
    keys = jenc.pad_to(jnp.asarray(keys), 8, 0)
    out = jfused.sc_fused_popcount(
        keys, x, w, k_orig=k_orig, n_orig=n_orig, block_m=8, block_n=8,
        block_k=8, **kw
    )
    return np.asarray(out)[: x.shape[0], : w.shape[1]]


@pytest.mark.parametrize(
    "m,k,n,operand_bits,row_keys",
    [(3, 13, 11, 10, True), (2, 9, 5, 4, False)],
)
def test_sc_fused_totals_bit_exact(m, k, n, operand_bits, row_keys):
    rng = np.random.default_rng(m * 100 + k)
    keys = _u32(rng, (m, 4))
    if not row_keys:
        keys[:] = keys[0]
    x = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    w = rng.uniform(-1, 1, (k, n)).astype(np.float32)
    x[0, 0] = 0.0  # sign 0 contributes nothing
    w[1, 0] = 1.0  # p = 1 clamps to the top grid level
    kw = dict(
        k_orig=k,
        n_orig=n,
        nbit=_NBIT,
        levels=1 << operand_bits,
        row_keys=row_keys,
    )
    want = _jax_fused(keys, x, w, **kw)[:m, :n]
    got = tfused.sc_fused_popcount(_t(keys), _t(x), _t(w), **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_sc_fused_column_window_keeps_full_width_counters():
    """A window ``w[:, a:b]`` called with the full ``n_orig`` draws from
    the full-width counter layout (what a vocab-sharded unembed needs)."""
    rng = np.random.default_rng(9)
    m, k, n_full = 2, 10, 40
    keys = _u32(rng, (m, 4))
    x = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    w = rng.uniform(-1, 1, (k, n_full)).astype(np.float32)
    win = np.ascontiguousarray(w[:, 13:29])
    kw = dict(k_orig=k, n_orig=n_full, nbit=_NBIT, levels=1024)
    want = _jax_fused(keys, x, win, row_keys=True, **kw)[:m, :16]
    got = tfused.sc_fused_popcount(
        _t(keys), _t(x), _t(win), row_keys=True, **kw
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_sc_fused_wrapper_rejects_bad_inputs():
    keys = torch.zeros((2, 4), dtype=torch.uint32)
    x, w = torch.zeros((2, 3)), torch.zeros((3, 4))
    kw = dict(k_orig=3, n_orig=4, levels=1024)
    with pytest.raises(ValueError, match="32 cells"):
        tfused.sc_fused_popcount(keys, x, w, nbit=48, **kw)
    with pytest.raises(ValueError, match="uint32"):
        tfused.sc_fused_popcount(keys.long(), x, w, nbit=64, **kw)
    with pytest.raises(ValueError, match="float32"):
        tfused.sc_fused_popcount(keys, x.double(), w, nbit=64, **kw)
    with pytest.raises(ValueError, match="k_orig"):
        tfused.sc_fused_popcount(
            keys, x, w, nbit=64, k_orig=3, n_orig=2, levels=1024
        )


# ---------------------------------------------------------------------------
# Backends and registry
# ---------------------------------------------------------------------------


def test_pallas_fused_backends_float_outputs_bit_exact():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(3, 12)).astype(np.float32)
    w = rng.normal(size=(12, 7)).astype(np.float32)
    jcfg = jsc.ScConfig(backend="pallas_fused", nbit=_NBIT)
    tcfg = tsc.ScConfig(backend="pallas_fused", nbit=_NBIT)
    jkey = jax.random.PRNGKey(5)
    want = jsc.sc_dot(jkey, jnp.asarray(x), jnp.asarray(w), jcfg)
    got = tsc.sc_dot(trng.prng_key(5), _t(x), _t(w), tcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    keys = np.asarray(jax.random.split(jkey, 3))
    want = jsc.sc_dot_rows(
        jnp.asarray(keys), jnp.asarray(x), jnp.asarray(w), jcfg
    )
    got = tsc.sc_dot_rows(_t(keys), _t(x), _t(w), tcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # rows mode == single-row per-call calls, in the port too
    one = tsc.sc_dot(_t(keys[1]), _t(x[1:2]), _t(w), tcfg)
    np.testing.assert_array_equal(one.numpy(), got.numpy()[1:2])


def test_registry_upgrades_and_refuses_unported_backends():
    assert tsc.fast_backend("pallas_bitexact", 1024) == "pallas_fused"
    assert tsc.fast_backend("pallas_bitexact", 48) == "pallas_bitexact"
    assert tsc.fast_backend("exact") == "exact"
    # every backend of the reference is ported: none is refused
    assert set(tsc.available_backends()) == set(jsc.available_backends())
    x, w = torch.ones((2, 3)), torch.ones((3, 2))
    for name in ("pallas_bitexact", "bitexact", "array"):
        y = tsc.sc_dot(trng.prng_key(0), x, w, tsc.ScConfig(backend=name))
        assert y.shape == (2, 2) and bool(torch.isfinite(y).all())
    with pytest.raises(ValueError, match="unknown"):
        tsc.get_backend("nope")
    y = tsc.sc_dot(None, x, w, tsc.ScConfig())
    np.testing.assert_array_equal(y.numpy(), np.full((2, 2), 3.0))
