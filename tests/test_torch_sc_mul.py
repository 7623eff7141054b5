"""PyTorch port vs JAX reference: the packed bit-exact SC MUL engine
(``kernels/sc_mul.py``, CUDA ``csrc/sc_mul.cu``) and the two backends
built on it.

Bit for bit: the kernel's plain version against the Pallas kernel
(interpret mode) and its oracle ``sc_mul_popcount_ref``;
``sc_mul_bitexact`` and the ``pallas_bitexact`` backend against the
reference's; ``pallas_bitexact`` against the port's own ``pallas_fused``
under one key.  Statistically: ``bitexact``, whose
``jax.random.binomial`` stream the port does not reproduce (it draws
``torch.binomial`` from a generator seeded with the key).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sc as jsc
from repro.kernels import ref as jref
from repro.kernels import sc_mul as jmul
from repro.sc import ctr_rng as jrng
from repro.sc import encoding as jenc
from repro_torch import sc as tsc
from repro_torch.kernels import sc_mul as tmul
from repro_torch.sc import backends as tbackends
from repro_torch.sc import ctr_rng as trng


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel worker processes; keep torch's
    intra-op pool from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u32(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _biases(rng, m):
    """fx16 words with the edges: 0, the 65535 clamp of p = 1.0 (the
    encoding's own clamp), a lone high bit, and random words."""
    edges = np.asarray(
        jenc.to_fx16(jnp.asarray([0.0, 1.0, 0.5, 2**-16], jnp.float32))
    )
    assert list(edges[:2]) == [0, 65535]
    words = rng.integers(0, 65536, m).astype(np.uint32)
    words[: min(m, 4)] = edges[: min(m, 4)]
    return words


@pytest.mark.parametrize("m,w", [(13, 1), (9, 4), (5, 32), (1, 4), (16, 2)])
def test_sc_mul_popcount_plain_bit_equals_reference(m, w):
    rng = np.random.default_rng(m * 31 + w)
    px, py = _biases(rng, m), _biases(rng, m)[::-1].copy()
    rx, ry = _u32(rng, (m, 16, w)), _u32(rng, (m, 16, w))
    got = tmul.sc_mul_popcount(*(_t(a) for a in (px, py, rx, ry)))
    assert got.dtype == torch.int32 and got.shape == (m,)
    assert torch.equal(got, tmul.sc_mul_popcount_plain(
        *(_t(a) for a in (px, py, rx, ry))))
    oracle = jref.sc_mul_popcount_ref(*(jnp.asarray(a)
                                        for a in (px, py, rx, ry)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(oracle))
    # the Pallas kernel takes whole 8-row blocks: pad, then cut
    mp = -(-m // 8) * 8
    pad = [(0, mp - m)]
    kern = jmul.sc_mul_popcount(
        jnp.asarray(np.pad(px, pad)), jnp.asarray(np.pad(py, pad)),
        jnp.asarray(np.pad(rx, pad + [(0, 0), (0, 0)])),
        jnp.asarray(np.pad(ry, pad + [(0, 0), (0, 0)])))
    np.testing.assert_array_equal(got.numpy(), np.asarray(kern)[:m])


def test_sc_mul_popcount_edges_count_exactly():
    """p = 0 survives nowhere; the all-ones bias keeps every cell whose
    words are all ones, and the ladder of the 65535 clamp keeps a cell
    unless all 16 of its slice bits are 0."""
    m, w = 3, 2
    ones = np.full((m, 16, w), 0xFFFFFFFF, np.uint32)
    zero = np.zeros((m, 16, w), np.uint32)
    px = np.array([0, 65535, 65535], np.uint32)
    py = np.array([65535, 65535, 65535], np.uint32)
    got = tmul.sc_mul_popcount(_t(px), _t(py), _t(ones), _t(ones))
    np.testing.assert_array_equal(got.numpy(), [0, 64, 64])
    got = tmul.sc_mul_popcount(_t(px), _t(py), _t(zero), _t(ones))
    np.testing.assert_array_equal(got.numpy(), [0, 0, 0])


def test_sc_mul_popcount_rejects_what_the_kernel_does_not_take():
    px = torch.zeros(4, dtype=torch.uint32)
    r = torch.zeros((4, 16, 2), dtype=torch.uint32)
    with pytest.raises(ValueError, match="uint32"):
        tmul.sc_mul_popcount(px.to(torch.int64), px, r, r)
    with pytest.raises(ValueError, match="16"):
        tmul.sc_mul_popcount(px, px, r[:, :8], r[:, :8])
    with pytest.raises(ValueError, match="one shape"):
        tmul.sc_mul_popcount(px, px, r, r[:, :, :1])
    with pytest.raises(ValueError, match=r"\(M,\)"):
        tmul.sc_mul_popcount(px[:3], px, r, r)


@pytest.mark.parametrize("m,nbit", [(37, 128), (8, 32), (3, 1024)])
def test_sc_mul_bitexact_bit_equals_reference(m, nbit):
    rng = np.random.default_rng(m + nbit)
    p1 = rng.uniform(0, 1, m).astype(np.float32)
    p2 = rng.uniform(0, 1, m).astype(np.float32)
    p1[0], p2[-1] = 1.0, 0.0
    want = jmul.sc_mul_bitexact(jax.random.PRNGKey(4), jnp.asarray(p1),
                                jnp.asarray(p2), nbit=nbit)
    got = tmul.sc_mul_bitexact(trng.prng_key(4), _t(p1), _t(p2), nbit=nbit)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("start", [0, 7, 2**32 - 3])
def test_operand_stream_walks_in_chunks(start):
    """The packed backend draws its stream a chunk of products at a time:
    the words of products [start, start + n) equal that slice of one
    long draw (the counter wraps mod 2^32, as the reference's uint32
    arange does)."""
    key = _u32(np.random.default_rng(5), (2,))
    got = trng.operand_stream(_t(key), 6, 3, start)
    c0 = (np.arange(6, dtype=np.uint64) + start) % 2**32
    c0 = jnp.asarray(c0.astype(np.uint32))[:, None, None]
    _, c1 = jrng.product_counters(1, 3)
    want = jrng.uniform_words(jnp.asarray(key), c0, c1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if start == 0:
        full = jrng.operand_stream(jnp.asarray(key), 6, 3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(full))


@pytest.mark.parametrize(
    "m,k,n,nbit", [(3, 9, 5, 64), (1, 17, 3, 32), (2, 5, 1, 96)]
)
def test_pallas_bitexact_bit_equals_reference_and_fused(m, k, n, nbit):
    rng = np.random.default_rng(m * k * n)
    x = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    w = rng.uniform(-1, 1, (k, n)).astype(np.float32)
    x[0, 0] = 0.0  # a zero operand: sign 0, fx16 0
    jcfg = jsc.ScConfig(backend="pallas_bitexact", nbit=nbit)
    tcfg = tsc.ScConfig(backend="pallas_bitexact", nbit=nbit)
    want = jsc.sc_dot(jax.random.PRNGKey(7), jnp.asarray(x), jnp.asarray(w),
                      jcfg)
    got = tsc.sc_dot(trng.prng_key(7), _t(x), _t(w), tcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fused = tsc.sc_dot(trng.prng_key(7), _t(x), _t(w),
                       tcfg.replace(backend="pallas_fused"))
    np.testing.assert_array_equal(got.numpy(), fused.numpy())


def test_pallas_bitexact_chunks_change_no_count(monkeypatch):
    rng = np.random.default_rng(11)
    x = _t(rng.uniform(-1, 1, (2, 7)).astype(np.float32))
    w = _t(rng.uniform(-1, 1, (7, 3)).astype(np.float32))
    cfg = tsc.ScConfig(backend="pallas_bitexact", nbit=64)
    whole = tsc.sc_dot(trng.prng_key(3), x, w, cfg)
    calls = []
    real = tmul.sc_mul_popcount

    def spy(*a):
        calls.append(a[0].shape[0])
        return real(*a)

    # 5 products per step: 42 products walk in 9 chunks
    monkeypatch.setattr(tbackends, "_STREAM_WORDS", 16 * 2 * 5)
    monkeypatch.setattr(tmul, "sc_mul_popcount", spy)
    chunked = tsc.sc_dot(trng.prng_key(3), x, w, cfg)
    assert calls == [5] * 8 + [2]
    assert torch.equal(whole, chunked)


def test_pallas_bitexact_rejects_partial_words():
    x, w = torch.ones((1, 2)), torch.ones((2, 1))
    with pytest.raises(ValueError, match="multiple of 32"):
        tsc.sc_dot(trng.prng_key(0), x, w,
                   tsc.ScConfig(backend="pallas_bitexact", nbit=48))


def test_bitexact_estimates_have_the_binomial_law():
    """Each product's estimate is count/nbit with count ~ Binomial(nbit,
    p): over 2^14 products the standardized errors have mean 0 (within
    4 sigma of the mean of 2^14 draws) and variance 1 (within 10 %)."""
    rng = np.random.default_rng(12)
    nbit = 256
    # K = 1: the output IS one product's signed estimate times the scales
    x = rng.uniform(0.05, 1, (128, 1)).astype(np.float32)
    w = rng.uniform(0.05, 1, (1, 128)).astype(np.float32)
    cfg = tsc.ScConfig(backend="bitexact", nbit=nbit)
    y = tsc.sc_dot(trng.prng_key(21), _t(x), _t(w), cfg).double().numpy()
    _, px, scx = jenc.encode(jnp.asarray(x), jsc.ScConfig(nbit=nbit))
    _, pw, scw = jenc.encode(jnp.asarray(w), jsc.ScConfig(nbit=nbit))
    p = (np.asarray(px, np.float64) @ np.asarray(pw, np.float64))
    est = y / (float(scx) * float(scw))
    z = (est - p) / np.sqrt(p * (1 - p) / nbit)
    assert z.size == 2**14
    assert abs(z.mean()) < 4 / np.sqrt(z.size)
    assert abs(z.var() - 1.0) < 0.10
    # the counts are whole: est * nbit is an integer
    np.testing.assert_allclose(est * nbit, np.round(est * nbit), atol=2e-3)


def test_bitexact_is_a_function_of_the_key():
    rng = np.random.default_rng(13)
    x = _t(rng.uniform(-1, 1, (3, 8)).astype(np.float32))
    w = _t(rng.uniform(-1, 1, (8, 4)).astype(np.float32))
    cfg = tsc.ScConfig(backend="bitexact", nbit=64)
    a = tsc.sc_dot(trng.prng_key(5), x, w, cfg)
    assert torch.equal(a, tsc.sc_dot(trng.prng_key(5), x, w, cfg))
    assert not torch.equal(a, tsc.sc_dot(trng.prng_key(6), x, w, cfg))


def test_indexed_draws_equal_the_whole_draw():
    """``bits_at`` / ``normal_at`` read single elements of a draw: the
    large device branch walks its noise column chunk by column chunk."""
    key = trng.prng_key(9)
    shape = (3, 5, 7)
    idx = torch.tensor([0, 4, 33, 104], dtype=torch.int64)
    full = trng.random_bits(key, shape).reshape(-1)
    assert torch.equal(trng.bits_at(key, idx), full[idx])
    normal = trng.normal(key, shape).reshape(-1)
    assert torch.equal(trng.normal_at(key, idx), normal[idx])
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(9), shape))
    np.testing.assert_allclose(trng.normal_at(key, idx).numpy(),
                               want.reshape(-1)[idx.numpy()], atol=2e-5)
