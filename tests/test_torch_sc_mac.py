"""PyTorch port vs JAX reference: the moment SC substrate.

The same numpy-seeded inputs go through ``repro`` and ``repro_torch``:

* the samplers: ``random_bits`` / ``uniform`` / ``bernoulli`` /
  ``randint`` BIT-equal to ``jax.random``'s, ``normal`` within 2e-5
  (``torch.erfinv`` against XLA's ``erf_inv`` in the tails);
* kernel 5 (``sc_mac_fused``; on the CPU its plain version) against the
  Pallas kernel in interpret mode on the same noise, within 1e-5 of
  max |out| (float32 sums in another order);
* kernel 6's Box-Muller against the reference's on the same words
  (1e-6), and its noise statistics;
* the ``moment`` and ``pallas_moment`` backends under one key, within
  1e-5 of max |out|, including widths whose noise follows the padded
  counter rule;
* the straight-through gradient of ``sc_dot`` against ``jax.grad``
  (1e-5 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sc as jsc
from repro.kernels import sc_mac as jmac
from repro.sc import encoding as jenc
from repro_torch import sc as tsc
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import sc_mac as tmac
from repro_torch.sc import ctr_rng as trng


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel worker processes; torch's intra-op
    thread pool would oversubscribe the cores the JAX reference runs on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(seed, fold=None):
    k = jax.random.PRNGKey(seed)
    if fold is not None:
        k = jax.random.fold_in(k, fold)
    return k, torch.from_numpy(np.asarray(k).astype(np.int64))


def _rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------

SHAPES = [(1,), (7,), (37, 300), (2, 3, 5)]


@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits_bit_equal_jax(shape):
    jk, tk = _key(5, 3)
    want = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
    got = trng.random_bits(tk, shape).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_bernoulli_randint_bit_equal_jax(shape):
    jk, tk = _key(11, 2)
    want = np.asarray(jax.random.uniform(jk, shape, jnp.float32, 1e-6, 1.0))
    np.testing.assert_array_equal(trng.uniform(tk, shape, 1e-6).numpy(), want)
    want = np.asarray(jax.random.bernoulli(jk, 0.5, shape))
    np.testing.assert_array_equal(trng.bernoulli(tk, 0.5, shape).numpy(), want)
    want = np.asarray(jax.random.randint(jk, shape, 0, 16))
    np.testing.assert_array_equal(trng.randint(tk, shape, 0, 16).numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_normal_matches_jax(shape):
    jk, tk = _key(0, 7)
    want = np.asarray(jax.random.normal(jk, shape, jnp.float32))
    got = trng.normal(tk, shape).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_normal_is_a_pure_function_of_the_key():
    _, tk = _key(3)
    torch.manual_seed(0)
    a = trng.normal(tk, (4, 9))
    torch.manual_seed(1)
    torch.randn(100)
    np.testing.assert_array_equal(trng.normal(tk, (4, 9)).numpy(), a.numpy())


# ---------------------------------------------------------------------------
# Kernel 5: sc_mac_fused
# ---------------------------------------------------------------------------


def _operands(rng, m, k, n):
    x = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    w = rng.uniform(-1, 1, (k, n)).astype(np.float32)
    noise = rng.standard_normal((m, n)).astype(np.float32)
    return x, w, noise


def _pallas(x, w, noise, nbit):
    """The Pallas kernel in interpret mode on shapes padded to its tiles
    (zero padding is inert in all three sums)."""
    m, k = x.shape
    n = w.shape[1]
    bm, bn, bk = max(1, min(128, m)), max(1, min(128, n)), min(512, k)
    xs = jenc.pad_to(jenc.pad_to(jnp.asarray(x), bm, 0), bk, 1)
    ws = jenc.pad_to(jenc.pad_to(jnp.asarray(w), bk, 0), bn, 1)
    nz = jenc.pad_to(jenc.pad_to(jnp.asarray(noise), bm, 0), bn, 1)
    out = jmac.sc_mac_fused(xs, ws, nz, nbit=nbit, interpret=True)
    return np.asarray(out)[:m, :n]


@pytest.mark.parametrize(
    "m,k,n,nbit",
    [(16, 64, 128, 1024), (5, 37, 300, 256), (130, 520, 7, 64)],
)
def test_sc_mac_plain_matches_pallas_kernel(m, k, n, nbit):
    x, w, noise = _operands(np.random.default_rng(m + n), m, k, n)
    want = _pallas(x, w, noise, nbit)
    before = dict(cuda_lib.launches)
    got = tmac.sc_mac_fused(
        torch.tensor(x), torch.tensor(w), torch.tensor(noise), nbit=nbit
    )
    assert dict(cuda_lib.launches) == before  # CPU tensors: plain version
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert _rel_err(got, want) <= 1e-5


def test_sc_mac_wrappers_validate_their_inputs():
    x, w = torch.zeros(4, 8), torch.zeros(8, 5)
    with pytest.raises(ValueError, match="noise"):
        tmac.sc_mac_fused(x, w, torch.zeros(5, 4))
    with pytest.raises(ValueError, match="float32"):
        tmac.sc_mac_fused(x.double(), w, torch.zeros(4, 5))
    with pytest.raises(ValueError, match="@"):
        tmac.sc_mac_fused_prng(0, x, torch.zeros(7, 5))


# ---------------------------------------------------------------------------
# Kernel 6: sc_mac_fused_prng
# ---------------------------------------------------------------------------


def test_box_muller_matches_reference_on_the_same_words():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    a[:3] = [0, 255, 2**32 - 1]  # the u1 clamp and both ends
    want = np.asarray(jmac._box_muller(jnp.asarray(a), jnp.asarray(b)))
    got = tmac._box_muller(
        torch.from_numpy(a.astype(np.int64)),
        torch.from_numpy(b.astype(np.int64)),
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_prng_noise_is_standard_normal():
    z = tmac.prng_noise(1234, 256, 512).double()
    assert abs(float(z.mean())) < 0.01
    assert abs(float(z.var()) - 1.0) < 0.02
    # the draw is per element, not per tile: a sub-block is a prefix
    np.testing.assert_array_equal(
        tmac.prng_noise(1234, 1, 512).numpy(), z[:1].float().numpy()
    )


def test_sc_mac_prng_plain_has_kernel5_accumulators_and_unit_noise():
    rng = np.random.default_rng(9)
    m, k, n, nbit = 64, 96, 200, 256
    x, w, _ = _operands(rng, m, k, n)
    xt, wt = torch.tensor(x), torch.tensor(w)
    seed = torch.tensor([77], dtype=torch.int32)
    got = tmac.sc_mac_fused_prng(seed, xt, wt, nbit=nbit)
    # with the noise set to zero kernel 5 gives the mean; the noise it
    # drew is (out - mean) / sd, and must be standard normal
    mean = _pallas(x, w, np.zeros((m, n), np.float32), nbit)
    sd = np.sqrt(
        np.maximum(np.abs(x) @ np.abs(w) - (x * x) @ (w * w), 0) / nbit
    )
    z = (got.numpy() - mean) / sd
    assert abs(z.mean()) < 0.03 and abs(z.var() - 1.0) < 0.05
    want = tmac.sc_mac_fused_plain(
        xt, wt, tmac.prng_noise(77, m, n), nbit=nbit
    )
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# Backends and the straight-through gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["moment", "pallas_moment"])
@pytest.mark.parametrize("m,k,n", [(8, 64, 96), (6, 40, 300), (3, 16, 256)])
def test_moment_backends_match_reference(backend, m, k, n):
    rng = np.random.default_rng(k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.1).astype(np.float32)
    jk, tk = _key(21, m)
    want = jsc.sc_dot(jk, jnp.asarray(x), jnp.asarray(w),
                      jsc.ScConfig(backend=backend, nbit=256))
    got = tsc.sc_dot(tk, torch.tensor(x), torch.tensor(w),
                     tsc.ScConfig(backend=backend, nbit=256))
    assert _rel_err(got, want) <= 1e-5
    # the noise is there: the draw moves the output off the exact product
    assert _rel_err(got, x @ w) > 1e-3


def test_pallas_moment_noise_follows_the_padded_counter_rule():
    """N = 300 pads to 384 in the reference: row 1 reads the draw at flat
    index 384 + j, not 300 + j."""
    m, n = 3, 300
    _, tk = _key(2)
    from repro_torch.sc import backends

    # the port's constant is the reference's default tile
    assert backends._REF_BLOCK_N == jsc.ScConfig().block_n
    got = backends._moment_noise(tk, m, n, "cpu")
    full = trng.normal(tk, (m, 384))
    np.testing.assert_array_equal(got.numpy(), full[:, :n].numpy())
    flat = trng.normal(tk, (m, n))
    assert not torch.equal(got[1], flat[1])


@pytest.mark.parametrize("backend", ["exact", "pallas_moment"])
def test_sc_dot_straight_through_gradient_matches_jax(backend):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 24)).astype(np.float32)
    w = (rng.normal(size=(24, 140)) * 0.2).astype(np.float32)
    g = rng.normal(size=(2, 5, 140)).astype(np.float32)
    jk, tk = _key(8)
    jcfg = jsc.ScConfig(backend=backend, nbit=128)

    def jloss(xx, ww):
        return jnp.sum(jsc.sc_dot(jk, xx, ww, jcfg) * g)

    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    tcfg = tsc.ScConfig(backend=backend, nbit=128)
    (tsc.sc_dot(tk, xt, wt, tcfg) * torch.tensor(g)).sum().backward()
    assert _rel_err(xt.grad, jgx) <= 1e-5
    assert _rel_err(wt.grad, jgw) <= 1e-5
    # rows entry point: same jacobian, no gradient to the keys
    keys = trng.split(tk, 10).reshape(2, 5, 2)
    xr = torch.tensor(x, requires_grad=True)
    wr = torch.tensor(w, requires_grad=True)
    (tsc.sc_dot_rows(keys, xr, wr, tcfg) * torch.tensor(g)).sum().backward()
    assert _rel_err(xr.grad, jgx) <= 1e-5
    assert _rel_err(wr.grad, jgw) <= 1e-5
