"""PyTorch port vs JAX reference: the moment SC substrate.

The same numpy-seeded inputs go through ``repro`` and ``repro_torch``:

* the samplers: ``random_bits`` / ``uniform`` / ``bernoulli`` /
  ``randint`` BIT-equal to ``jax.random``'s, ``normal`` within 2e-5
  (``torch.erfinv`` against XLA's ``erf_inv`` in the tails);
* kernel 5 (``sc_mac_fused``; on the CPU its plain version) against the
  Pallas kernel in interpret mode on the same noise, within 1e-5 of
  max |out| (float32 sums in another order);
* the card kernel's 3xTF32 arithmetic emulated in numpy (TF32
  round-to-nearest-away on the int32 bit view, float32 sums) within
  1e-5 of max |out| of the plain version and of the Pallas kernel, on
  and off the operand grid, at K = 4864 and where p - p2 cancels; its
  split-K plan, split-order reduction and TMA padding;
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
# Kernel 5 on the tensor cores: the 3xTF32 split, the split-K plan, padding
# ---------------------------------------------------------------------------


def _tf32_rna(v):
    """cvt.rna.tf32.f32 on the int32 bit view: add half of the 13 dropped
    bits' unit to the magnitude, then clear them (round to nearest, ties
    away from zero; the sign bit is untouched)."""
    b = np.asarray(v, np.float32).view(np.int32)
    return ((b + 0x1000) & ~0x1FFF).astype(np.int32).view(np.float32)


def _tf32_trunc(v):
    """What a TF32 MMA does to raw float32: drop the 13 low bits."""
    b = np.asarray(v, np.float32).view(np.int32)
    return (b & ~0x1FFF).astype(np.int32).view(np.float32)


def _dot3(a, b, on_grid_ab):
    """hi.hi + hi.lo + lo.hi of one sum with float32 accumulation; the lo
    parts of operands exact in TF32 are zero and their products skipped,
    as the kernel's ``on_grid`` route does."""
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
    out = ah @ bh
    if not on_grid_ab:
        out = out + ah @ bl + al @ bh
    return out.astype(np.float32)


def _sc_mac_tf32x3(x, w, noise, nbit, on_grid):
    """The kernel's arithmetic in numpy: every operand split into TF32
    hi + lo, float32 sums, then the moment epilogue."""
    x, w = x.astype(np.float32), w.astype(np.float32)
    mean = _dot3(x, w, on_grid)
    p = _dot3(np.abs(x), np.abs(w), on_grid)
    p2 = _dot3(x * x, w * w, False)
    var = np.maximum(p - p2, 0).astype(np.float32) * np.float32(1.0 / nbit)
    return (mean + noise * np.sqrt(var)).astype(np.float32)


def _grid(rng, shape, levels=1024):
    v = rng.uniform(-1, 1, shape).astype(np.float32)
    return (np.round(v * levels) / levels).astype(np.float32)


def test_tf32_rounding_emulation_is_round_to_nearest_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0**-10)  # TF32's unit at 1.0
    v = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4, 1 + 3 * ulp / 4,
                  0.0, 1023 / 1024], np.float32)
    want = np.array([1 + ulp, -(1 + ulp), one, 1 + ulp, 0.0, 1023 / 1024],
                    np.float32)
    np.testing.assert_array_equal(_tf32_rna(v), want)
    # hi + lo carries 22 significant bits: x^2 on the grid is exact
    q = _grid(np.random.default_rng(0), 4096) ** 2
    np.testing.assert_array_equal(_tf32_rna(q) + _tf32_rna(q - _tf32_rna(q)),
                                  q)


def _cancel_rows(rng, m, k, n):
    """Rows of x at |x| = 1 against w at |w| = 1023/1024: every product
    is 1023/1024, so p - p2 keeps ~10 of p's bits."""
    x = _grid(rng, (m, k))
    x[: m // 2] = np.where(rng.random((m // 2, k)) < 0.5, -1.0, 1.0)
    w = np.where(rng.random((k, n)) < 0.5, -1.0, 1.0).astype(np.float32)
    return x, (w * np.float32(1023 / 1024)).astype(np.float32)


@pytest.mark.parametrize(
    "case,m,k,n",
    [("grid", 16, 96, 40), ("off_grid", 16, 96, 40), ("grid", 8, 4864, 24),
     ("off_grid", 8, 4864, 24), ("cancel", 12, 896, 32)],
)
def test_tf32x3_split_matches_plain_and_pallas(case, m, k, n):
    """Tolerance 1e-5 of max |out| (the kernel's contract) against both
    float32 references: the split's sums differ from float32's by the
    dropped lo.lo terms (2^-22 of a product) and the summation order."""
    rng = np.random.default_rng(k + n)
    nbit = 1024
    if case == "grid":
        x, w = _grid(rng, (m, k)), _grid(rng, (k, n))
    elif case == "off_grid":
        x, w, _ = _operands(rng, m, k, n)
    else:
        x, w = _cancel_rows(rng, m, k, n)
    noise = rng.standard_normal((m, n)).astype(np.float32)
    on_grid = case != "off_grid"
    got = _sc_mac_tf32x3(x, w, noise, nbit, on_grid)
    plain = tmac.sc_mac_fused_plain(
        torch.tensor(x), torch.tensor(w), torch.tensor(noise), nbit=nbit
    )
    assert _rel_err(got, plain) <= 1e-5
    assert _rel_err(got, _pallas(x, w, noise, nbit)) <= 1e-5
    if case == "cancel":
        # the variance that survives the cancellation is the law's:
        # unit noise minus zero noise leaves sqrt(var) (float32 ulps of
        # the mean, ~1e-4 of it, set the tolerance)
        ones, zeros = np.ones_like(noise), np.zeros_like(noise)
        sd = (_sc_mac_tf32x3(x, w, ones, nbit, on_grid)
              - _sc_mac_tf32x3(x, w, zeros, nbit, on_grid))[: m // 2]
        want = np.sqrt(k * (1023 / 1024) * (1 / 1024) / nbit)
        np.testing.assert_allclose(sd, want, rtol=1e-3)


def test_tf32_without_the_split_misses_the_contract():
    """Raw float32 into a TF32 MMA (truncation, one product) is off by
    more than 1e-5 of max |out| off the grid: the split is needed."""
    rng = np.random.default_rng(5)
    x, w, noise = _operands(rng, 16, 896, 40)
    want = tmac.sc_mac_fused_plain(
        torch.tensor(x), torch.tensor(w), torch.tensor(noise), nbit=1024
    )
    mean = _tf32_trunc(x) @ _tf32_trunc(w)
    p = _tf32_trunc(np.abs(x)) @ _tf32_trunc(np.abs(w))
    p2 = _tf32_trunc(x * x) @ _tf32_trunc(w * w)
    got = mean + noise * np.sqrt(np.maximum(p - p2, 0) / 1024)
    assert _rel_err(got, want) > 1e-5


# (name, K, N) of the trainer's moment-kernel calls at M = 512
TRAINER_SHAPES = [("unembed", 896, 151936), ("mlp_wi", 896, 9728),
                  ("mlp_wo", 4864, 896), ("wq", 896, 896), ("wk", 896, 128)]


@pytest.mark.parametrize("name,k,n", TRAINER_SHAPES)
def test_sc_mac_plan_fills_a_wave_and_covers_k(name, k, n):
    m = 512
    splits, kper = tmac.sc_mac_plan(m, n, k)
    tiles = -(-n // tmac.BLOCK_N) * -(-m // tmac.BLOCK_M)
    assert tiles * splits >= tmac.NUM_SMS
    assert kper % tmac.BLOCK_K == 0
    assert kper <= tmac.MAX_STAGES * tmac.BLOCK_K
    assert splits * kper >= k > (splits - 1) * kper
    assert tmac.sc_mac_plan(m, n, k) == (splits, kper)
    if tiles >= tmac.NUM_SMS:
        assert splits == 1  # no workspace where the tiles fill the card


def test_sc_mac_plan_is_a_pure_function_of_the_shape():
    rng = np.random.default_rng(0)
    shapes = [tuple(int(v) for v in rng.integers(1, 5000, 3))
              for _ in range(200)] + [(1, 1, 1), (5, 300, 40), (130, 7, 520)]
    first = [tmac.sc_mac_plan(*s) for s in shapes]
    torch.manual_seed(1)
    assert [tmac.sc_mac_plan(*s) for s in shapes] == first
    for (m, n, k), (splits, kper) in zip(shapes, first):
        k4 = max(4, -(-k // 4) * 4)
        assert kper % tmac.BLOCK_K == 0 and splits >= 1
        # the card's plan is taken on the padded K: it covers it exactly
        s4, p4 = tmac.sc_mac_plan(m, n, k4)
        assert s4 * p4 >= k4 > (s4 - 1) * p4
        assert p4 <= tmac.MAX_STAGES * tmac.BLOCK_K


@pytest.mark.parametrize("m,n", [(4096, 896), (1024, 2048), (512, 151936)])
def test_sc_mac_plan_caps_the_k_of_one_accumulator(m, n):
    """Tiles that fill the card alone still split a deep K (d_ff 4864:
    152 stages) into the fewest even splits of at most MAX_STAGES."""
    k = 4864
    splits, kper = tmac.sc_mac_plan(m, n, k)
    assert -(-n // tmac.BLOCK_N) * -(-m // tmac.BLOCK_M) >= tmac.NUM_SMS
    assert (splits, kper) == (3, 51 * tmac.BLOCK_K)
    assert tmac.sc_mac_plan(m, n, 2048) == (1, 2048)


@pytest.mark.parametrize("kmajor", [False, True])
@pytest.mark.parametrize("m,k,n", [(5, 37, 300), (130, 520, 7), (1, 16, 1),
                                   (3, 2, 5), (4, 8, 12)])
def test_tma_padding_leaves_the_plain_result_unchanged(m, k, n, kmajor):
    rng = np.random.default_rng(m * k + n)
    x, w, noise = _operands(rng, m, k, n)
    xt = torch.tensor(x)
    wt = torch.tensor(np.ascontiguousarray(w.T)).T if kmajor else torch.tensor(w)
    x4, w4, got_kmajor = tmac.tma_operands(xt, wt)
    k4, n4 = max(4, -(-k // 4) * 4), -(-n // 4) * 4
    assert x4.shape == (m, k4) and w4.shape == (k4, n4)
    assert got_kmajor == (kmajor and n > 1)
    # row strides of 16 bytes, as TMA needs
    assert (w4.stride(1) if got_kmajor else w4.stride(0)) % 4 == 0
    assert torch.equal(x4[:, :k], xt) and torch.equal(w4[:k, :n], wt)
    assert not x4[:, k:].any() and not w4[k:].any() and not w4[:, n:].any()
    z = torch.tensor(noise)
    want = tmac.sc_mac_fused_plain(xt, wt, z, nbit=256)
    got = tmac.sc_mac_fused_plain(x4, w4[:, :n], z, nbit=256)
    assert _rel_err(got, want) <= 1e-6


def test_tma_operands_take_aligned_weights_without_a_copy():
    table = torch.randn(1000, 896)  # the tied unembed passes table.T
    x = torch.randn(4, 896)
    x4, w4, kmajor = tmac.tma_operands(x, table.T)
    assert kmajor and w4.data_ptr() == table.data_ptr()
    assert w4.stride() == (1, 896) and x4.data_ptr() == x.data_ptr()
    w = torch.randn(896, 128)
    _, w4, kmajor = tmac.tma_operands(x, w)
    assert not kmajor and w4.data_ptr() == w.data_ptr()


def test_split_k_reduce_plain_sums_in_split_order():
    rng = np.random.default_rng(2)
    m, k, n, kper = 6, 96, 10, 32
    x, w, noise = _operands(rng, m, k, n)
    xt, wt, z = torch.tensor(x), torch.tensor(w), torch.tensor(noise)
    parts = torch.stack([
        torch.stack([xt[:, a:a + kper] @ wt[a:a + kper],
                     xt[:, a:a + kper].abs() @ wt[a:a + kper].abs()
                     - xt[:, a:a + kper] ** 2 @ wt[a:a + kper] ** 2])
        for a in range(0, k, kper)
    ])
    got = tmac.sc_mac_reduce(parts, z, nbit=256)  # CPU: the plain version
    assert _rel_err(got, tmac.sc_mac_fused_plain(xt, wt, z, nbit=256)) <= 1e-5
    got = tmac.sc_mac_reduce(parts, seed=9, nbit=256)
    want = tmac.sc_mac_fused_prng_plain(9, xt, wt, nbit=256)
    assert _rel_err(got, want) <= 1e-5
    with pytest.raises(ValueError, match="noise or a seed"):
        tmac.sc_mac_reduce(parts, nbit=256)


@pytest.mark.parametrize("quantize,bits,flag", [(True, 10, True),
                                                (True, 8, True),
                                                (True, 12, False),
                                                (False, 10, False)])
def test_pallas_moment_says_when_operands_are_on_the_grid(
        monkeypatch, quantize, bits, flag):
    from repro_torch.sc import backends

    seen = {}

    def spy(x, w, noise, *, nbit, on_grid=False):
        seen["on_grid"] = on_grid
        return tmac.sc_mac_fused_plain(x, w, noise, nbit=nbit)

    monkeypatch.setattr(backends.sc_mac_kernel, "sc_mac_fused", spy)
    _, tk = _key(1)
    cfg = tsc.ScConfig(backend="pallas_moment", quantize=quantize,
                       operand_bits=bits)
    backends.pallas_moment(tk, torch.randn(3, 8), torch.randn(8, 5), cfg)
    assert seen["on_grid"] is flag


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
