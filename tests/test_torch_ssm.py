"""PyTorch port vs JAX reference: the Mamba2 / SSD layer
(``repro_torch.models.ssm`` against ``repro.models.ssm``).

On the same seeded numpy weights and inputs, at mamba2-370m's SMOKE
widths (d_model 64, d_inner 128, 8 heads of 16, state 16, chunk 8):

* ``_causal_conv`` with and without a cache: bit-equal in float32, and a
  float32 cache beside bf16 activations promotes as ``jnp.concatenate``
  does;
* ``ssd_chunked`` with s not a multiple of the chunk: y and the final
  state within 1e-5 of their max |ref| (XLA's and ATen's cumsum, einsum
  and exp round differently);
* ``ssm_block`` in its three modes (train, ``"prefill"``, one-token
  decode) and ``ssm_stream`` over a ragged ``valid`` mask on ``exact``
  within 1e-5, caches included;
* on ``pallas_fused`` with per-token keys every projection (z, x, B, C,
  dt before the softplus, and the out projection) bit-equal, and the raw
  key's per-SSD-chunk folding of a prefill;
* ``init_ssm_cache`` shapes and dtypes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import layers as jlayers
from repro.models import params as jparams
from repro.models import ssm as jssm
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.models import layers as tlayers
from repro_torch.models import params as tparams
from repro_torch.models import ssm as tssm

ARCH = "mamba2-370m"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return (
        jax_smoke(ARCH).replace(param_dtype=jnp.float32,
                                act_dtype=jnp.float32, **kw),
        torch_smoke(ARCH).replace(param_dtype=torch.float32,
                                  act_dtype=torch.float32, **kw),
    )


def _params(jcfg, seed=0):
    """The reference's ``init_params`` of one SSM block, with A_log, D and
    dt_bias drawn at random (their inits are constants)."""
    p = jparams.init_params(jax.random.PRNGKey(seed), jssm.ssm_specs(jcfg),
                            jnp.float32)
    p = jax.tree.map(np.asarray, p)
    rng = np.random.default_rng(seed + 10)
    h = jcfg.ssm_heads
    p["A_log"] = rng.uniform(-1.0, 1.0, h).astype(np.float32)
    p["D"] = rng.uniform(0.5, 1.5, h).astype(np.float32)
    p["dt_bias"] = rng.uniform(-2.0, 0.5, h).astype(np.float32)
    return (jax.tree.map(jnp.asarray, p),
            tparams.params_from_numpy(p, device="cpu"))


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return torch.tensor(a.astype(np.int64)).to(torch.uint32)
    return torch.tensor(a)


def _close(got, want, tol=1e-5):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _equal(got, want):
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


def _close_tree(got: dict, want: dict, tol=1e-5):
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name], tol)


# ---------------------------------------------------------------------------
# _causal_conv, ssd_chunked
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cached", [False, True])
def test_causal_conv_bit_equal_in_float32(cached):
    b, s, c, k = 2, 1 if cached else 7, 12, 4
    x, w = _x((b, s, c)), _x((k, c), 2)
    cache = _x((b, k - 1, c), 3) if cached else None
    want, wcache = jssm._causal_conv(
        jnp.asarray(x), jnp.asarray(w),
        None if cache is None else jnp.asarray(cache))
    got, gcache = tssm._causal_conv(
        _t(x), _t(w), None if cache is None else _t(cache))
    _equal(got, want)
    if cached:
        _equal(gcache, wcache)
    else:
        assert gcache is None and wcache is None


def test_causal_conv_promotes_a_float32_cache_with_bf16_activations():
    b, c, k = 2, 12, 4
    x, w, cache = _x((b, 1, c)), _x((k, c), 2), _x((b, k - 1, c), 3)
    jx = jnp.asarray(x, jnp.bfloat16)
    jw = jnp.asarray(w, jnp.bfloat16)
    want, wcache = jssm._causal_conv(jx, jw, jnp.asarray(cache))
    tx = _t(x).to(torch.bfloat16)
    got, gcache = tssm._causal_conv(tx, _t(w).to(torch.bfloat16), _t(cache))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert gcache.dtype == torch.float32
    _equal(got, want)
    _equal(gcache, wcache)


@pytest.mark.parametrize("s, chunk", [(13, 4), (8, 8), (5, 8)])
def test_ssd_chunked_matches_reference(s, chunk):
    b, h, p, n = 2, 3, 4, 5
    rng = np.random.default_rng(s)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 1.0, (b, s, h)).astype(np.float32)
    A = -rng.uniform(0.2, 2.0, h).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    wy, wh = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), chunk)
    gy, gh = tssm.ssd_chunked(*map(_t, (x, dt, A, B, C)), chunk)
    _close(gy, wy)
    _close(gh, wh)


# ---------------------------------------------------------------------------
# ssm_block, ssm_stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_ssm_block_exact_matches_reference(mode):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    s = 1 if mode == "decode" else 13
    x = _x((2, s, jcfg.d_model))
    jcache = tcache = None
    if mode == "prefill":
        jcache = tcache = "prefill"
    elif mode == "decode":
        prev = _x((2, 11, jcfg.d_model), 4)
        _, jcache = jssm.ssm_block(jnp.asarray(prev), jp, jcfg,
                                   cache="prefill")
        tcache = {k: _t(v) for k, v in jcache.items()}
    want, wc = jssm.ssm_block(jnp.asarray(x), jp, jcfg, cache=jcache)
    got, gc = tssm.ssm_block(_t(x), tp, tcfg, cache=tcache)
    _close(got, want)
    if mode == "train":
        assert gc is None and wc is None
    else:
        _close_tree(gc, wc)


def test_ssm_stream_ragged_valid_matches_reference():
    """Three rows, a 5-wide chunk: one full, one fed 2 tokens, one idle.
    Invalid positions leave the row's cache untouched."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    b, sc = 3, 5
    x = _x((b, sc, jcfg.d_model))
    valid = np.arange(sc)[None, :] < np.array([5, 2, 0])[:, None]
    prev = _x((b, 6, jcfg.d_model), 4)
    _, jcache = jssm.ssm_block(jnp.asarray(prev), jp, jcfg, cache="prefill")
    tcache = {k: _t(v) for k, v in jcache.items()}
    want, wc = jssm.ssm_stream(jnp.asarray(x), jp, jcfg, None, jcache,
                               jnp.asarray(valid))
    got, gc = tssm.ssm_stream(_t(x), tp, tcfg, None, tcache, _t(valid))
    _close(got, want)
    _close_tree(gc, wc)
    for name in gc:
        assert torch.equal(gc[name][2], tcache[name][2])


def _token_keys(b, s, seed=3):
    return jax.random.split(jax.random.PRNGKey(seed), b * s).reshape(b, s, 2)


# Both pallas_fused tests run 38 rows (2 × 19), so the reference's
# interpret-mode kernels compile once per projection shape for the two.
B_ROWS, S_ROWS = 2, 19


def test_projections_on_pallas_fused_with_per_token_keys_bit_equal():
    jcfg, tcfg = _cfgs(sc_backend="pallas_fused", sc_nbit=64)
    jp, tp = _params(jcfg)
    x = _x((B_ROWS, S_ROWS, jcfg.d_model))
    keys = _token_keys(B_ROWS, S_ROWS)
    for name in ("wz", "wx", "wB", "wC", "wdt"):
        site = "ssm_" + name
        want = jlayers.dense(jnp.asarray(x), jp[name], jcfg,
                             jlayers.site_key(keys, site), site=site)
        got = tlayers.dense(_t(x), tp[name], tcfg,
                            tlayers.site_key(_t(keys), site), site=site)
        _equal(got, want)
    want = jssm._project(jnp.asarray(x), jp, jcfg, keys)
    got = tssm._project(_t(x), tp, tcfg, _t(keys))
    for g, w in zip(got[:4], want[:4]):
        _equal(g, w)
    _close(got[4], want[4], 1e-6)  # dt: softplus of bit-equal totals
    # the out projection on the reference's gated, normed input
    y = _x((B_ROWS, S_ROWS, jcfg.d_inner), 5)
    want = jlayers.dense(jnp.asarray(y), jp["out"], jcfg,
                         jlayers.site_key(keys, "ssm_out"), site="ssm_out")
    got = tlayers.dense(_t(y), tp["out"], tcfg,
                        tlayers.site_key(_t(keys), "ssm_out"),
                        site="ssm_out")
    _equal(got, want)


def test_raw_key_folds_per_ssd_chunk_in_a_prefill():
    """A raw (2,) key with s > 1 fans out per SSD chunk: position t draws
    from ``fold_in(key, t // ssm_chunk)``.  The port's projections under
    its own folding equal the reference's under the reference's, and
    the whole block stays within 1e-5 on ``pallas_fused`` with the
    operand grid's discontinuity out of the way (nbit 64 here)."""
    jcfg, tcfg = _cfgs(sc_backend="pallas_fused", sc_nbit=64)
    jp, tp = _params(jcfg)
    b, s = B_ROWS, S_ROWS  # three SSD chunks of 8
    x = _x((b, s, jcfg.d_model))
    key = jax.random.PRNGKey(7)
    ck = jnp.broadcast_to(jnp.arange(s)[None, :] // jcfg.ssm_chunk, (b, s))
    jkeys = jlayers.fold_keys(jnp.broadcast_to(key, (b, s, 2)), ck)
    tck = (torch.arange(s) // tcfg.ssm_chunk)[None].expand(b, s)
    tkeys = tlayers.fold_keys(_t(key).expand(b, s, 2), tck)
    _equal(tkeys, jkeys)
    want = jssm._project(jnp.asarray(x), jp, jcfg, jkeys)
    got = tssm._project(_t(x), tp, tcfg, tkeys)
    for g, w in zip(got[:4], want[:4]):
        _equal(g, w)
    want, wc = jssm.ssm_block(jnp.asarray(x), jp, jcfg, key, cache="prefill")
    got, gc = tssm.ssm_block(_t(x), tp, tcfg, _t(key), cache="prefill")
    _close(got, want)
    _close_tree(gc, wc)


def test_init_ssm_cache_shapes_and_dtypes():
    jcfg, tcfg = _cfgs()
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        want = jssm.init_ssm_cache(jcfg, 3, jdt)
        got = tssm.init_ssm_cache(tcfg, 3, dt, device="cpu")
        assert set(got) == set(want)
        for name, v in want.items():
            assert tuple(got[name].shape) == v.shape
            assert str(got[name].dtype).split(".")[-1] == str(v.dtype)
            assert not got[name].any()
    assert got["state"].dtype == torch.float32
