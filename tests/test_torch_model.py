"""PyTorch port vs JAX reference: the dense LM's paged step.

``repro_torch.models.lm.decode_paged`` against ``repro.models.lm``'s on
the tiny configuration (2 layers, d_model 64, 4/2 heads, d_ff 256,
vocab 256, float32, non-zero QKV biases), with the reference's weights
carried over by ``params_from_numpy``: one chunked-prefill step over a
cache holding earlier context, then one decode step.

Tolerances:
* ``exact`` backend, ``unfused`` and ``fused`` attention: float math in
  another order, 1e-4 on logits and K/V pages.
* ``pallas_bitexact`` (the fused SC engine) with ``fused_sc``
  attention: the SC totals are bit-exact for equal float32 operands,
  but rms_norm, rope cos/sin, softmax and silu run through XLA on one
  side and ATen on the other, and a 1-ulp difference there can move an
  operand across a 10-bit grid boundary and change its stochastic
  bits.  Such a flip moves one product by O(1/nbit) of its scale, so
  logits are held to 5e-2 absolute (against logit magnitudes of ~3) and
  the greedy token must agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import lm as jlm
from repro.models import params as jparams
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel worker processes; torch's intra-op
    thread pool would oversubscribe the cores the JAX reference runs on
    (the plain versions' small ops run no slower on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DIMS = dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=256, vocab=256)
BS, NB = 4, 3


def _configs(**kw):
    jcfg = jax_smoke("qwen2-0.5b").replace(
        param_dtype=jnp.float32, act_dtype=jnp.float32, **DIMS, **kw
    )
    tcfg = torch_smoke("qwen2-0.5b").replace(
        param_dtype=torch.float32, act_dtype=torch.float32, **DIMS, **kw
    )
    return jcfg, tcfg


def _jax_params(cfg):
    p = jparams.init_params(
        jax.random.PRNGKey(0), jlm.lm_param_specs(cfg), jnp.float32
    )
    rng = np.random.default_rng(1)
    attn = p["blocks"]["attn"]
    for b in ("bq", "bk", "bv"):
        attn[b] = jnp.asarray(rng.normal(size=attn[b].shape) * 0.2,
                              jnp.float32)
    return jax.tree.map(np.asarray, p)


def _steps():
    """(tokens, lengths, n_valid) of a prefill chunk then a decode tick:
    row 0 starts fresh, row 1 already holds 3 context tokens."""
    rng = np.random.default_rng(2)
    toks = rng.integers(3, 256, (2, 3)).astype(np.int32)
    return [
        (toks, np.array([0, 3], np.int32), np.array([3, 2], np.int32)),
        (toks[:, :1], np.array([3, 5], np.int32), np.ones(2, np.int32)),
    ]


def _run_both(jcfg, tcfg, np_params, steps=2):
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = tparams.params_from_numpy(np_params, device="cpu")
    n_pages = 1 + 2 * NB
    bt = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    ctx = np.random.default_rng(3).normal(
        size=(jcfg.n_layers, n_pages, BS, jcfg.n_kv_heads, 16)
    ).astype(np.float32)
    jpages = {"k": jnp.asarray(ctx), "v": jnp.asarray(-ctx)}
    tpages = {"k": torch.tensor(ctx), "v": torch.tensor(-ctx)}
    keys = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in (5, 6)])
    out = []
    for toks, ln, nv in _steps()[:steps]:
        jl, jpages = jlm.decode_paged(
            jp, jpages, jnp.asarray(bt), jnp.asarray(toks), jnp.asarray(ln),
            jnp.asarray(nv), jcfg, rng=jnp.asarray(keys),
        )
        tl, tpages = tlm.decode_paged(
            tp, tpages, torch.tensor(bt), torch.tensor(toks),
            torch.tensor(ln), torch.tensor(nv), tcfg,
            rng=torch.tensor(keys),
        )
        # block 0 is the null block padding writes land in; the port's
        # pools update in place, so keep copies of this step's state
        out.append((np.asarray(jl), tl.numpy(),
                    np.asarray(jpages["k"])[:, 1:],
                    tpages["k"].numpy()[:, 1:].copy(),
                    np.asarray(jpages["v"])[:, 1:],
                    tpages["v"].numpy()[:, 1:].copy()))
    return out


@pytest.mark.parametrize("mode", ["unfused", "fused"])
def test_decode_paged_exact_matches_reference(mode):
    jcfg, tcfg = _configs(paged_attn=mode)
    for jl, tl, jk, tk, jv, tv in _run_both(jcfg, tcfg, _jax_params(jcfg)):
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tk, jk, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))


def test_decode_paged_sc_matches_reference():
    jcfg, tcfg = _configs(
        paged_attn="fused_sc", sc_backend="pallas_bitexact", sc_nbit=64
    )
    # one chunked step over a cache holding earlier context: the decode
    # step runs the same code at width 1, and each reference step pays
    # its own Pallas compiles
    out = _run_both(jcfg, tcfg, _jax_params(jcfg), steps=1)
    for jl, tl, jk, tk, jv, tv in out:
        np.testing.assert_allclose(tl, jl, atol=5e-2)
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
        np.testing.assert_allclose(tk, jk, atol=5e-2)
        np.testing.assert_allclose(tv, jv, atol=5e-2)


def test_params_from_numpy_round_trips_every_leaf():
    jcfg, tcfg = _configs()
    np_params = _jax_params(jcfg)
    tp = tparams.params_from_numpy(np_params, device="cpu")
    flat_np = jax.tree_util.tree_flatten_with_path(np_params)[0]
    n = 0
    for path, leaf in flat_np:
        node = tp
        for k in path:
            node = node[k.key]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), leaf)
        n += 1
    assert n == len(jax.tree.leaves(np_params))
    # bfloat16 leaves cross exactly
    bf = {"w": np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))}
    got = tparams.params_from_numpy(bf, device="cpu")["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  bf["w"].astype(np.float32))


def test_param_specs_match_reference_shapes():
    jcfg, tcfg = _configs()
    jspecs = jlm.lm_param_specs(jcfg)
    tspecs = tlm.lm_param_specs(tcfg)
    jshapes = jax.tree.map(lambda s: s.shape, jspecs,
                           is_leaf=lambda s: isinstance(s, jparams.ParamSpec))
    tshapes = {}

    def walk(src, dst):
        for k, v in src.items():
            if isinstance(v, dict):
                dst[k] = {}
                walk(v, dst[k])
            else:
                dst[k] = v.shape

    walk(tspecs, tshapes)
    assert tshapes == jshapes
    gen = torch.Generator().manual_seed(0)
    params = tparams.init_params(tspecs, gen, "cpu")
    assert params["blocks"]["attn"]["wq"].shape == (2, 64, 64)
    assert float(params["blocks"]["ln1"].min()) == 1.0
    assert float(params["blocks"]["attn"]["bq"].abs().max()) == 0.0
