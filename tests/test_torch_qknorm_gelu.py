"""PyTorch port vs JAX reference: the dense variants ``qk_norm=True``
(RMSNorm of q and k over the head dim, before RoPE) and
``mlp_variant="gelu"`` (the tanh GELU on a (d, d_ff) ``wi``).

Each variant runs at d_model 64 on the same numpy weights in both
packages:

* one chunked-prefill ``decode_paged`` step under ``exact`` +
  ``unfused`` attention over a cache holding earlier context: logits
  within 1e-5, the K/V pages within 1e-5, the greedy argmax equal;
* one ``lm_loss`` with its gradients (``exact``, the training path
  through ``lm.encode``): the loss within 1e-5 relative, every gradient
  leaf within 1e-5 of its leaf's max |grad|, and the greedy argmax of
  ``forward``'s logits equal.
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

DIMS = dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=256, vocab=256)
VARIANTS = {
    "qk_norm": dict(qk_norm=True),
    "gelu": dict(mlp_variant="gelu"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel worker processes; keep torch to one
    intra-op thread beside the JAX reference."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(variant):
    kw = dict(**DIMS, **VARIANTS[variant])
    jcfg = jax_smoke("qwen2-0.5b").replace(
        param_dtype=jnp.float32, act_dtype=jnp.float32, **kw
    )
    tcfg = torch_smoke("qwen2-0.5b").replace(
        param_dtype=torch.float32, act_dtype=torch.float32, **kw
    )
    return jcfg, tcfg


def _np_params(cfg):
    """The reference's weights, with the norm scales and QKV biases moved
    off their ones / zeros init so each leaf shows in the output."""
    p = jparams.init_params(
        jax.random.PRNGKey(0), jlm.lm_param_specs(cfg), jnp.float32
    )
    rng = np.random.default_rng(1)
    attn = p["blocks"]["attn"]
    for name in ("bq", "bk", "bv", "q_norm", "k_norm"):
        if name in attn:
            base = 1.0 if name.endswith("norm") else 0.0
            noise = rng.normal(size=attn[name].shape) * 0.2
            attn[name] = jnp.asarray(base + noise, jnp.float32)
    return jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_param_specs_carry_the_variant_leaves(variant):
    jcfg, tcfg = _configs(variant)
    np_params = _np_params(jcfg)
    tp = tparams.params_from_numpy(np_params, device="cpu")
    tspecs = tlm.lm_param_specs(tcfg)
    for name, spec in tspecs["blocks"]["attn"].items():
        assert tuple(tp["blocks"]["attn"][name].shape) == spec.shape, name
    assert tuple(tp["blocks"]["ffn"]["wi"].shape) == \
        tspecs["blocks"]["ffn"]["wi"].shape
    if variant == "qk_norm":
        assert tspecs["blocks"]["attn"]["q_norm"].shape == (2, 16)
        assert tspecs["blocks"]["attn"]["k_norm"].init == "ones"
    else:
        assert tspecs["blocks"]["ffn"]["wi"].shape == (2, 64, 256)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_paged_variant_matches_reference(variant):
    jcfg, tcfg = _configs(variant)
    np_params = _np_params(jcfg)
    bs, nb = 4, 3
    n_pages = 1 + 2 * nb
    bt = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    ctx = np.random.default_rng(3).normal(
        size=(jcfg.n_layers, n_pages, bs, jcfg.n_kv_heads, 16)
    ).astype(np.float32)
    toks = np.random.default_rng(2).integers(3, 256, (2, 3)).astype(np.int32)
    ln = np.array([0, 3], np.int32)
    nv = np.array([3, 2], np.int32)
    jl, jpages = jlm.decode_paged(
        jax.tree.map(jnp.asarray, np_params),
        {"k": jnp.asarray(ctx), "v": jnp.asarray(-ctx)},
        jnp.asarray(bt), jnp.asarray(toks), jnp.asarray(ln),
        jnp.asarray(nv), jcfg,
    )
    tpages = {"k": torch.tensor(ctx), "v": torch.tensor(-ctx)}
    tl, tpages = tlm.decode_paged(
        tparams.params_from_numpy(np_params, device="cpu"), tpages,
        torch.tensor(bt), torch.tensor(toks), torch.tensor(ln),
        torch.tensor(nv), tcfg,
    )
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tl.numpy().argmax(-1), jl.argmax(-1))
    for name in ("k", "v"):  # block 0 takes the padding writes
        np.testing.assert_allclose(
            tpages[name].numpy()[:, 1:], np.asarray(jpages[name])[:, 1:],
            rtol=0, atol=1e-5,
        )


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_lm_loss_and_grads_variant_match_reference(variant):
    jcfg, tcfg = _configs(variant)
    np_params = _np_params(jcfg)
    rng = np.random.default_rng(4)
    tokens = rng.integers(3, 256, (2, 9)).astype(np.int32)
    inputs, labels = tokens[:, :-1], tokens[:, 1:]

    def jloss(p):
        batch = {"inputs": jnp.asarray(inputs), "labels": jnp.asarray(labels)}
        return jlm.lm_loss(p, batch, jcfg)

    jp = jax.tree.map(jnp.asarray, np_params)
    jl, jg = jax.value_and_grad(jloss)(jp)
    tp = tparams.params_from_numpy(np_params, device="cpu")
    for _, leaf in _leaves(tp):
        leaf.requires_grad_(True)
    batch = {"inputs": torch.tensor(inputs), "labels": torch.tensor(labels)}
    tl = tlm.lm_loss(tp, batch, tcfg)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    jg = jax.tree.map(np.asarray, jg)
    n = 0
    for path, leaf in _leaves(tp):
        want = jg
        for k in path:
            want = want[k]
        got = leaf.grad.numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                                   err_msg="/".join(path))
        n += 1
    assert n == len(jax.tree.leaves(np_params))
    with torch.no_grad():
        tlog = tlm.forward(tp, batch["inputs"], tcfg).numpy()
    jlog = np.asarray(jlm.forward(jp, jnp.asarray(inputs), jcfg))
    np.testing.assert_array_equal(tlog.argmax(-1), jlog.argmax(-1))
