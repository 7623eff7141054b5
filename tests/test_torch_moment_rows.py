"""The moment substrate with per-row keys (``sc_dot_rows``): the rows
route of ``moment`` and ``pallas_moment``, one kernel-5 call a rows call.

Row i must be ``sc_dot(keys[i], x[i:i+1], w)``: its own max-abs scale
and operand grid, and the noise row ``normal(keys[i], (1, N))``.
Tolerances:

* ``ctr_rng.normal_rows`` against the per-row ``normal`` draw (and the
  padded one-row draw of ``pallas_moment``): bit-equal;
* the rows route against a loop of one-row ``sc_dot`` calls in the
  port: 1e-6 of max |out| (one batched matmul against one-row ones);
* against the reference's ``sc_dot_rows`` (a ``jax.vmap`` of the
  single-key path; ``pallas_moment`` in interpret mode): 1e-5 of max
  |out| (the port's ``normal`` is the reference's to ~1e-6);
* the straight-through gradient against ``jax.grad``: 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sc as jsc
from repro_torch import sc as tsc
from repro_torch.sc import backends
from repro_torch.sc import ctr_rng as trng

BACKENDS = ["moment", "pallas_moment"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel worker processes; torch's intra-op
    thread pool would oversubscribe the cores the JAX reference runs on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(m, k, n, seed=0):
    """Rows of very different magnitudes (each row's scale must be its
    own), a few exact zeros, a weight of another scale."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)) * np.exp(rng.uniform(-3, 3, (m, 1)))
    x[0, : k // 3] = 0.0
    w = rng.normal(size=(k, n)) * 0.1
    return x.astype(np.float32), w.astype(np.float32)


def _keys(m, seed=9):
    jkeys = jax.random.split(jax.random.PRNGKey(seed), m)
    tkeys = torch.from_numpy(np.asarray(jkeys).astype(np.int64))
    return jkeys, trng.raw_key(tkeys)


def _rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("n", [1, 32, 300, 384])
def test_normal_rows_bit_equals_the_per_row_draw(n):
    """Row i of ``normal_rows`` is ``normal(keys[i], (1, n))[0]``, and
    also row 0 of ``pallas_moment``'s one-row draw, whose padding to a
    128-column tile leaves flat index j = column j."""
    _, keys = _keys(6)
    got = trng.normal_rows(keys, n)
    assert got.shape == (6, n) and got.dtype == torch.float32
    for i in range(6):
        want = trng.normal(keys[i], (1, n))[0]
        assert torch.equal(got[i], want)
        padded = backends._moment_noise(keys[i], 1, n, "cpu")[0]
        assert torch.equal(got[i], padded)


@pytest.mark.parametrize("grid", [True, False])
@pytest.mark.parametrize("backend", BACKENDS)
def test_rows_route_equals_a_loop_of_one_row_calls(backend, grid,
                                                   monkeypatch):
    """One kernel-5 call (``pallas_moment``; on the CPU its plain
    version) or one set of torch matmuls (``moment``) for the whole
    batch, equal to the per-row loop."""
    m, k, n = 24, 40, 150
    x, w = _operands(m, k, n)
    _, keys = _keys(m)
    cfg = tsc.ScConfig(backend=backend, nbit=256, quantize=grid)
    xt, wt = torch.tensor(x), torch.tensor(w)
    loop = torch.cat([tsc.sc_dot(keys[i], xt[i:i + 1], wt, cfg)
                      for i in range(m)])
    calls = []
    real = backends.sc_mac_kernel.sc_mac_fused

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(backends.sc_mac_kernel, "sc_mac_fused", counted)
    got = tsc.sc_dot_rows(keys, xt, wt, cfg)
    assert got.shape == (m, n)
    assert _rel_err(got, loop) <= 1e-6
    # the noise is there: the draw moves the output off the exact product
    assert _rel_err(got, x @ w) > 1e-3
    assert calls == ([(m, k)] if backend == "pallas_moment" else [])


@pytest.mark.parametrize("backend", BACKENDS)
def test_rows_route_uses_leading_dims_and_row_local_scales(backend):
    """(b, s, 2) keys over (b, s, K) rows: the output is the flat call's,
    and scaling one row leaves every other row's bits unchanged."""
    b, s, k, n = 3, 5, 24, 70
    x, w = _operands(b * s, k, n, seed=4)
    _, keys = _keys(b * s, seed=2)
    cfg = tsc.ScConfig(backend=backend, nbit=512)
    xt, wt = torch.tensor(x), torch.tensor(w)
    flat = tsc.sc_dot_rows(keys, xt, wt, cfg)
    nd = tsc.sc_dot_rows(keys.reshape(b, s, 2), xt.reshape(b, s, k), wt, cfg)
    assert nd.shape == (b, s, n)
    assert torch.equal(nd.reshape(b * s, n), flat)
    x2 = xt.clone()
    x2[7] *= 1000.0
    moved = tsc.sc_dot_rows(keys, x2, wt, cfg)
    others = torch.arange(b * s) != 7
    assert torch.equal(moved[others], flat[others])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("m,k,n", [(12, 40, 150), (5, 64, 32)])
def test_rows_route_matches_the_reference_vmap(backend, m, k, n):
    x, w = _operands(m, k, n, seed=m)
    jkeys, tkeys = _keys(m, seed=k)
    want = jsc.sc_dot_rows(jkeys, jnp.asarray(x), jnp.asarray(w),
                           jsc.ScConfig(backend=backend, nbit=256))
    got = tsc.sc_dot_rows(tkeys, torch.tensor(x), torch.tensor(w),
                          tsc.ScConfig(backend=backend, nbit=256))
    assert _rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("backend", BACKENDS)
def test_rows_straight_through_gradient_matches_jax(backend):
    """The rows entry point's gradient is the exact-product jacobian,
    whatever the backend; the keys get none."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, 24)).astype(np.float32)
    w = (rng.normal(size=(24, 50)) * 0.2).astype(np.float32)
    g = rng.normal(size=(2, 6, 50)).astype(np.float32)
    jkeys, tkeys = _keys(12, seed=5)
    jkeys = jkeys.reshape(2, 6, 2)
    tkeys = tkeys.reshape(2, 6, 2)

    def jloss(xx, ww):
        y = jsc.sc_dot_rows(jkeys, xx, ww,
                            jsc.ScConfig(backend=backend, nbit=128))
        return jnp.sum(y * g)

    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    cfg = tsc.ScConfig(backend=backend, nbit=128)
    (tsc.sc_dot_rows(tkeys, xt, wt, cfg) * torch.tensor(g)).sum().backward()
    assert _rel_err(xt.grad, jgx) <= 1e-5
    assert _rel_err(wt.grad, jgw) <= 1e-5
