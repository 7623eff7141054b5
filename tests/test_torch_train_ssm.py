"""PyTorch port vs JAX reference: training the SSM (mamba2-370m) and
hybrid (zamba2-7b) families.  The checks are here; zamba2-7b's cases
run from ``tests/test_torch_train_hybrid.py``.

The reference's weights (A_log, D and dt_bias drawn at random: their
inits are constants) carried over as numpy, its batches and keys go
through ``repro`` and ``repro_torch`` at the SMOKE widths in float32,
seq 16 over ``ssm_chunk`` 8 (two SSD chunks, so the carry crosses a
chunk boundary).  Tolerances, as ``tests/test_torch_train.py`` states
them:

* ``lm_loss`` within 1e-5 relative and every gradient leaf (``A_log``,
  ``D``, ``dt_bias``, the convs, the gated norm, all projections, the
  shared block's leaves) within 1e-4 of its max |value| against
  ``jax.value_and_grad`` of the reference's ``lm_loss``; on ``moment``
  with the 10-bit operand grid on, 1e-4 and 1e-2 (an ulp can move an
  operand across a grid step); the SSM projections draw per-token keys,
  so ``moment`` runs its rows route;
* 3 AdamW steps of ``make_train_step`` from the same carried-over
  state on ``exact`` and ``moment``: loss and grad norm within 1e-4
  relative (grad norm 1e-2 on ``moment`` with the grid on);
* the masked decay ``exp(where(causal, diff, -inf))`` gives zero, not
  NaN, gradients, and the chunk carry back-propagates into every chunk;
* kernel 5 is called a fixed number of times a step under
  ``pallas_moment`` (one call a site a layer, twice under remat, and
  twice a loss chunk), whatever the batch and sequence length.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.data import SyntheticLMData as JData
from repro.data import make_batch as jmake_batch
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.optim import AdamWConfig as JAdamW
from repro.sc import encoding as jenc
from repro.train import TrainConfig as JTrain
from repro.train import make_train_step as jmake_train_step
from repro.train.step import train_state_init as jtrain_state_init
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams
from repro_torch.models import ssm as tssm
from repro_torch.optim import AdamWConfig as TAdamW
from repro_torch.sc import backends as tbackends
from repro_torch.sc import encoding as tenc
from repro_torch.train import TrainConfig as TTrain
from repro_torch.train import make_train_step as tmake_train_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel worker processes; torch's intra-op
    thread pool would oversubscribe the cores the JAX reference runs on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, **kw):
    jcfg = jax_smoke(arch).replace(
        param_dtype=jnp.float32, act_dtype=jnp.float32, **kw)
    tcfg = torch_smoke(arch).replace(
        param_dtype=torch.float32, act_dtype=torch.float32, **kw)
    return jcfg, tcfg


def _jax_params(cfg, seed=0):
    """The reference's weights with A_log, D and dt_bias at random."""
    p = jparams.init_params(jax.random.PRNGKey(seed), jlm.lm_param_specs(cfg),
                            jnp.float32)
    p = jax.tree.map(np.asarray, p)
    ssm = p["blocks"]["ssm"]
    rng = np.random.default_rng(seed + 10)
    shape = ssm["A_log"].shape
    ssm["A_log"] = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    ssm["D"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
    ssm["dt_bias"] = rng.uniform(-2.0, 0.5, shape).astype(np.float32)
    return jax.tree.map(jnp.asarray, p)


def _batch(cfg, step=0, seq=16, batch=2):
    b = jmake_batch(JData(vocab=cfg.vocab, seq_len=seq, global_batch=batch),
                    step)
    return {k: np.array(v) for k, v in b.items()}


def _tkey(jkey):
    return None if jkey is None else torch.from_numpy(
        np.asarray(jkey).astype(np.int64)).to(torch.uint32)


def _walk(jtree, ttree):
    """(path, jax leaf, torch leaf) over the reference's tree."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        node = ttree
        for k in path:
            node = node[k.key]
        yield "/".join(str(k.key) for k in path), np.asarray(leaf), node


def _requires_grad(tree):
    if isinstance(tree, dict):
        return {k: _requires_grad(v) for k, v in tree.items()}
    return tree.detach().requires_grad_(True)


def _rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


def _no_grid(monkeypatch):
    monkeypatch.setattr(jenc, "quantize_grid", lambda p, levels: p)
    monkeypatch.setattr(tenc, "quantize_grid", lambda p, levels: p)


def check_loss_and_gradients(arch, backend, kw, grid, monkeypatch):
    if not grid:
        _no_grid(monkeypatch)
    loss_tol, grad_tol = (1e-4, 1e-2) if grid and backend != "exact" \
        else (1e-5, 1e-4)
    jcfg, tcfg = _configs(arch, sc_backend=backend, **kw)
    params = _jax_params(jcfg)
    batch = _batch(jcfg)
    rng = None
    if backend != "exact":
        rng = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, batch, jcfg, rng=rng)))(params)
    tp = _requires_grad(tparams.params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu"))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tl = tlm.lm_loss(tp, tb, tcfg, rng=_tkey(rng))
    tl.backward()
    assert _rel(tl.detach(), jl) <= loss_tol
    paths = []
    for path, g, leaf in _walk(jg, tp):
        err = np.abs(leaf.grad.numpy() - g).max()
        assert err <= grad_tol * np.abs(g).max(), (path, err)
        assert np.abs(g).max() > 0, path
        paths.append(path)
    assert len(paths) == len(jax.tree.leaves(jg))
    if arch == "zamba2-7b":
        assert {"shared/attn/wq", "shared/mlp/wo"} <= set(paths)


def check_train_steps(arch, backend, grid, monkeypatch):
    """Grad norm within 1e-4, or 1e-2 on ``moment`` with the grid on (a
    grid flip, as ``tests/test_torch_train.py`` states it)."""
    if not grid:
        _no_grid(monkeypatch)
    gnorm_tol = 1e-2 if grid and backend != "exact" else 1e-4
    jcfg, tcfg = _configs(arch, sc_backend=backend)
    adam = dict(lr=1e-3, warmup_steps=2, total_steps=100)
    jt = JTrain(optimizer=JAdamW(**adam))
    tt = TTrain(optimizer=TAdamW(**adam))
    jstate = jtrain_state_init(jax.random.PRNGKey(0), jcfg, jt)
    tstate = tparams.params_from_numpy(jax.tree.map(np.asarray, jstate),
                                       device="cpu")
    jstep = jax.jit(jmake_train_step(jcfg, jt, mesh=None))
    tstep = tmake_train_step(tcfg, tt)
    for i in range(3):
        batch = _batch(jcfg, step=i)
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, batch)
        assert _rel(tm["loss"], jm["loss"]) <= 1e-4, i
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= gnorm_tol, i
        assert np.isfinite(float(tm["loss"]))


def _kernel5_calls(arch, batch, seq, monkeypatch, remat):
    _, tcfg = _configs(arch, sc_backend="pallas_moment", remat=remat)
    gen = torch.Generator().manual_seed(0)
    tp = _requires_grad(tparams.init_params(tlm.lm_param_specs(tcfg), gen,
                                            "cpu"))
    tb = {k: torch.from_numpy(v)
          for k, v in _batch(tcfg, seq=seq, batch=batch).items()}
    calls = []
    real = tbackends.sc_mac_kernel.sc_mac_fused

    def counted(*a, **kw):
        calls.append(a[0].shape[0])
        return real(*a, **kw)

    monkeypatch.setattr(tbackends.sc_mac_kernel, "sc_mac_fused", counted)
    loss = tlm.lm_loss(tp, tb, tcfg, rng=_tkey(jax.random.PRNGKey(1)))
    loss.backward()
    return tcfg, calls


def check_kernel5_calls(arch, monkeypatch):
    """Six per-token-key SSM sites a layer, each ONE rows call of kernel
    5 over all batch x seq rows (not a loop of one-row calls); the
    shared block's six single-key sites an invocation; under remat every
    layer runs twice, and each loss chunk twice (its checkpoint)."""
    counts = {}
    for remat in ("none", "full"):
        for batch, seq in ((2, 16), (3, 24)):
            tcfg, calls = _kernel5_calls(arch, batch, seq, monkeypatch, remat)
            counts[remat, batch * seq] = len(calls)
            assert set(calls) == {batch * seq}
        per = 6 * tlm.n_backbone_layers(tcfg) \
            + 6 * tlm.n_shared_invocations(tcfg)
        runs = 2 if remat == "full" else 1
        assert counts[remat, 32] == counts[remat, 72] == per * runs + 2


# ---------------------------------------------------------------------------
# mamba2-370m (zamba2-7b's cases are in test_torch_train_hybrid.py, so
# ``--dist loadfile`` runs the two files side by side)
# ---------------------------------------------------------------------------

# (arch, backend, config overrides, 10-bit operand grid on)
LOSS_CASES = [
    ("mamba2-370m", "exact", {}, True),
    ("mamba2-370m", "moment", dict(remat="full"), False),
    ("mamba2-370m", "moment", {}, True),
]


@pytest.mark.parametrize("arch,backend,kw,grid", LOSS_CASES)
def test_lm_loss_and_gradients_match_reference(arch, backend, kw, grid,
                                               monkeypatch):
    check_loss_and_gradients(arch, backend, kw, grid, monkeypatch)


@pytest.mark.parametrize(
    "arch,backend,grid",
    [("mamba2-370m", "exact", True), ("mamba2-370m", "moment", False),
     ("mamba2-370m", "moment", True)],
)
def test_train_steps_match_reference(arch, backend, grid, monkeypatch):
    check_train_steps(arch, backend, grid, monkeypatch)


@pytest.mark.parametrize("arch", ["mamba2-370m"])
def test_kernel5_calls_a_step_do_not_depend_on_batch_or_seq(arch,
                                                            monkeypatch):
    check_kernel5_calls(arch, monkeypatch)


def test_masked_decay_and_the_chunk_carry_backpropagate():
    """``ssd_chunked`` at three chunks: every input's gradient is finite
    (the masked ``exp(-inf)`` pairs give 0, not NaN), and the output of
    the last chunk and the final state reach the first chunk's x, dt and
    B (the carry's Python loop back-propagates through every chunk; C
    only reads the state at its own position)."""
    rng = np.random.default_rng(0)
    b, s, h, p, n, chunk = 2, 24, 3, 4, 5, 8

    def leaf(*shape, lo=None):
        a = rng.standard_normal(shape) if lo is None else \
            rng.uniform(lo, 1.0, shape)
        return torch.tensor(a.astype(np.float32), requires_grad=True)

    x, dt = leaf(b, s, h, p), leaf(b, s, h, lo=0.1)
    B, C = leaf(b, s, n), leaf(b, s, n)
    A = -torch.exp(leaf(h))
    y, state = tssm.ssd_chunked(x, dt, A, B, C, chunk)
    (y[:, -chunk:].sum() + state.sum()).backward()
    for t in (x, dt, B, C):
        assert torch.isfinite(t.grad).all()
    for t in (x, dt, B):
        assert t.grad[:, :chunk].abs().max() > 0
    assert C.grad[:, :-chunk].abs().max() == 0
