"""PyTorch port vs JAX reference: the training path.

The same weights (the reference's, carried over as numpy), batches and
keys go through ``repro`` and ``repro_torch`` at the smoke widths
(2 layers, d_model 64, vocab 256, float32).  Tolerances:

* ``lm_loss`` within 1e-5 relative; each gradient leaf within 1e-4 of
  its max |value| (float sums in another order; under the moment
  backends the noise is the reference's to ~1e-6, see
  ``test_torch_sc_mac.py``);
* the train step from the same carried-over state and batches: loss and
  grad norm within 1e-4 relative at each of 3 steps (Adam's first step
  is ``sign(g)·lr``, so parameters are not compared after it);
* ``adamw_update`` from identical gradients: 1e-6;
* attention: 1e-5;
* the data pipeline, the checkpoint layout and recovery: exact.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_smoke_config as jax_smoke
from repro.data import SyntheticLMData as JData
from repro.data import make_batch as jmake_batch
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim.adamw import cosine_lr as jcosine_lr
from repro.sc import encoding as jenc
from repro.train import TrainConfig as JTrain
from repro.train import make_train_step as jmake_train_step
from repro.train.step import train_state_init as jtrain_state_init
from repro_torch import checkpoint as tckpt
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.data import SyntheticLMData as TData
from repro_torch.data import make_batch as tmake_batch
from repro_torch.ft import FaultInjector, Supervisor
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams
from repro_torch.optim import AdamWConfig as TAdamW
from repro_torch.optim import adamw_init as tadamw_init
from repro_torch.optim import adamw_update as tadamw_update
from repro_torch.optim.adamw import cosine_lr as tcosine_lr
from repro_torch.sc import encoding as tenc
from repro_torch.train import TrainConfig as TTrain
from repro_torch.train import make_eval_step as tmake_eval_step
from repro_torch.train import make_train_step as tmake_train_step
from repro_torch.train import train_state_init as ttrain_state_init

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
        param_dtype=jnp.float32, act_dtype=jnp.float32, **kw
    )
    tcfg = torch_smoke(arch).replace(
        param_dtype=torch.float32, act_dtype=torch.float32, **kw
    )
    return jcfg, tcfg


def _jax_params(cfg):
    """The reference's weights, with non-zero QKV biases where the
    config has them."""
    p = jparams.init_params(
        jax.random.PRNGKey(0), jlm.lm_param_specs(cfg), jnp.float32
    )
    if cfg.qkv_bias:
        rng = np.random.default_rng(1)
        attn = p["blocks"]["attn"]
        for b in ("bq", "bk", "bv"):
            attn[b] = jnp.asarray(
                rng.normal(size=attn[b].shape) * 0.2, jnp.float32
            )
    return p


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


# ---------------------------------------------------------------------------
# Model: attention, forward, loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
def test_attention_variants_match_reference(causal):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 12, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 12, 2, 16)).astype(np.float32)
    want = np.asarray(jattn.full_attention(q, k, v, causal=causal))
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    got = tattn.full_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    for chunk in (5, 12, 64):
        jb = jattn.blockwise_attention(q, k, v, causal=causal, chunk=chunk)
        tb = tattn.blockwise_attention(tq, tk, tv, causal=causal, chunk=chunk)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5)
        np.testing.assert_allclose(tb.numpy(), want, atol=1e-5)


# (arch, backend, config overrides, 10-bit operand grid on)
LOSS_CASES = [
    ("paper-sc", "exact", {}, True),
    ("paper-sc", "pallas_moment", {}, False),
    (
        "qwen2-0.5b",
        "pallas_moment",
        dict(attn_impl="blockwise", attn_chunk=8, remat="full"),
        False,
    ),
    ("paper-sc", "pallas_moment", {}, True),
]


@pytest.mark.parametrize("arch,backend,kw,grid", LOSS_CASES)
def test_lm_loss_and_gradients_match_reference(arch, backend, kw, grid,
                                               monkeypatch):
    """Tolerances: the loss within 1e-5 relative and each gradient leaf
    within 1e-4 of its max |value| wherever the function is continuous.
    With the 10-bit operand grid on, a moment backend is not: XLA and
    ATen round rms_norm, softmax and the attention einsums differently
    in the last place, an ulp can move an operand across a grid step
    (2^-10 of its tensor's max-abs scale), and later layers amplify the
    flips (measured: up to 2e-3 of a leaf's max, 1e-5 of the loss).
    That case is held to 1e-4 (loss) and 1e-2 (gradients); the cases
    with the grid switched off in BOTH packages (``quantize_grid`` the
    identity) hold the same code path to the tight tolerances."""
    if not grid:
        monkeypatch.setattr(jenc, "quantize_grid", lambda p, levels: p)
        monkeypatch.setattr(tenc, "quantize_grid", lambda p, levels: p)
    loss_tol, grad_tol = (1e-4, 1e-2) if grid and backend != "exact" \
        else (1e-5, 1e-4)
    jcfg, tcfg = _configs(arch, sc_backend=backend, **kw)
    if arch == "qwen2-0.5b":  # two loss chunks, each with its own key
        monkeypatch.setattr(jlm, "LOSS_SEQ_CHUNK", 8)
        monkeypatch.setattr(tlm, "LOSS_SEQ_CHUNK", 8)
    params = _jax_params(jcfg)
    batch = _batch(jcfg)
    rng = None
    if backend != "exact":
        rng = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    jl, jg = jax.value_and_grad(
        lambda p: jlm.lm_loss(p, batch, jcfg, rng=rng))(params)
    tp = _requires_grad(tparams.params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu"))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tl = tlm.lm_loss(tp, tb, tcfg, rng=_tkey(rng))
    tl.backward()
    assert _rel(tl.detach(), jl) <= loss_tol
    n = 0
    for path, g, leaf in _walk(jg, tp):
        err = np.abs(leaf.grad.numpy() - g).max()
        assert err <= grad_tol * np.abs(g).max(), (path, err)
        n += 1
    assert n == len(jax.tree.leaves(jg))


def test_forward_logits_match_reference():
    jcfg, tcfg = _configs("qwen2-0.5b")
    params = _jax_params(jcfg)
    tokens = _batch(jcfg)["inputs"]
    want = np.asarray(jlm.forward(params, tokens, jcfg))
    tp = tparams.params_from_numpy(jax.tree.map(np.asarray, params),
                                   device="cpu")
    got = tlm.forward(tp, torch.from_numpy(tokens), tcfg)
    assert got.shape == (2, 16, jcfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_remat_recomputes_the_same_loss_and_gradients():
    """Activation checkpointing reruns each layer's forward in the
    backward: the moment noise is a pure function of its key, so the
    result is the un-checkpointed one, bit for bit."""
    out = {}
    for remat in ("none", "full"):
        _, tcfg = _configs("paper-sc", sc_backend="pallas_moment",
                           remat=remat)
        tp = _requires_grad(tparams.init_params(
            tlm.lm_param_specs(tcfg), torch.Generator().manual_seed(0),
            "cpu"))
        tb = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
        loss = tlm.lm_loss(tp, tb, tcfg, rng=_tkey(jax.random.PRNGKey(4)))
        loss.backward()
        out[remat] = (loss.detach(), tp["blocks"]["attn"]["wq"].grad,
                      tp["embed"]["table"].grad)
    for a, b in zip(out["none"], out["full"]):
        assert torch.equal(a, b)


def test_stochastic_dense_without_a_key_raises_naming_the_site():
    _, tcfg = _configs("paper-sc")
    x = torch.zeros(2, 64)
    w = torch.zeros(64, 8)
    with pytest.raises(ValueError, match="mlp_wo"):
        tlayers.dense(x, w, tcfg, None, site="mlp_wo")


# ---------------------------------------------------------------------------
# Optimizer, train step, microbatches
# ---------------------------------------------------------------------------


def test_cosine_lr_matches_reference():
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 10, 11, 57, 100, 140):
        want = float(jcosine_lr(JAdamW(**cfg), jnp.int32(step)))
        got = float(tcosine_lr(TAdamW(**cfg), torch.tensor(step)))
        assert abs(got - want) <= 1e-9


@pytest.mark.parametrize("state_dtype", ["f32", "bf16", "int8"])
def test_adamw_update_matches_reference(state_dtype):
    rng = np.random.default_rng(5)
    params = {
        "a": rng.normal(size=(3, 4, 5)).astype(np.float32),
        "b": {"w": rng.normal(size=(7,)).astype(np.float32)},
    }
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10,
               state_dtype=state_dtype)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tparams.params_from_numpy(params, device="cpu")
    jopt = jadamw_init(jp, JAdamW(**cfg))
    topt = tadamw_init(tp, TAdamW(**cfg))
    for _, want, got in _walk(jopt, topt):
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_array_equal(got.double().numpy(),
                                      np.asarray(want, np.float64))
    for i in range(3):
        g = jax.tree.map(
            lambda a: rng.normal(size=a.shape).astype(np.float32) * (i + 1),
            params)
        # both start each update from the reference's state
        topt = tparams.params_from_numpy(
            jax.tree.map(np.asarray, jopt), device="cpu")
        tp = tparams.params_from_numpy(
            jax.tree.map(np.asarray, jp), device="cpu")
        jp, jopt, jm = jadamw_update(jax.tree.map(jnp.asarray, g), jopt, jp,
                                     JAdamW(**cfg))
        tp, topt, tm = tadamw_update(
            tparams.params_from_numpy(g, device="cpu"), topt, tp,
            TAdamW(**cfg))
        for _, want, got in _walk(jp, tp):
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        for _, want, got in _walk(jopt, topt):
            # int8 payloads exactly; float (and bfloat16) leaves to 1e-6
            tol = 0 if got.dtype == torch.int8 else 1e-6
            np.testing.assert_allclose(got.double().numpy(),
                                       np.asarray(want, np.float64),
                                       rtol=0, atol=tol)
        assert int(topt["step"]) == int(jopt["step"]) == i + 1
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-6
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-9
        if state_dtype == "int8":
            assert topt["m"]["a"]["q"].dtype == torch.int8


def _carried_state(jstate):
    return tparams.params_from_numpy(
        jax.tree.map(np.asarray, jstate), device="cpu")


@pytest.mark.parametrize(
    "backend,micro,grid",
    [("exact", 1, True), ("pallas_moment", 1, True),
     ("pallas_moment", 2, False)],
)
def test_train_steps_match_reference(backend, micro, grid, monkeypatch):
    """Loss within 1e-4 relative at each step; grad norm within 1e-4, or
    1e-2 under a moment backend with the 10-bit operand grid on (see
    ``test_lm_loss_and_gradients_match_reference`` for the grid flips;
    the microbatched case switches the grid off in both packages)."""
    if not grid:
        monkeypatch.setattr(jenc, "quantize_grid", lambda p, levels: p)
        monkeypatch.setattr(tenc, "quantize_grid", lambda p, levels: p)
    gnorm_tol = 1e-2 if grid and backend != "exact" else 1e-4
    jcfg, tcfg = _configs("paper-sc", sc_backend=backend)
    adam = dict(lr=1e-3, warmup_steps=2, total_steps=100)
    jt = JTrain(optimizer=JAdamW(**adam), microbatches=micro)
    tt = TTrain(optimizer=TAdamW(**adam), microbatches=micro)
    jstate = jtrain_state_init(jax.random.PRNGKey(0), jcfg, jt)
    tstate = _carried_state(jstate)
    jstep = jax.jit(jmake_train_step(jcfg, jt, mesh=None))
    tstep = tmake_train_step(tcfg, tt)
    for i in range(3):
        batch = _batch(jcfg, step=i, batch=4)
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, batch)
        assert _rel(tm["loss"], jm["loss"]) <= 1e-4, i
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= gnorm_tol, i
        assert int(tstate["opt"]["step"]) == i + 1


def test_microbatches_match_the_full_batch():
    _, tcfg = _configs("paper-sc", sc_backend="exact")
    adam = TAdamW(lr=1e-3, warmup_steps=2, total_steps=100)
    batch = tmake_batch(TData(vocab=256, seq_len=16, global_batch=4), 0)
    out = []
    for micro in (1, 2):
        tt = TTrain(optimizer=adam, microbatches=micro)
        state = ttrain_state_init(0, tcfg, tt, device="cpu")
        out.append(tmake_train_step(tcfg, tt)(state, batch))
    (s1, m1), (s2, m2) = out
    assert _rel(m2["loss"], m1["loss"]) <= 1e-5
    for a, b in zip(tlm_leaves(s1["params"]), tlm_leaves(s2["params"])):
        assert float((a - b).abs().max()) < 1e-5


def tlm_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tlm_leaves(tree[k])
    else:
        yield tree


def test_eval_step_is_the_loss_without_a_graph():
    _, tcfg = _configs("paper-sc", sc_backend="exact")
    state = ttrain_state_init(0, tcfg, TTrain(), device="cpu")
    batch = tmake_batch(TData(vocab=256, seq_len=16, global_batch=2), 0)
    got = tmake_eval_step(tcfg)(state["params"], batch)
    assert not got.requires_grad
    want = tlm.lm_loss(state["params"], batch, tcfg)
    assert float(got) == float(want)


# ---------------------------------------------------------------------------
# Data, checkpoints, recovery, the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (256, 16, 4, 0), (151936, 64, 8, 3), (2048, 17, 3, 1)])
def test_data_pipeline_matches_reference_token_for_token(vocab, seq, batch,
                                                         seed):
    for step in (0, 1, 9):
        want = jmake_batch(JData(vocab, seq, batch, seed), step)
        got = tmake_batch(TData(vocab, seq, batch, seed), step)
        for k in ("inputs", "labels"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_params_from_numpy_carries_the_train_state():
    jcfg, _ = _configs("paper-sc")
    jt = JTrain(optimizer=JAdamW(state_dtype="int8"))
    jstate = jtrain_state_init(jax.random.PRNGKey(0), jcfg, jt)
    tstate = _carried_state(jstate)
    n = 0
    for path, want, got in _walk(jstate, tstate):
        assert str(got.dtype).split(".")[-1] == {
            "float32": "float32", "int8": "int8", "int32": "int32"}[
                str(want.dtype)], path
        np.testing.assert_array_equal(got.numpy(), want)
        n += 1
    assert n == len(jax.tree.leaves(jstate))
    assert tstate["opt"]["m"]["embed"]["table"]["q"].dtype == torch.int8


@pytest.mark.parametrize("state_dtype", ["f32", "bf16", "int8"])
def test_checkpoints_restore_across_the_packages(state_dtype, tmp_path):
    jcfg, tcfg = _configs("paper-sc")
    jt = JTrain(optimizer=JAdamW(state_dtype=state_dtype))
    jstate = jtrain_state_init(jax.random.PRNGKey(0), jcfg, jt)
    # non-zero optimizer state, so every leaf carries information
    jstate["opt"] = jax.tree.map(
        lambda a: (a + 0.25).astype(a.dtype)
        if a.dtype != jnp.int8 else a + 3,
        jstate["opt"])
    tstate = _carried_state(jstate)
    like = ttrain_state_init(
        1, tcfg, TTrain(optimizer=TAdamW(state_dtype=state_dtype)),
        device="cpu")

    # JAX writes, the port reads
    jckpt.save(str(tmp_path / "j"), 4, jstate, extra={"data_step": 4})
    got, extra, step = tckpt.restore(str(tmp_path / "j"), like)
    assert (extra, step) == ({"data_step": 4}, 4)
    for path, want, leaf in _walk(jstate, got):
        assert leaf.dtype == _walk_one(like, path).dtype, path
        np.testing.assert_array_equal(
            leaf.float().numpy() if leaf.dtype == torch.bfloat16
            else leaf.numpy(),
            want.astype(np.float32) if want.dtype.name == "bfloat16"
            else want)

    # the port writes, JAX reads
    tckpt.save(str(tmp_path / "t"), 6, tstate, extra={"data_step": 6})
    back, extra, step = jckpt.restore(str(tmp_path / "t"), jstate)
    assert (extra, step) == ({"data_step": 6}, 6)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(jstate)[0]):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))

    # both packages write the same manifest keys, in the same order
    import json
    jm = json.load(open(tmp_path / "j" / "step_00000004" / "META.json"))
    tm = json.load(open(tmp_path / "t" / "step_00000006" / "META.json"))
    assert [e["key"] for e in jm["manifest"]] == \
        [e["key"] for e in tm["manifest"]]
    assert [e["shape"] for e in jm["manifest"]] == \
        [e["shape"] for e in tm["manifest"]]


def _walk_one(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def test_supervisor_recovers_from_an_injected_failure(tmp_path):
    """4 steps with checkpoints every 2 and a failure before the fourth
    (0-based index 3): the run restores the step-2 checkpoint and
    replays step 3, and every step's loss equals an uninterrupted
    run's."""
    _, tcfg = _configs("paper-sc", sc_backend="pallas_moment")
    tt = TTrain(optimizer=TAdamW(lr=1e-3, warmup_steps=1, total_steps=4))
    data = TData(vocab=256, seq_len=16, global_batch=2)
    runs = []
    for inject in ((3,), ()):
        state = ttrain_state_init(0, tcfg, tt, device="cpu")
        sup = Supervisor(ckpt_dir=str(tmp_path / f"run{len(runs)}"),
                         ckpt_every=2,
                         injector=FaultInjector(fail_at_steps=inject))
        state, hist = sup.run(state, tmake_train_step(tcfg, tt), 4,
                              make_batch=lambda s: tmake_batch(data, s))
        runs.append((state, hist))
    (s_f, h_f), (s_u, h_u) = runs
    assert h_f["recoveries"] == [(2, 2)] and h_u["recoveries"] == []
    # ran 0, 1, 2, failed before 3, restored 2, ran 2, 3
    assert h_f["loss"] == h_u["loss"][:3] + h_u["loss"][2:]
    for a, b in zip(tlm_leaves(s_f), tlm_leaves(s_u)):
        assert torch.equal(a, b)


def test_launcher_end_to_end_on_the_cpu(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "paper-sc", "--smoke", "--steps", "2", "--batch", "2", "--seq",
           "16", "--device", "cpu", "--ckpt-dir", str(tmp_path),
           "--ckpt-every", "1"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=300, check=True).stdout
    assert "step     1 loss" in out and "done: first loss" in out
    assert tckpt.latest_step(str(tmp_path)) == 2


def test_launcher_resumes_and_returns_per_step_records(tmp_path):
    args = ["--arch", "paper-sc", "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "16", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--sc-backend", "pallas_moment"]
    _, full = tlaunch.main(args)
    assert [r["step"] for r in full["steps"]] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and r["ms"] > 0 for r in full["steps"])
    _, resumed = tlaunch.main(args + ["--resume"])
    assert [r["step"] for r in resumed["steps"]] == [3]
    assert resumed["loss"] == full["loss"][2:]
