"""PyTorch port vs JAX reference: the embeddings frontend and the audio
family (musicgen-large).

At musicgen-large's SMOKE widths (2 layers, d_model 64, 4 heads, d_ff
128 GELU, vocab 128, untied, ``frontend="embeddings"``) in float32, on
the reference's weights carried over as numpy:

* ``frontend_specs``, ``project_embeddings``, ``audio_frame_embeddings``
  and ``vq_token_ids`` against the reference's (the draws bit-equal but
  ``normal``, within 1e-5);
* ``make_embedding_batch``: labels equal, embeddings within 1e-5 (the
  port's ``normal`` is the reference's to ~1e-6);
* ``lm_loss`` on the reference's embedding batch within 1e-5 relative
  and every gradient leaf (the frontend's projection included) within
  1e-4 of its max |value| against ``jax.value_and_grad``; on ``exact``
  and ``moment`` (the 10-bit grid off in both packages, see
  ``tests/test_torch_train.py``) and ``pallas_moment`` under remat;
  3 AdamW steps of ``make_train_step`` on ``exact`` and ``moment``
  within 1e-4;
* ``forward``, ``prefill`` from embeddings and one ``decode_step`` on
  ``moment`` (grid off) within 1e-5, as the reference's
  ``tests/test_model_zoo.py`` drives every config;
* greedy tokens on token prompts through both packages' ``build_engine``
  (``exact``) equal; ``launch/serve.py`` refuses the arch with the
  reference launcher's message; ``launch/train.py`` trains it on
  ``make_embedding_batch``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.data import SyntheticLMData as JData
from repro.data.pipeline import make_embedding_batch as jmake_emb_batch
from repro.models import frontend as jfrontend
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.optim import AdamWConfig as JAdamW
from repro.sc import encoding as jenc
from repro.serve import Request as JaxRequest
from repro.serve import ServeOptions as JaxOptions
from repro.serve import build_engine as jax_build
from repro.train import TrainConfig as JTrain
from repro.train import make_train_step as jmake_train_step
from repro.train.step import train_state_init as jtrain_state_init
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.data import SyntheticLMData as TData
from repro_torch.data import make_embedding_batch as tmake_emb_batch
from repro_torch.launch import serve as tlaunch_serve
from repro_torch.launch import train as tlaunch_train
from repro_torch.models import frontend as tfrontend
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams
from repro_torch.optim import AdamWConfig as TAdamW
from repro_torch.sc import encoding as tenc
from repro_torch.serve import Request as TorchRequest
from repro_torch.serve import ServeOptions as TorchOptions
from repro_torch.serve import build_engine as torch_build
from repro_torch.train import TrainConfig as TTrain
from repro_torch.train import make_train_step as tmake_train_step
from repro_torch.train import train_state_init as ttrain_state_init

ARCH = "musicgen-large"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel worker processes; torch's intra-op
    thread pool would oversubscribe the cores the JAX reference runs on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(**kw):
    jcfg = jax_smoke(ARCH).replace(
        param_dtype=jnp.float32, act_dtype=jnp.float32, **kw)
    tcfg = torch_smoke(ARCH).replace(
        param_dtype=torch.float32, act_dtype=torch.float32, **kw)
    return jcfg, tcfg


def _params(jcfg, seed=0):
    p = jparams.init_params(jax.random.PRNGKey(seed),
                            jlm.lm_param_specs(jcfg), jnp.float32)
    tp = tparams.params_from_numpy(jax.tree.map(np.asarray, p),
                                   device="cpu")
    return p, tp


def _data(cfg, seq=16, batch=2):
    return JData(vocab=cfg.vocab, seq_len=seq, global_batch=batch)


def _jbatch(cfg, step=0):
    b = jmake_emb_batch(_data(cfg), cfg.d_model, step)
    return {k: np.array(v) for k, v in b.items()}


def _tkey(jkey):
    return None if jkey is None else torch.from_numpy(
        np.asarray(jkey).astype(np.int64)).to(torch.uint32)


def _walk(jtree, ttree):
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


def _close(got, want, tol=1e-5):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def _no_grid(monkeypatch):
    monkeypatch.setattr(jenc, "quantize_grid", lambda p, levels: p)
    monkeypatch.setattr(tenc, "quantize_grid", lambda p, levels: p)


# ---------------------------------------------------------------------------
# The frontend module and the embedding batch
# ---------------------------------------------------------------------------


def test_frontend_specs_and_stub_draws_match_reference():
    jcfg, tcfg = _configs()
    want = jfrontend.frontend_specs(jcfg)["proj"]
    got = tfrontend.frontend_specs(tcfg)["proj"]
    assert (got.shape, got.axes, got.init) == (want.shape, want.axes,
                                               want.init)
    assert tlm.lm_param_specs(tcfg)["frontend"]["proj"].shape == want.shape
    jk = jax.random.PRNGKey(5)
    emb = jfrontend.audio_frame_embeddings(jk, 2, 7, 64, jnp.float32)
    temb = tfrontend.audio_frame_embeddings(_tkey(jk), 2, 7, 64,
                                            torch.float32, device="cpu")
    _close(temb, emb)
    assert tfrontend.audio_frame_embeddings(
        _tkey(jk), 1, 2, 8, device="cpu").dtype == torch.bfloat16
    jt, jm = jfrontend.vq_token_ids(jk, 2, 20, 300, (4, 30))
    tt, tm = tfrontend.vq_token_ids(_tkey(jk), 2, 20, 300, (4, 30),
                                    device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("backend", ["exact", "moment"])
def test_project_embeddings_matches_reference(backend, monkeypatch):
    _no_grid(monkeypatch)
    jcfg, tcfg = _configs(sc_backend=backend)
    jp, tp = _params(jcfg)
    x = np.random.default_rng(0).normal(size=(2, 5, 64)).astype(np.float32)
    jk = jax.random.PRNGKey(7)
    want = jfrontend.project_embeddings(jnp.asarray(x), jp["frontend"],
                                        jcfg, jk)
    got = tfrontend.project_embeddings(torch.tensor(x), tp["frontend"],
                                       tcfg, _tkey(jk))
    _close(got, want)


@pytest.mark.parametrize("step,shard", [(0, 0), (3, 1)])
def test_make_embedding_batch_matches_reference(step, shard):
    jcfg, _ = _configs()
    jdata = JData(vocab=jcfg.vocab, seq_len=12, global_batch=4, seed=9,
                  n_shards=2)
    tdata = TData(vocab=jcfg.vocab, seq_len=12, global_batch=4, seed=9,
                  n_shards=2)
    want = jmake_emb_batch(jdata, 64, step, shard)
    got = tmake_emb_batch(tdata, 64, step, shard)
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    assert got["inputs"].shape == (2, 12, 64)
    assert got["inputs"].dtype == torch.float32
    np.testing.assert_allclose(got["inputs"].numpy(),
                               np.asarray(want["inputs"]), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Loss, gradients, train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,kw", [
    ("exact", {}), ("moment", {}), ("pallas_moment", dict(remat="full")),
])
def test_lm_loss_and_gradients_match_reference(backend, kw, monkeypatch):
    _no_grid(monkeypatch)
    jcfg, tcfg = _configs(sc_backend=backend, **kw)
    jp, _ = _params(jcfg)
    batch = _jbatch(jcfg)
    rng = None
    if backend != "exact":
        rng = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, batch, jcfg, rng=rng)))(jp)
    tp = _requires_grad(tparams.params_from_numpy(
        jax.tree.map(np.asarray, jp), device="cpu"))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tl = tlm.lm_loss(tp, tb, tcfg, rng=_tkey(rng))
    tl.backward()
    assert _rel(tl.detach(), jl) <= 1e-5
    paths = []
    for path, g, leaf in _walk(jg, tp):
        if path == "embed/table":  # no token reaches the table
            assert leaf.grad is None or not leaf.grad.any()
            assert not np.any(g)
            continue
        err = np.abs(leaf.grad.numpy() - g).max()
        assert err <= 1e-4 * np.abs(g).max(), (path, err)
        paths.append(path)
    assert "frontend/proj" in paths
    assert len(paths) == len(jax.tree.leaves(jg)) - 1


@pytest.mark.parametrize("backend", ["exact", "moment"])
def test_train_steps_match_reference(backend, monkeypatch):
    _no_grid(monkeypatch)
    jcfg, tcfg = _configs(sc_backend=backend)
    adam = dict(lr=1e-3, warmup_steps=2, total_steps=100)
    jt = JTrain(optimizer=JAdamW(**adam))
    tt = TTrain(optimizer=TAdamW(**adam))
    jstate = jtrain_state_init(jax.random.PRNGKey(0), jcfg, jt)
    tstate = tparams.params_from_numpy(jax.tree.map(np.asarray, jstate),
                                       device="cpu")
    jstep = jax.jit(jmake_train_step(jcfg, jt, mesh=None))
    tstep = tmake_train_step(tcfg, tt)
    for i in range(3):
        batch = _jbatch(jcfg, step=i)
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, batch)
        assert _rel(tm["loss"], jm["loss"]) <= 1e-4, i
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-4, i


def test_train_launcher_trains_on_embedding_batches(tmp_path):
    """``launch/train.py --arch musicgen-large`` feeds
    ``make_embedding_batch``: its losses are those of the step run by
    hand on the same state and batches."""
    args = ["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "2",
            "--seq", "8", "--device", "cpu", "--sc-backend", "moment",
            "--ckpt-dir", str(tmp_path)]
    _, hist = tlaunch_train.main(args)
    cfg = torch_smoke(ARCH).replace(param_dtype=torch.float32,
                                    act_dtype=torch.float32,
                                    sc_backend="moment")
    tcfg = TTrain(optimizer=TAdamW(lr=1e-3, total_steps=2, warmup_steps=1))
    state = ttrain_state_init(0, cfg, tcfg, device="cpu")
    step = tmake_train_step(cfg, tcfg)
    data = TData(vocab=cfg.vocab, seq_len=8, global_batch=2)
    want = []
    for i in range(2):
        state, m = step(state, tmake_emb_batch(data, cfg.d_model, i))
        want.append(float(m["loss"]))
    assert hist["loss"] == want
    assert all(np.isfinite(want))


# ---------------------------------------------------------------------------
# Forward, prefill and decode from embeddings; serving on token prompts
# ---------------------------------------------------------------------------


def test_forward_prefill_and_decode_match_reference(monkeypatch):
    """The reference's ``test_every_arch_forward_and_decode_on_moment``
    walk on both packages: (1, 8, d) embeddings through ``forward`` and
    ``prefill``, then one token through ``decode_step``."""
    _no_grid(monkeypatch)
    jcfg, tcfg = _configs(sc_backend="moment", sc_nbit=64)
    jp, tp = _params(jcfg)
    key = jax.random.PRNGKey(3)
    emb = jax.random.normal(jax.random.fold_in(key, 1), (1, 8, 64),
                            jnp.float32)
    temb = torch.tensor(np.asarray(emb))
    rng = jax.random.fold_in(key, 2)
    _close(tlm.forward(tp, temb, tcfg, rng=_tkey(rng)),
           jlm.forward(jp, emb, jcfg, rng=rng))
    jl0, jcache, jlen = jlm.prefill(jp, emb, jcfg, max_len=12, rng=rng)
    tl0, tcache, tlen = tlm.prefill(tp, temb, tcfg, 12, rng=_tkey(rng))
    _close(tl0, jl0)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    for name in ("k", "v"):
        _close(tcache[name], jcache[name])
    tok = jnp.argmax(jl0, -1).astype(jnp.int32)
    assert torch.equal(torch.argmax(tl0, -1),
                       torch.tensor(np.asarray(tok), dtype=torch.int64))
    rng1 = jax.random.fold_in(rng, 1)
    jl1, _ = jlm.decode_step(jp, jcache, tok, jlen, jcfg, rng=rng1)
    tl1, _ = tlm.decode_step(tp, tcache, torch.tensor(np.asarray(tok)),
                             tlen, tcfg, rng=_tkey(rng1))
    assert tl1.shape == (1, jcfg.vocab)
    _close(tl1, jl1)


@pytest.mark.parametrize("paged", [False, True])
def test_engine_greedy_tokens_on_token_prompts_match_reference(paged):
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(1)
    specs = [dict(rid=i, prompt=rng.integers(3, jcfg.vocab, n).tolist(),
                  max_new_tokens=3 + i % 2) for i, n in enumerate((4, 9))]
    opts = dict(slots=2, max_len=24)
    if paged:
        opts.update(paged=True, block_size=4, prefill_chunk=4)
    out = []
    for build, req, p, cfg, options, kw in (
            (jax_build, JaxRequest, jp, jcfg, JaxOptions(**opts), {}),
            (torch_build, TorchRequest, tp, tcfg, TorchOptions(**opts),
             dict(device="cpu"))):
        eng = build(p, cfg, options, **kw)
        for s in specs:
            eng.submit(req(**s))
        out.append({r.rid: list(r.generated)
                    for r in eng.run_until_drained()})
    assert sorted(out[1]) == [0, 1]
    assert out[1] == out[0]


def test_serve_launcher_refuses_the_embeddings_frontend():
    with pytest.raises(SystemExit, match="token-frontend archs"):
        tlaunch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
