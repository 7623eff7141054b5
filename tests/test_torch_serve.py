"""PyTorch port vs JAX reference: the paged serving engine end to end.

Both engines come from ``build_engine(..., ServeOptions(paged=True,
fused_attention=...))`` with the same weights (``params_from_numpy``)
and replay the same greedy Poisson-like workload: 6 requests, prompts
of 4-20 tokens, 3-8 new tokens, block 8, chunk 6, arrivals on tick
numbers drawn from exponential gaps.  Greedy tokens must be identical
request for request, and the deterministic lifecycle counters of
``benchmarks/serve_bench.py:_EXACT_COUNTERS`` equal.

The stochastic case runs ``pallas_bitexact`` (the fused SC engine) with
``fused_sc`` attention on a narrower model (d_model 32, d_ff 64,
vocab 128, nbit 32) than the model tests use: the port's plain
int64-masked Threefry costs ~0.1 us per word on the CPU and the
workload feeds ~300 rows through every matmul.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.serve_bench import _EXACT_COUNTERS
from repro.configs import get_smoke_config as jax_smoke
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.serve import Request as JaxRequest
from repro.serve import ServeOptions as JaxOptions
from repro.serve import build_engine as jax_build
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.models import params as tparams
from repro_torch.serve import Request as TorchRequest
from repro_torch.serve import ServeOptions as TorchOptions
from repro_torch.serve import build_engine as torch_build


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel worker processes; torch's intra-op
    thread pool would oversubscribe the cores the JAX reference runs on
    (the plain versions' small ops run no slower on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _workload(vocab: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    arrivals = np.floor(np.cumsum(rng.exponential(1.5, 6))).astype(int)
    specs = []
    for rid in range(6):
        plen = int(rng.integers(4, 21))
        specs.append(dict(
            rid=rid,
            prompt=rng.integers(3, vocab, plen).tolist(),
            max_new_tokens=int(rng.integers(3, 9)),
            temperature=0.0,
        ))
    return arrivals.tolist(), specs


def _drive(engine, request_cls, arrivals, specs):
    reqs = [request_cls(**dict(s)) for s in specs]
    tick, i = 0, 0
    while i < len(reqs) or engine.scheduler.has_work():
        while i < len(reqs) and arrivals[i] <= tick:
            engine.submit(reqs[i])
            i += 1
        engine.step()
        tick += 1
        assert tick < 500
    return {r.rid: list(r.generated) for r in engine.finished}


def _serve_both(dims, fused_attention):
    jcfg = jax_smoke("qwen2-0.5b").replace(
        param_dtype=jnp.float32, act_dtype=jnp.float32, **dims
    )
    tcfg = torch_smoke("qwen2-0.5b").replace(
        param_dtype=torch.float32, act_dtype=torch.float32, **dims
    )
    params = jparams.init_params(
        jax.random.PRNGKey(0), jlm.lm_param_specs(jcfg), jnp.float32
    )
    np_params = jax.tree.map(np.asarray, params)
    opts = dict(paged=True, slots=3, max_len=32, block_size=8,
                prefill_chunk=6, fused_attention=fused_attention)
    arrivals, specs = _workload(dims.get("vocab", 256))
    jeng = jax_build(params, jcfg, JaxOptions(**opts))
    teng = torch_build(tparams.params_from_numpy(np_params, device="cpu"),
                       tcfg, TorchOptions(**opts), device="cpu")
    jtok = _drive(jeng, JaxRequest, arrivals, specs)
    ttok = _drive(teng, TorchRequest, arrivals, specs)
    return jeng, teng, jtok, ttok


def _assert_same_serving(jeng, teng, jtok, ttok):
    assert sorted(ttok) == list(range(6))
    for rid in range(6):
        assert ttok[rid] == jtok[rid], f"request {rid}"
    for name in _EXACT_COUNTERS:
        assert teng.metrics.value(name) == jeng.metrics.value(name), name
    assert teng.ticks == jeng.ticks


def test_serving_sc_bitexact_greedy_tokens_match_reference():
    dims = dict(d_model=32, d_ff=64, vocab=128, sc_backend="pallas_bitexact",
                sc_nbit=32, paged_attn="fused_sc")
    _assert_same_serving(*_serve_both(dims, fused_attention=False))


def test_serving_exact_fused_greedy_tokens_match_reference():
    dims = dict(d_ff=256)
    jeng, teng, jtok, ttok = _serve_both(dims, fused_attention=True)
    assert teng.cfg.paged_attn == "fused"
    _assert_same_serving(jeng, teng, jtok, ttok)
    lat = teng.decode_latency_ms()
    assert lat is not None and lat["decode_p50_ms"] > 0


@pytest.mark.parametrize(
    "kw",
    [
        dict(paged=False, mesh=True),
        dict(mesh=True, model_parallel=2),
    ],
)
def test_unported_options_raise_not_implemented(kw):
    """``mesh`` was the last serve option left unported: it now builds the
    fixed-slot engine, which shards over the mesh the caller passes (the
    launcher makes one; with none it serves unsharded, as the
    reference's does).  The trainer's mesh path no longer raises either:
    on the world of one's mesh a step is the single-device step."""
    from repro_torch.data import SyntheticLMData, make_batch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm as tlm
    from repro_torch.serve import ServingEngine
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train import train_state_init

    cfg = torch_smoke("qwen2-0.5b")
    gen = torch.Generator().manual_seed(0)
    params = tparams.init_params(tlm.lm_param_specs(cfg), gen, "cpu")
    eng = torch_build(params, cfg, TorchOptions(**kw), device="cpu")
    assert isinstance(eng, ServingEngine) and eng.mesh is None
    batch = make_batch(SyntheticLMData(cfg.vocab, 8, 2), 0)
    losses = [
        float(make_train_step(cfg, TrainConfig(), mesh=mesh)(
            train_state_init(0, cfg, TrainConfig(), device="cpu"),
            batch)[1]["loss"])
        for mesh in (None, make_local_mesh(device="cpu"))
    ]
    assert losses[0] == losses[1]


def test_sample_rows_greedy_and_gumbel_max_statistics():
    """Greedy takes the first maximum, as ``jnp.argmax``; temperature > 0
    draws Gumbel-max from the port's Threefry on each row's own key and
    agrees with ``jax.random.categorical`` in distribution only."""
    from repro.serve.engine import _sample_rows as jax_sample_rows
    from repro_torch.sc import ctr_rng
    from repro_torch.serve.engine import _sample_rows

    ties = torch.tensor([[0.0, 2.0, 2.0, -1.0]])
    keys = ctr_rng.split(ctr_rng.prng_key(1), 1)
    assert _sample_rows(keys, ties, torch.tensor([0.0])).tolist() == [1]
    n, temp = 4000, 0.7
    row = np.array([0.5, 1.0, -0.3, 0.0], np.float32)
    want = np.exp(row / temp) / np.exp(row / temp).sum()
    got = _sample_rows(
        ctr_rng.split(ctr_rng.prng_key(2), n),
        torch.tensor(np.tile(row, (n, 1))),
        torch.full((n,), temp),
    )
    jgot = jax_sample_rows(
        jax.random.split(jax.random.PRNGKey(2), n),
        jnp.tile(jnp.asarray(row), (n, 1)),
        jnp.full((n,), temp, jnp.float32),
    )
    # 4 sigma of a 4000-draw frequency is ~0.03 at these probabilities
    for draws in (got.numpy(), np.asarray(jgot)):
        freq = np.bincount(draws, minlength=4) / n
        np.testing.assert_allclose(freq, want, atol=0.03)
    mixed = _sample_rows(
        ctr_rng.split(ctr_rng.prng_key(3), 2),
        torch.tensor(np.stack([row, row])),
        torch.tensor([0.0, temp]),
    )
    assert int(mixed[0]) == int(np.argmax(row))
