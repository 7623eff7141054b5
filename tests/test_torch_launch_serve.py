"""PyTorch port: the serve launcher ``repro_torch.launch.serve`` on the
CPU — the fixed-slot engine, the paged engine and the 2-shard chaos
fleet — and its prompts against the JAX launcher's (the same
``jax.random`` draws; the weights, and so the tokens, differ)."""

import jax
import numpy as np
import pytest

from repro_torch.launch import serve as serve_launch
from repro_torch.sc import ctr_rng

_ARGS = ["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
         "--requests", "4", "--slots", "2", "--max-len", "48",
         "--max-new", "4"]


@pytest.mark.parametrize("extra", [[], ["--paged"], ["--chaos"]])
def test_serve_launcher_end_to_end(extra, capsys):
    finished = serve_launch.main(_ARGS + extra)
    assert sorted(r.rid for r in finished) == [0, 1, 2, 3]
    assert all(len(r.generated) >= 1 for r in finished)
    out = capsys.readouterr().out
    assert "served 4 requests" in out
    if extra == ["--chaos"]:
        assert "1 drained" in out


def test_serve_launcher_writes_metrics_and_trace(tmp_path):
    metrics, trace = tmp_path / "m.json", tmp_path / "t.jsonl"
    serve_launch.main(_ARGS + ["--paged", "--prefix-cache",
                               "--shared-prefix", "8",
                               "--metrics-out", str(metrics),
                               "--trace-out", str(trace)])
    assert "serve_requests_finished_total" in metrics.read_text()
    assert "request.finish" in trace.read_text()


def _jax_prompts(seed, n, vocab, shared_prefix):
    """The reference launcher's prompt loop (``repro/launch/serve.py``)."""
    rng = jax.random.PRNGKey(seed + 1)
    shared = []
    if shared_prefix:
        rng, k = jax.random.split(rng)
        shared = jax.random.randint(k, (shared_prefix,), 3, vocab).tolist()
    prompts = []
    for _ in range(n):
        rng, k = jax.random.split(rng)
        plen = int(jax.random.randint(k, (), 4, 17))
        prompts.append(
            shared + jax.random.randint(k, (plen,), 3, vocab).tolist())
    return prompts


@pytest.mark.parametrize(
    "seed, vocab, shared", [(0, 256, 0), (3, 151936, 5)]
)
def test_prompts_equal_the_reference_launchers(seed, vocab, shared):
    want = _jax_prompts(seed, 6, vocab, shared)
    assert serve_launch.synthetic_prompts(seed, 6, vocab, shared) == want


@pytest.mark.parametrize(
    "lo, hi", [(0, 16), (3, 65539), (3, 65540), (3, 151936), (0, 2**31 - 1)]
)
def test_randint_bit_equal_jax_past_16_bit_spans(lo, hi):
    """Spans above 2**16 take the reference's uint32-wrapped multiplier
    (``(2**16 % span)**2`` wraps to 0 there)."""
    want = jax.random.randint(jax.random.PRNGKey(5), (64,), lo, hi)
    got = ctr_rng.randint(ctr_rng.prng_key(5), (64,), lo, hi)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
