"""PyTorch port vs JAX reference: zamba2-7b (the hybrid family) through
both serving engines on ``pallas_bitexact`` — kernel 1 for every SSM
projection, the shared block and the unembed, with per-token keys on
the paged engine and one key a call on the fixed-slot engine.

One group of the SMOKE config (two SSM layers and one shared
invocation) at d_model 32, nbit 256: the greedy tokens equal the JAX
engines' request for request.  The paged engine feeds one token a tick,
so its JAX twin compiles one step width.  The other zamba2 tests are in
``tests/test_torch_serve_zoo.py``; this file holds the two cases whose
JAX engines take the longest to compile, so that the two files can run
side by side.
"""

import pytest
import torch

from test_torch_serve_zoo import assert_engines_match


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("paged", [True, False])
def test_hybrid_engine_greedy_tokens_match_reference_on_bitexact(paged):
    assert_engines_match("zamba2-7b", "pallas_bitexact", paged,
                         prefill_chunk=1, n_layers=3)
