"""The PyTorch port's CUDA kernels on the card, against their plain
versions (marker ``requires_cuda``; skipped without a GPU).

These tests import only ``torch`` and ``repro_torch`` so they also run
where JAX is not installed:

    python -m pytest -q -m requires_cuda tests/test_torch_cuda.py

Classes: every autotuner candidate tile of kernels 1-3 gives the
heuristic tile's bits; ``sc_fused`` and ``sc_mul_popcount`` totals
bit-equal (and the
``pallas_bitexact`` backend on the packed kernel equal to ``pallas_fused``
and to the CPU); the SC attention logits pass bit-equal to the plain
logits, attention outputs within 1e-5 in float32 (also at a 64-page
context), bit-equal from launch to launch and for a row at width 1 and
as row 0 of a width-3 chunk; the moment
kernels (``sc_mac_fused`` and its in-kernel-noise twin, 3xTF32 on the
tensor cores) within 1e-5 of max |out| of their plain versions (float32
sums in another order), on and off the operand grid, with the tied
unembed's K-major weight taken without a copy, and bit-equal from launch
to launch at a split-K shape (one ``sc_mac_fused`` and one
``sc_mac_reduce`` count per call), and ``pallas_moment``'s row-key
route one launch a call, each row within 1e-5 of its one-row call; a
tiny model served on the card and on the CPU gives the same greedy
tokens (also on the ``tiny`` faulty device, and through the fixed-slot
engine), trains to the same losses within 1e-4, and a request drained
from a card engine resumes warm on another with an uninterrupted run's
tokens.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import sc_fused as kf
from repro_torch.kernels import sc_mac as km
from repro_torch.kernels import sc_mul as kmul
from repro_torch.launch import train as launch_train
from repro_torch.models import lm, params
from repro_torch.sc import autotune
from repro_torch.serve import Request, ServeOptions, build_engine

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU tests cover the plain "
                    "versions")
    return torch.device("cuda")


def _u32(rng, shape):
    keys = rng.integers(0, 2**32, shape, dtype=np.uint64)
    return torch.tensor(keys.astype(np.uint32))


@pytest.mark.parametrize("row_keys", [True, False])
def test_sc_fused_kernel_bit_equals_plain(cuda, row_keys):
    rng = np.random.default_rng(0)
    m, k, n = 3, 37, 300
    keys = _u32(rng, (m, 4)).to(cuda)
    x = torch.tensor(rng.uniform(-1, 1, (m, k)), dtype=torch.float32)
    w = torch.tensor(rng.uniform(-1, 1, (k, n)), dtype=torch.float32)
    x, w = x.to(cuda), w.to(cuda)
    kw = dict(k_orig=k, n_orig=n + 5, nbit=128, levels=1024,
              row_keys=row_keys)
    before = cuda_lib.launches["sc_fused"]
    got = kf.sc_fused_popcount(keys, x, w, **kw)
    assert cuda_lib.launches["sc_fused"] == before + 1
    want = kf.sc_fused_popcount_plain(keys, x, w, **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,k,n", [(3, 37, 300), (12, 96, 40)])
def test_every_sc_fused_tile_gives_the_same_bits(cuda, m, k, n):
    """Every candidate launch shape of kernel 1 (block size, K split)
    gives the heuristic's totals, which equal the plain version's."""
    rng = np.random.default_rng(m)
    keys = _u32(rng, (m, 4)).to(cuda)
    x = torch.tensor(rng.uniform(-1, 1, (m, k)), dtype=torch.float32)
    w = torch.tensor(rng.uniform(-1, 1, (k, n)), dtype=torch.float32)
    x, w = x.to(cuda), w.to(cuda)
    kw = dict(k_orig=k, n_orig=n, nbit=128, levels=1024, row_keys=True)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    base = kf.sc_fused_popcount(
        keys, x, w, tile=autotune.heuristic_tile(m, k, n, 128, sms), **kw)
    assert torch.equal(base, kf.sc_fused_popcount_plain(keys, x, w, **kw))
    cands = autotune.candidate_tiles(m, k, n, 128, sms)
    assert len({t.threads for t in cands}) == len(autotune.FUSED_THREADS)
    for tile in cands:
        got = kf.sc_fused_popcount(keys, x, w, tile=tile, **kw)
        assert torch.equal(got, base), tile
    with pytest.raises(ValueError, match="no launch"):
        kf.sc_fused_popcount(keys, x, w, tile=autotune.FusedTile(96, 1),
                             **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sc", [1, 5])
def test_every_attention_tile_gives_the_same_bits(cuda, sc, dtype):
    """Every candidate tile of kernels 2 and 3 (the logits pass's block
    size) gives the heuristic's outputs and SC logits bit for bit, on
    ragged rows over several splits, in both dtypes the wrappers take."""
    rng = np.random.default_rng(20 + sc)
    bs, nb, h, kvh, hd, nbit = 8, 6, 12, 2, 64, 64
    case = _attn_case(rng, dtype, b=3, sc=sc, h=h, kvh=kvh, hd=hd,
                      bs=bs, nb=nb, lengths=[0, 2 * bs - 2, bs * nb - sc])
    keys, q, kp, vp, bt, ln = (t.to(cuda) for t in case)
    rows = h // kvh * sc
    for n in (0, nbit):
        heur = autotune.heuristic_attn_tile(rows, bs, hd, n)
        if n:
            call = (lambda t: pa.paged_attention_fused_sc(
                keys, q, kp, vp, bt, ln, nbit=n, tile=t))
            logits = pa.sc_logits(keys, q, kp, bt, ln, nbit=n, tile=heur)
        else:
            call = (lambda t: pa.paged_attention_fused(q, kp, vp, bt, ln,
                                                       tile=t))
        base = call(heur)
        for tile in autotune.candidate_attn_tiles(rows, bs, hd, n):
            assert torch.equal(call(tile), base), tile
            if n:
                assert torch.equal(pa.sc_logits(keys, q, kp, bt, ln, nbit=n,
                                                 tile=tile), logits), tile


@pytest.mark.parametrize("m,w", [(13, 32), (1000, 1), (9, 4), (70, 40)])
def test_sc_mul_kernel_bit_equals_plain(cuda, m, w):
    rng = np.random.default_rng(m + w)
    px = torch.tensor(rng.integers(0, 65536, m).astype(np.uint32))
    py = torch.tensor(rng.integers(0, 65536, m).astype(np.uint32))
    px[0], py[-1] = 0, 65535
    rx, ry = _u32(rng, (m, 16, w)), _u32(rng, (m, 16, w))
    px, py, rx, ry = (t.to(cuda) for t in (px, py, rx, ry))
    before = cuda_lib.launches["sc_mul_popcount"]
    got = kmul.sc_mul_popcount(px, py, rx, ry)
    assert cuda_lib.launches["sc_mul_popcount"] == before + 1
    want = kmul.sc_mul_popcount_plain(px, py, rx, ry)
    assert torch.equal(got, want)


def test_pallas_bitexact_on_the_card_equals_fused_and_cpu(cuda):
    from repro_torch import sc
    from repro_torch.sc import ctr_rng

    rng = np.random.default_rng(4)
    x = torch.tensor(rng.uniform(-1, 1, (2, 37)), dtype=torch.float32)
    w = torch.tensor(rng.uniform(-1, 1, (37, 50)), dtype=torch.float32)
    cfg = sc.ScConfig(backend="pallas_bitexact", nbit=256)
    key = ctr_rng.prng_key(11)
    before = cuda_lib.launches["sc_mul_popcount"]
    got = sc.sc_dot(key.to(cuda), x.to(cuda), w.to(cuda), cfg)
    assert cuda_lib.launches["sc_mul_popcount"] > before
    fused = sc.sc_dot(key.to(cuda), x.to(cuda), w.to(cuda),
                      cfg.replace(backend="pallas_fused"))
    assert torch.equal(got, fused)
    assert torch.equal(got.cpu(), sc.sc_dot(key, x, w, cfg))


def _attn_case(rng, dtype, *, b, sc, h, kvh, hd, bs, nb, lengths):
    n_pages = 1 + b * nb
    kp = torch.tensor(rng.normal(size=(n_pages, bs, kvh, hd)), dtype=dtype)
    vp = torch.tensor(rng.normal(size=(n_pages, bs, kvh, hd)), dtype=dtype)
    q = torch.tensor(rng.normal(size=(b, sc, h, hd)), dtype=dtype)
    bt = torch.tensor(rng.permutation(np.arange(1, n_pages)).reshape(b, nb),
                      dtype=torch.int32)
    ln = torch.tensor(lengths, dtype=torch.int32)
    keys = _u32(rng, (b, sc, 2))
    return keys, q, kp, vp, bt, ln


@pytest.mark.parametrize("nbit", [64, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sc", [1, 5])
def test_paged_attention_kernels_match_plain(cuda, sc, dtype, nbit):
    """Rows of length 0, of exactly one page, a chunk that crosses a
    page boundary (ragged: its rows end on different pages), and one
    that ends at the table's last position.  The SC logits pass equals
    the plain logits bit for bit, masked entries included; two launches
    of each kernel give the same bits."""
    rng = np.random.default_rng(sc)
    bs, nb = 8, 3
    case = _attn_case(rng, dtype, b=4, sc=sc, h=6, kvh=2, hd=64, bs=bs,
                      nb=nb, lengths=[0, bs - sc, 2 * bs - 2, bs * nb - sc])
    keys, q, kp, vp, bt, ln = (t.to(cuda) for t in case)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    _assert_work_as_planned(keys, q, kp, vp, bt, ln, nbit)
    before = cuda_lib.launches["paged_attention_fused"]
    got = pa.paged_attention_fused(q, kp, vp, bt, ln)
    assert cuda_lib.launches["paged_attention_fused"] == before + 1
    want = pa.paged_attention_fused_plain(q, kp, vp, bt, ln)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(got, pa.paged_attention_fused(q, kp, vp, bt, ln))
    logits = pa.sc_logits(keys, q, kp, bt, ln, nbit=nbit)
    assert torch.equal(
        logits, pa.sc_logits_plain(keys, q, kp, bt, ln, nbit=nbit)
    )
    before = cuda_lib.launches["paged_attention_fused_sc"]
    got = pa.paged_attention_fused_sc(keys, q, kp, vp, bt, ln, nbit=nbit)
    assert cuda_lib.launches["paged_attention_fused_sc"] == before + 1
    want = pa.paged_attention_fused_sc_plain(keys, q, kp, vp, bt, ln,
                                             nbit=nbit)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    again = pa.paged_attention_fused_sc(keys, q, kp, vp, bt, ln, nbit=nbit)
    assert torch.equal(got, again)


def _assert_work_as_planned(keys, q, kp, vp, bt, ln, nbit):
    """Each pass's work counted on the card equals the plan's count at
    these lengths, for both kernels; each count is one launch."""
    b, sc, h, hd = q.shape
    kvh, bs, nb = kp.shape[2], kp.shape[1], bt.shape[1]
    lengths = ln.tolist()
    for k in (None, keys):
        n = 0 if k is None else nbit
        plan = pa.paged_attention_plan(b, kvh, h // kvh * sc, sc, hd, nb, bs,
                                       n)
        name = "paged_attention_fused" + ("" if k is None else "_sc")
        before = cuda_lib.launches[name]
        got = pa.paged_attention_work(q, kp, vp, bt, ln, k, nbit=n)
        assert cuda_lib.launches[name] == before + 1
        want = plan.live_blocks(lengths)
        assert {key: got[key] for key in want} == want
        if n:
            assert 0 < got["logit_blocks"] <= got["logits"]
        else:
            assert got["logits"] == got["logit_blocks"] == 0


@pytest.mark.parametrize("lengths", [[1023, 700], [15, 11]])
def test_paged_attention_kernels_are_width_invariant(cuda, lengths):
    """A speculative verify feeds a chunk of 3 rows, row i at position
    ``start + i``: over a 64-page table, kernels 2 and 3 give every row
    of the chunk the bits a width-1 call of that row alone (its query,
    its key, length ``start + i``) gives it (the plan's splits do not
    depend on the query rows).  The chunk's last row sits at
    ``lengths``."""
    rng = np.random.default_rng(11)
    w = 3
    case = _attn_case(rng, torch.float32, b=2, sc=w, h=14, kvh=2, hd=64,
                      bs=16, nb=64, lengths=lengths)
    keys, q, kp, vp, bt, ln = (t.to(cuda) for t in case)
    start = ln - (w - 1)
    wide = pa.paged_attention_fused(q, kp, vp, bt, start)
    wide_sc = pa.paged_attention_fused_sc(keys, q, kp, vp, bt, start,
                                          nbit=64)
    for i in range(w):
        qi = q[:, i:i + 1].contiguous()
        ki = keys[:, i:i + 1].contiguous()
        one = pa.paged_attention_fused(qi, kp, vp, bt, start + i)
        assert torch.equal(one, wide[:, i:i + 1]), i
        one = pa.paged_attention_fused_sc(ki, qi, kp, vp, bt, start + i,
                                          nbit=64)
        assert torch.equal(one, wide_sc[:, i:i + 1]), i


def test_paged_attention_launch_refuses_kv_rows_off_16_bytes(cuda):
    """A CUDA tensor launches the kernel or raises: K/V rows that do not
    start on 16 bytes are refused, not read another way."""
    rng = np.random.default_rng(3)
    case = _attn_case(rng, torch.bfloat16, b=1, sc=1, h=2, kvh=1, hd=4,
                      bs=4, nb=2, lengths=[3])
    keys, q, kp, vp, bt, ln = (t.to(cuda) for t in case)
    with pytest.raises(ValueError, match="16 bytes"):
        pa.paged_attention_fused(q, kp, vp, bt, ln)
    with pytest.raises(ValueError, match="16 bytes"):
        pa.paged_attention_fused_sc(keys, q, kp, vp, bt, ln, nbit=64)


@pytest.mark.parametrize("lengths", [[1023, 1000], [15, 11]])
def test_paged_attention_kernels_at_long_context(cuda, lengths):
    """qwen2-0.5b's heads over a 64-page table: long rows (lengths 1,023
    and 1,000, many splits a row, merged in order) and short ones (most
    of the table masked: the logits pass stops past the last live
    position); float32 within 1e-5, the work as planned."""
    rng = np.random.default_rng(7)
    case = _attn_case(rng, torch.float32, b=2, sc=1, h=14, kvh=2, hd=64,
                      bs=16, nb=64, lengths=lengths)
    keys, q, kp, vp, bt, ln = (t.to(cuda) for t in case)
    plan = pa.paged_attention_plan(2, 2, 7, 1, 64, 64, 16, 64)
    assert plan.splits > 1
    _assert_work_as_planned(keys, q, kp, vp, bt, ln, 64)
    got = pa.paged_attention_fused(q, kp, vp, bt, ln)
    want = pa.paged_attention_fused_plain(q, kp, vp, bt, ln)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, pa.paged_attention_fused(q, kp, vp, bt, ln))
    got = pa.paged_attention_fused_sc(keys, q, kp, vp, bt, ln, nbit=64)
    want = pa.paged_attention_fused_sc_plain(keys, q, kp, vp, bt, ln,
                                             nbit=64)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    again = pa.paged_attention_fused_sc(keys, q, kp, vp, bt, ln, nbit=64)
    assert torch.equal(got, again)


@pytest.mark.parametrize(
    "m,k,n",
    [(5, 37, 300), (64, 896, 128), (130, 520, 7), (1, 16, 1),
     (512, 4864, 896)],
)
def test_sc_mac_kernels_match_plain(cuda, m, k, n):
    rng = np.random.default_rng(m * n)
    x = torch.tensor(rng.uniform(-1, 1, (m, k)), dtype=torch.float32)
    w = torch.tensor(rng.uniform(-1, 1, (k, n)), dtype=torch.float32)
    z = torch.tensor(rng.standard_normal((m, n)), dtype=torch.float32)
    x, w, z = x.to(cuda), w.to(cuda), z.to(cuda)
    before = cuda_lib.launches["sc_mac_fused"]
    got = km.sc_mac_fused(x, w, z, nbit=256)
    assert cuda_lib.launches["sc_mac_fused"] == before + 1
    want = km.sc_mac_fused_plain(x, w, z, nbit=256)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    seed = torch.tensor([12345], dtype=torch.int32)
    got = km.sc_mac_fused_prng(seed, x, w, nbit=256)
    want = km.sc_mac_fused_prng_plain(seed, x, w, nbit=256)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale


def _grid_operands(m, k, n, device, seed=0):
    """Signed probabilities on the 10-bit operand grid (exact in TF32)."""
    rng = np.random.default_rng(seed)

    def grid(shape):
        v = np.round(rng.uniform(-1, 1, shape) * 1024) / 1024
        return torch.tensor(v, dtype=torch.float32, device=device)

    z = torch.tensor(rng.standard_normal((m, n)), dtype=torch.float32,
                     device=device)
    return grid((m, k)), grid((k, n)), z


@pytest.mark.parametrize(
    "m,k,n", [(5, 37, 300), (130, 520, 7), (64, 896, 128), (512, 896, 896)]
)
def test_sc_mac_kernel_on_grid_operands_matches_plain(cuda, m, k, n):
    x, w, z = _grid_operands(m, k, n, cuda, m + n)
    before = cuda_lib.launches["sc_mac_fused"]
    got = km.sc_mac_fused(x, w, z, nbit=1024, on_grid=True)
    assert cuda_lib.launches["sc_mac_fused"] == before + 1
    want = km.sc_mac_fused_plain(x, w, z, nbit=1024)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_sc_mac_takes_the_tied_unembed_weight_without_a_copy(cuda):
    x, table, z = _grid_operands(64, 896, 1000, cuda, 7)
    table = table.T.contiguous()  # (vocab, d_model), as the embedding
    w = table.T  # the K-major view models/layers.py:unembed passes
    x4, w4, kmajor = km.tma_operands(x, w)
    assert kmajor and w4.data_ptr() == table.data_ptr()
    got = km.sc_mac_fused(x, w, z, nbit=1024, on_grid=True)
    want = km.sc_mac_fused_plain(x, w.contiguous(), z, nbit=1024)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_sc_mac_split_k_is_deterministic_and_counted(cuda):
    m, k, n = 512, 4864, 896  # mlp_wo: 56 tiles, split over K
    splits, _ = km.sc_mac_plan(m, n, k)
    assert splits > 1
    x, w, z = _grid_operands(m, k, n, cuda, 3)
    fused, red = (cuda_lib.launches[k_] for k_ in
                  ("sc_mac_fused", "sc_mac_reduce"))
    a = km.sc_mac_fused(x, w, z, nbit=1024, on_grid=True)
    b = km.sc_mac_fused(x, w, z, nbit=1024, on_grid=True)
    assert torch.equal(a, b)
    assert cuda_lib.launches["sc_mac_fused"] == fused + 2
    assert cuda_lib.launches["sc_mac_reduce"] == red + 2
    seed = torch.tensor([5], dtype=torch.int32)
    a = km.sc_mac_fused_prng(seed, x, w, nbit=1024)
    assert torch.equal(a, km.sc_mac_fused_prng(seed, x, w, nbit=1024))
    want = km.sc_mac_fused_prng_plain(seed, x, w, nbit=1024)
    assert float((a - want).abs().max()) <= 1e-5 * float(want.abs().max())
    # tiles that fill the card still split a deep K, within the contract
    x, w, z = _grid_operands(1024, 4864, 2048, cuda, 5)
    assert km.sc_mac_plan(1024, 2048, 4864)[0] == 3
    red = cuda_lib.launches["sc_mac_reduce"]
    got = km.sc_mac_fused(x, w, z, nbit=1024)
    assert cuda_lib.launches["sc_mac_reduce"] == red + 1
    want = km.sc_mac_fused_plain(x, w, z, nbit=1024)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    # a grid the tiles fill alone launches no reduction
    x, w, z = _grid_operands(512, 64, 4224, cuda, 4)
    assert km.sc_mac_plan(512, 4224, 64)[0] == 1
    red = cuda_lib.launches["sc_mac_reduce"]
    km.sc_mac_fused(x, w, z, nbit=1024, on_grid=True)
    assert cuda_lib.launches["sc_mac_reduce"] == red


@pytest.mark.parametrize("m,k,n", [(48, 1024, 160), (300, 64, 4224)])
def test_pallas_moment_row_keys_launch_once_and_equal_the_per_row_loop(
        cuda, m, k, n):
    """``sc_dot_rows`` on ``pallas_moment``: one kernel-5 launch (and one
    split-K pass where the plan splits) for the whole batch, each row
    within 1e-5 of max |out| of its own one-row call (another split plan
    may round it differently, never draw other bits) and of the CPU's
    rows route."""
    from repro_torch import sc
    from repro_torch.sc import ctr_rng

    gen = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn((m, k), generator=gen, device=cuda)
    x = x * torch.exp(torch.randn((m, 1), generator=gen, device=cuda))
    w = torch.randn((k, n), generator=gen, device=cuda) * 0.05
    keys = ctr_rng.split(ctr_rng.prng_key(3, device=cuda), m)
    cfg = sc.ScConfig(backend="pallas_moment")
    loop = torch.cat([sc.sc_dot(keys[i], x[i:i + 1], w, cfg)
                      for i in range(m)])
    cuda_lib.reset_launches()
    got = sc.sc_dot_rows(keys, x, w, cfg)
    splits, _ = km.sc_mac_plan(m, n, k)
    assert dict(cuda_lib.launches) == (
        {"sc_mac_fused": 1, "sc_mac_reduce": 1} if splits > 1
        else {"sc_mac_fused": 1})
    scale = float(loop.abs().max())
    assert float((got - loop).abs().max()) <= 1e-5 * scale
    cpu = sc.sc_dot_rows(keys.cpu(), x.cpu(), w.cpu(), cfg)
    assert float((got.cpu() - cpu).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("on_grid", [True, False])
@pytest.mark.parametrize("x_side", [False, True])
def test_sc_mac_keeps_the_variance_where_p_minus_p2_cancels(cuda, on_grid,
                                                            x_side):
    """|x| = 1 against |w| = 1023/1024 (or the other way round): every
    pair leaves 1023/1024^2 of p - p2, so a lost low part of a square (x^2
    in shared memory or w^2 in registers) shows in the sd, which unit
    noise minus zero noise isolates (rtol 1e-3: float32 ulps of the mean).
    K = 4864 at 2 output tiles takes the split-K route."""
    m, k, n = 64, 4864, 256
    rng = np.random.default_rng(11)

    def signs(shape, mag):
        v = np.where(rng.random(shape) < 0.5, -mag, mag).astype(np.float32)
        return torch.tensor(v, device=cuda)

    near = 1023 / 1024
    x = signs((m, k), near if x_side else 1.0)
    w = signs((k, n), 1.0 if x_side else near)
    assert km.sc_mac_plan(m, n, k)[0] > 1
    ones = torch.ones((m, n), device=cuda)
    sd = (km.sc_mac_fused(x, w, ones, nbit=1024, on_grid=on_grid)
          - km.sc_mac_fused(x, w, ones * 0, nbit=1024, on_grid=on_grid))
    want = math.sqrt(k * near * (1 / 1024) / 1024)
    torch.testing.assert_close(sd, torch.full_like(sd, want), rtol=1e-3,
                               atol=0)


def test_sc_mac_reduce_kernel_matches_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    parts = torch.rand((5, 2, 70, 33), generator=gen, device=cuda)
    z = torch.randn((70, 33), generator=gen, device=cuda)
    for kw in (dict(noise=z), dict(seed=11)):
        got = km.sc_mac_reduce(parts, nbit=64, **kw)
        want = km.sc_mac_reduce_plain(parts, nbit=64, **kw)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_tiny_model_trains_to_the_same_losses_on_card_and_cpu(cuda, tmp_path):
    losses = {}
    for dev in ("cuda", "cpu"):
        _, hist = launch_train.main([
            "--arch", "paper-sc", "--smoke", "--steps", "2", "--batch", "2",
            "--seq", "16", "--sc-backend", "pallas_moment", "--device", dev,
            "--ckpt-dir", str(tmp_path / dev)])
        losses[dev] = hist["loss"]
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


def test_kernel_wrappers_raise_instead_of_falling_back(cuda):
    keys = torch.zeros((2, 4), dtype=torch.uint32, device=cuda)
    x = torch.zeros((2, 3), device=cuda)
    w = torch.zeros((3, 4))  # on the CPU: mixed devices must raise
    with pytest.raises(ValueError, match="device"):
        kf.sc_fused_popcount(keys, x, w, k_orig=3, n_orig=4, nbit=64,
                             levels=1024)
    with pytest.raises(ValueError, match="device"):
        km.sc_mac_fused(x, w, torch.zeros((2, 4), device=cuda))


def test_tiny_model_serves_same_tokens_on_card_and_cpu(cuda):
    cfg = get_smoke_config("qwen2-0.5b").replace(
        d_model=32, d_ff=64, vocab=128, param_dtype=torch.float32,
        act_dtype=torch.float32, sc_backend="pallas_bitexact", sc_nbit=32,
        paged_attn="fused_sc")
    prompts = [[5, 9, 17, 3, 8, 11, 40], [40, 2, 8, 30]]
    toks = {}
    for dev in (cuda, torch.device("cpu")):
        gen = torch.Generator().manual_seed(0)
        p = params.init_params(lm.lm_param_specs(cfg), gen, dev,
                               torch.float32)
        eng = build_engine(p, cfg, ServeOptions(
            paged=True, slots=2, max_len=32, block_size=8, prefill_chunk=4),
            device=dev)
        for rid, prompt in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=4))
        eng.run_until_drained()
        toks[dev.type] = {r.rid: r.generated for r in eng.finished}
    assert toks["cuda"] == toks["cpu"]


def test_tiny_model_on_a_faulty_device_serves_same_tokens_on_card_and_cpu(
        cuda):
    cfg = get_smoke_config("qwen2-0.5b").replace(
        param_dtype=torch.float32, act_dtype=torch.float32)
    prompts = [[5, 9, 17, 3, 8, 11, 40], [40, 2, 8, 30]]
    toks = {}
    for dev in (cuda, torch.device("cpu")):
        gen = torch.Generator().manual_seed(0)
        p = params.init_params(lm.lm_param_specs(cfg), gen, dev,
                               torch.float32)
        eng = build_engine(p, cfg, ServeOptions(
            paged=True, slots=2, max_len=32, block_size=8, prefill_chunk=4,
            fault_profile="tiny"), collect_arch_trace=True, device=dev)
        for rid, prompt in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=4))
        eng.run_until_drained()
        assert eng.arch_report().cycles > 0
        eng.close()
        toks[dev.type] = {r.rid: r.generated for r in eng.finished}
    assert toks["cuda"] == toks["cpu"]


def _tiny_sc_params(dev):
    cfg = get_smoke_config("qwen2-0.5b").replace(
        d_model=32, d_ff=64, vocab=128, param_dtype=torch.float32,
        act_dtype=torch.float32, sc_backend="pallas_bitexact", sc_nbit=32,
        paged_attn="fused_sc")
    gen = torch.Generator().manual_seed(0)
    return cfg, params.init_params(lm.lm_param_specs(cfg), gen, dev,
                                   torch.float32)


def test_fixed_slot_engine_serves_same_tokens_on_card_and_cpu(cuda):
    """The default engine (fixed slots, kernel 1 with one key a call)."""
    prompts = [[5, 9, 17, 3, 8, 11, 40], [40, 2, 8, 30], [7, 7, 3]]
    toks = {}
    for dev in (cuda, torch.device("cpu")):
        cfg, p = _tiny_sc_params(dev)
        cuda_lib.reset_launches()
        eng = build_engine(p, cfg, ServeOptions(slots=2, max_len=32),
                           device=dev)
        for rid, prompt in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=4))
        toks[dev.type] = {r.rid: r.generated
                          for r in eng.run_until_drained()}
        if dev.type == "cuda":
            assert cuda_lib.launches["sc_fused"] > 0
            assert cuda_lib.launches["paged_attention_fused_sc"] == 0
    assert toks["cuda"] == toks["cpu"]


def test_drain_on_the_card_restores_warm_on_another_card_engine(cuda):
    cfg, p = _tiny_sc_params(cuda)
    opts = ServeOptions(paged=True, slots=2, max_len=32, block_size=4,
                        prefill_chunk=3)
    prompt = [5, 9, 17, 3, 11, 5]
    ref = build_engine(p, cfg, opts, device=cuda)
    ref.submit(Request(rid=0, prompt=list(prompt), max_new_tokens=5))
    want = ref.run_until_drained()[0].generated
    src = build_engine(p, cfg, opts, device=cuda)
    src.submit(Request(rid=0, prompt=list(prompt), max_new_tokens=5))
    for _ in range(3):
        src.step()
    (ckpt,) = src.drain()
    assert ckpt["kv"]["k"].device.type == "cpu" and ckpt["fed"] > 0
    dst = build_engine(p, cfg, opts, device=cuda)
    assert dst.restore(ckpt) is True
    assert dst.run_until_drained()[0].generated == want
    assert (dst.metrics.value("serve_prefill_tokens_total") or 0) \
        < len(prompt)
