"""PyTorch port vs JAX reference: fused paged attention.

The plain versions of both CUDA kernels (``paged_attention_fused`` and
``paged_attention_fused_sc``) against the Pallas kernels in interpret
mode, on the same numpy-seeded pools and shuffled block tables.

Tolerances: the attention outputs are float math with another
summation order (a full softmax against the kernel's online softmax),
so they are held to rtol = atol = 1e-5 in float32.  The SC logits
themselves are integer pop-count totals scaled in the reference's f32
order, so ``sc_qk_logits_host`` is held bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpa
from repro.models import attention as jattn
from repro_torch.kernels import paged_attention as tpa
from repro_torch.models import attention as tattn
from repro_torch.sc import autotune


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel worker processes; torch's intra-op
    thread pool would oversubscribe the cores the JAX reference runs on
    (the plain versions' small ops run no slower on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_NBIT = 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(seed, *, b, sc, h, kvh, hd, bs, nb):
    """Random pool + shuffled block tables + per-token keys + lengths
    that reach block boundaries and length 0."""
    rng = np.random.default_rng(seed)
    n_pages = b * nb + 2
    kp = rng.normal(size=(n_pages, bs, kvh, hd)).astype(np.float32)
    vp = rng.normal(size=(n_pages, bs, kvh, hd)).astype(np.float32)
    bt = rng.permutation(n_pages)[: b * nb].reshape(b, nb).astype(np.int32)
    q = rng.normal(size=(b, sc, h, hd)).astype(np.float32)
    maxlen = bs * nb - sc
    lengths = np.array([0, bs, maxlen][:b], np.int32)
    keys = rng.integers(0, 2**32, (b, sc, 2), dtype=np.uint64)
    return q, kp, vp, bt, lengths, keys.astype(np.uint32)


@pytest.mark.parametrize("bs,sc", [(4, 1), (8, 3), (4, 3)])
def test_fused_plain_matches_pallas_kernel(bs, sc):
    q, kp, vp, bt, ln, _ = _case(bs + sc, b=3, sc=sc, h=4, kvh=2, hd=8,
                                 bs=bs, nb=3)
    # block_q=4 pads the 2*sc GQA rows of each kv head when sc = 3
    want = jpa.paged_attention_fused(
        *map(jnp.asarray, (q, kp, vp, bt, ln)), block_q=4
    )
    got = tpa.paged_attention_fused(*map(_t, (q, kp, vp, bt, ln)))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5
    )


@pytest.mark.parametrize("bs,sc", [(4, 1), (8, 3)])
def test_fused_sc_plain_matches_pallas_kernel(bs, sc):
    q, kp, vp, bt, ln, keys = _case(10 + bs, b=2, sc=sc, h=4, kvh=2, hd=8,
                                    bs=bs, nb=3)
    want = jpa.paged_attention_fused_sc(
        *map(jnp.asarray, (keys, q, kp, vp, bt, ln)), nbit=_NBIT, block_q=4
    )
    got = tpa.paged_attention_fused_sc(
        *map(_t, (keys, q, kp, vp, bt, ln)), nbit=_NBIT
    )
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5
    )


def test_sc_logits_host_twin_bit_exact():
    q, kp, _, bt, _, keys = _case(21, b=2, sc=3, h=4, kvh=2, hd=8, bs=4,
                                  nb=3)
    gathered = np.asarray(jattn.paged_gather(jnp.asarray(kp), bt))
    t_abs = np.arange(gathered.shape[1])
    for r, i, head in [(0, 0, 0), (1, 2, 3)]:
        kh = head // 2
        want = jpa.sc_qk_logits_host(
            jnp.asarray(keys[r, i]), jnp.asarray(q[r, i, head]),
            jnp.asarray(gathered[r, :, kh]), t_abs, head, 4, nbit=_NBIT,
        )
        got = tpa.sc_qk_logits_host(
            _t(keys[r, i]), _t(q[r, i, head]), _t(gathered[r, :, kh]),
            _t(t_abs), head, 4, nbit=_NBIT,
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_split_keys4_and_rows_layout_match_reference():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 2**32, (2, 3, 2), dtype=np.uint64)
    keys = keys.astype(np.uint32)
    np.testing.assert_array_equal(
        tpa.split_keys4(_t(keys)).numpy(),
        np.asarray(jpa.split_keys4(jnp.asarray(keys))),
    )
    q = rng.normal(size=(2, 3, 6, 4)).astype(np.float32)
    rows = tpa._rows_layout(_t(q), 2)
    np.testing.assert_array_equal(
        rows.numpy(), np.asarray(jpa._rows_layout(jnp.asarray(q), 2))
    )
    back = tpa._rows_unlayout(rows, sc=3, h=6)
    np.testing.assert_array_equal(back.numpy(), q)


def test_chunk_decode_and_paged_helpers_match_reference():
    q, kp, vp, bt, ln, _ = _case(31, b=2, sc=3, h=4, kvh=2, hd=8, bs=4,
                                 nb=3)
    jk = jattn.paged_gather(jnp.asarray(kp), jnp.asarray(bt))
    tk = tattn.paged_gather(_t(kp), _t(bt))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    jv = jattn.paged_gather(jnp.asarray(vp), jnp.asarray(bt))
    want = jattn.chunk_decode_attention(jnp.asarray(q), jk, jv,
                                        jnp.asarray(ln))
    got = tattn.chunk_decode_attention(_t(q), tk, _t(np.asarray(jv)), _t(ln))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # scatter (in place in the port) writes the same live slots
    new = np.random.default_rng(2).normal(size=(2, 3, 2, 8))
    new = new.astype(np.float32)
    nv = np.array([3, 1], np.int32)
    want = jattn.paged_scatter(jnp.asarray(kp), jnp.asarray(bt),
                               jnp.asarray(new), jnp.asarray(ln),
                               jnp.asarray(nv))
    got = tattn.paged_scatter(_t(kp), _t(bt), _t(new), _t(ln), _t(nv))
    np.testing.assert_array_equal(got.numpy()[1:], np.asarray(want)[1:])
    pages = {"k": _t(kp)[None].clone(), "v": _t(vp)[None].clone()}
    jpages = {"k": jnp.asarray(kp)[None], "v": jnp.asarray(vp)[None]}
    want = jattn.paged_copy_blocks(jpages, [1, 2], [3, 0])
    got = tattn.paged_copy_blocks(pages, [1, 2], [3, 0])
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


def test_wrappers_validate_shapes_and_keys():
    q, kp, vp, bt, ln, keys = _case(3, b=2, sc=1, h=4, kvh=2, hd=8, bs=4,
                                    nb=2)
    args = [_t(a) for a in (q, kp, vp, bt, ln)]
    with pytest.raises(ValueError, match="dtype"):
        tpa.paged_attention_fused(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="block_table"):
        tpa.paged_attention_fused(*args[:3], args[3][:1], args[4])
    with pytest.raises(ValueError, match="keys"):
        tpa.paged_attention_fused_sc(_t(keys[:, :, :1]), *args, nbit=64)
    with pytest.raises(ValueError, match="32 cells"):
        tpa.paged_attention_fused_sc(_t(keys), *args, nbit=40)


# ---------------------------------------------------------------------------
# The card's decomposition: the plan and the split-and-combine mirror
# ---------------------------------------------------------------------------

_PLAN_CASES = {
    # name: (b, kvh, rows, sc, hd, nb, bs, nbit, lengths)
    "phase_a_decode": (2, 2, 7, 1, 64, 4, 16, 1024, [15, 11]),
    "phase_a_prefill": (2, 2, 56, 8, 64, 4, 16, 1024, [8, 0]),
    "long_context": (2, 2, 7, 1, 64, 64, 16, 1024, [1023, 700]),
    "ragged_chunk": (3, 2, 12, 3, 8, 3, 4, 64, [0, 4, 9]),
    "many_tiles": (1, 2, 40, 5, 64, 40, 4, 0, [150]),
    "past_the_table": (2, 2, 4, 2, 8, 3, 4, 0, [11, 30]),
}


@pytest.mark.parametrize("name", sorted(_PLAN_CASES))
def test_paged_attention_plan_splits_cover_each_rows_live_pages(name):
    b, kvh, rows, sc, hd, nb, bs, nbit, lengths = _PLAN_CASES[name]
    plan = tpa.paged_attention_plan(b, kvh, rows, sc, hd, nb, bs, nbit)
    assert plan.splits * plan.pages_per_split >= nb
    assert (plan.splits - 1) * plan.pages_per_split < nb
    tiles = {}
    for bi, length in enumerate(lengths):
        for r in range(rows):
            last = min(nb * bs - 1, length + r % sc) // bs
            splits = plan.row_splits(length, r)
            assert len(splits) <= plan.splits
            # contiguous, non-empty, exactly the row's live pages
            pages = [p for lo, hi in splits for p in range(lo, hi)]
            assert pages == list(range(last + 1))
            assert all(lo < hi for lo, hi in splits)
            assert all(lo % plan.pages_per_split == 0 for lo, _ in splits)
            key = (bi, r // tpa.ROW_TILE)
            tiles[key] = max(tiles.get(key, 0), len(splits))
    live = plan.live_blocks(lengths)
    # a split block works when a row of its tile merges that split
    assert live["split"] == kvh * sum(tiles.values())
    want_logits = sum(
        min(nb * bs, n + r % sc + 1) for n in lengths for r in range(rows)
    )
    assert live["logits"] == (kvh * want_logits if nbit else 0)
    assert plan.launches == (nbit > 0) + 1 + (plan.splits > 1)


def test_paged_attention_plan_fills_the_card():
    """Phase A's decode tick (2 rows of 15 and 11 positions, 14 heads)
    gives the SC logits pass 392 live logits, the first units in launch
    order (so each lands in a block of its own); a 1,024-token cache
    gives the softmax pass a block per 2 pages.  (The heuristic tile:
    the shipped cache may hold another block size, which changes no
    count.)"""
    tile = autotune.heuristic_attn_tile(7, 16, 64, 1024)
    plan = tpa.paged_attention_plan(2, 2, 7, 1, 64, 4, 16, 1024, tile)
    assert plan.live_blocks([15, 11])["logits"] == 392 >= tpa.NUM_SMS
    assert plan.logit_threads == autotune.HEURISTIC_LOGIT_THREADS
    plan = tpa.paged_attention_plan(2, 2, 7, 1, 64, 64, 16, 1024)
    assert plan.pages_per_split == 2 and plan.splits == 32
    assert plan.live_blocks([1023, 700])["split"] == 2 * (32 + 22)


@pytest.mark.parametrize("nb", [3, 4, 40, 64])
def test_paged_attention_plan_splits_do_not_depend_on_the_width(nb):
    """A row's splits are the same at every chunk width (decode,
    speculative verify, prefill chunk), so its online softmax merges the
    same page ranges in the same order: 64 pages at b = 2 gave 32 splits
    at width 1 and 11 at width 5 while the plan counted row tiles."""
    g = 7
    base = tpa.paged_attention_plan(2, 2, g, 1, 64, nb, 16, 1024)
    for sc in (2, 3, 5, 8):
        plan = tpa.paged_attention_plan(2, 2, g * sc, sc, 64, nb, 16, 1024)
        assert plan.splits == base.splits
        assert plan.pages_per_split == base.pages_per_split
        for length in (0, 17, nb * 16 - 1):
            assert plan.row_splits(length, 0) == base.row_splits(length, 0)


@pytest.mark.parametrize(
    "hd,dtype,offset",
    [(4, torch.bfloat16, 0), (6, torch.float32, 0), (8, torch.float32, 1)],
)
def test_kernel_launch_refuses_kv_rows_off_16_bytes(hd, dtype, offset):
    """The split pass reads K/V rows in 16-byte loads: a row of hd
    elements that is not a multiple of 16 bytes, or a pool that does not
    start on 16 bytes, is refused before anything is built or launched
    (the wrappers run the plain versions for CPU tensors, so the launch
    helper is called directly)."""
    b, sc, h, kvh, bs, nb = 1, 1, 2, 1, 4, 2
    q = torch.zeros((b, sc, h, hd), dtype=dtype)
    n = (b * nb + 1) * bs * kvh * hd
    pool = torch.zeros(n + offset, dtype=dtype)[offset:]
    kp = pool.view(b * nb + 1, bs, kvh, hd)
    bt = torch.tensor([[1, 2]], dtype=torch.int32)
    ln = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(ValueError, match="16 bytes"):
        tpa._launch(q, kp, kp, bt, ln, None)


_SPLIT_CASES = {
    # name: (bs, sc, nb, lengths); b = len(lengths), h = 4, kvh = 2, hd = 8
    "bs4_sc1": (4, 1, 3, None),
    "bs8_sc3": (8, 3, 3, None),
    "bs4_sc3": (4, 3, 3, None),
    "many_pages": (4, 2, 40, [150, 77]),
}


@pytest.mark.parametrize("sc_logits", [False, True])
@pytest.mark.parametrize("name", sorted(_SPLIT_CASES))
def test_split_and_combine_plain_matches_pallas_kernels(name, sc_logits):
    """The kernels' decomposition (per-split max, denominator and
    accumulator over the plan's splits, merged in split order) against
    the reference's Pallas kernels in interpret mode."""
    bs, sc, nb, lengths = _SPLIT_CASES[name]
    b = 3 if lengths is None else len(lengths)
    q, kp, vp, bt, ln, keys = _case(40 + bs + sc, b=b, sc=sc, h=4, kvh=2,
                                    hd=8, bs=bs, nb=nb)
    if lengths is not None:
        ln = np.array(lengths, np.int32)
    plan = tpa.paged_attention_plan(b, 2, 2 * sc, sc, 8, nb, bs)
    assert plan.splits > 1
    if sc_logits:
        want = jpa.paged_attention_fused_sc(
            *map(jnp.asarray, (keys, q, kp, vp, bt, ln)), nbit=_NBIT,
            block_q=4,
        )
        got = tpa.paged_attention_split_plain(
            *map(_t, (q, kp, vp, bt, ln, keys)), nbit=_NBIT
        )
    else:
        want = jpa.paged_attention_fused(
            *map(jnp.asarray, (q, kp, vp, bt, ln)), block_q=4
        )
        got = tpa.paged_attention_split_plain(*map(_t, (q, kp, vp, bt, ln)))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5
    )


def test_sc_logits_plain_match_reference_logits_at_live_positions():
    """The plain logits of a whole call (what the card's logits pass is
    held to bit for bit) equal the reference's one-token twin at every
    live (row, position), and are NEG_INF where the mask hides one."""
    q, kp, _, bt, ln, keys = _case(23, b=3, sc=3, h=4, kvh=2, hd=8, bs=4,
                                   nb=3)
    got = tpa.sc_logits(*map(_t, (keys, q, kp, bt, ln)), nbit=_NBIT)
    gathered = np.asarray(jattn.paged_gather(jnp.asarray(kp), bt))
    t_len = gathered.shape[1]
    for bi in range(3):
        for r in range(6):  # rows layout: head kh*g + r // sc, offset r % sc
            for kh in range(2):
                head, i = kh * 2 + r // 3, r % 3
                live = ln[bi] + i + 1
                want = jpa.sc_qk_logits_host(
                    jnp.asarray(keys[bi, i]), jnp.asarray(q[bi, i, head]),
                    jnp.asarray(gathered[bi, :, kh]), np.arange(t_len),
                    head, 4, nbit=_NBIT,
                )
                row = got[bi, kh, r].numpy()
                np.testing.assert_array_equal(row[:live],
                                              np.asarray(want)[:live])
                assert (row[live:] == tpa.NEG_INF).all()
