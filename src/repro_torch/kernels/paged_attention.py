"""Fused paged attention for decode and chunked prefill: the CUDA
kernels' wrappers and their plain PyTorch versions.

Port of ``repro.kernels.paged_attention``.  One kernel source
(``csrc/paged_attention.cu``) carries both variants:

* :func:`paged_attention_fused` — exact QK^T.  Per (batch row, kv head)
  the GQA query rows (``_rows_layout``) attend to the pages the block
  table names: logits ``q·k/√hd`` masked to ``t <= lengths[b] + r % sc``
  with ``NEG_INF``, a softmax, and ``acc / max(denom, 1e-30)``.
  Its plain version is ``paged_gather`` + ``chunk_decode_attention``.
* :func:`paged_attention_fused_sc` — the same with the paper's
  stochastic MUL for QK^T: per-row max-abs scales, fx16 operands, and
  Threefry words from the QUERY TOKEN's key at counter
  ``c0 = (t_abs·n_heads + head)·hd + d``, so a logit's bits depend only
  on (request key, query position, kv position, head, d).
  :func:`sc_qk_logits_host` is the one-token plain twin of those logits,
  :func:`sc_logits` / :func:`sc_logits_plain` all of a call's.

On the card a call is spread over every SM (:func:`paged_attention_plan`):
the SC logits as their own integer pass, the card's resident blocks
taking the live logits from a shared counter; an
online softmax · V per split of each row's pages (flash-decoding); and a
merge of the splits in split order.  :func:`paged_attention_split_plain`
is that decomposition in ordinary tensor ops, for the tests.

For CUDA tensors the wrappers launch the kernels or raise; for CPU
tensors they run the plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.sc_fused import encode_fx16
from repro_torch.kernels.sc_mul import (
    LANE_BITS,
    NSLICES,
    horner_step,
    popcount32,
)
from repro_torch.sc import ctr_rng

NEG_INF = -1e30  # matches models/attention.py
_DENOM_GUARD = 1e-30  # the output's divide guard
_SCALE_GUARD = 1e-30  # matches sc/encoding.py's max-abs clamp
_MASK32 = 0xFFFFFFFF
# elements per Threefry call in the plain SC logits (bounds its memory)
_PLAIN_CHUNK = 1 << 20
ROW_TILE = 16  # query rows per split-pass block (csrc kRowTile)
# threads per logits-pass block (<= csrc kMaxLogitThreads = 1,024): the
# fastest of 128-1,024 at phase A's decode and prefill and at a 1,024-token
# cache on the card (tools/paged_attention_bench.py --logit-threads)
MAX_LOGIT_THREADS = 256
NUM_SMS = 132  # H100 SXM


def _scale(hd: int) -> float:
    """``1 / sqrt(hd)`` in float32, as the reference constructs it."""
    hd32 = torch.tensor(float(hd), dtype=torch.float32)
    return float(1.0 / torch.sqrt(hd32))


def split_keys4(keys):
    """Per-token raw ``(..., 2)`` keys -> ``(..., 4)`` operand key words:
    split each token key, the query stream takes the first half and the
    key stream the second (the fused SC matmul's x/y split)."""
    split = ctr_rng.split(keys)  # (..., 2, 2)
    return torch.cat([split[..., 0, :], split[..., 1, :]], dim=-1)


def _rows_layout(q, kvh: int):
    """(b, sc, h, hd) queries -> (b, kvh, g*sc, hd) kernel rows.

    Row ``r`` of a (batch, kv-head) slice holds query head
    ``kvh_index * g + r // sc`` at chunk offset ``r % sc``.
    """
    b, sc, h, hd = q.shape
    g = h // kvh
    qg = q.reshape(b, sc, kvh, g, hd).permute(0, 2, 3, 1, 4)
    return qg.reshape(b, kvh, g * sc, hd)


def _rows_unlayout(out, *, sc: int, h: int):
    """Inverse of :func:`_rows_layout`."""
    b, kvh, rows, hd = out.shape
    g = rows // sc
    out = out.reshape(b, kvh, g, sc, hd).permute(0, 3, 1, 2, 4)
    return out.reshape(b, sc, h, hd)


def _check(q, k_pages, v_pages, block_table, lengths):
    b, sc, h, hd = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("k/v pages must both be (P, block_size, kvh, hd)")
    kvh = k_pages.shape[2]
    if k_pages.shape[3] != hd or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} vs pages {k_pages.shape}")
    if not q.dtype == k_pages.dtype == v_pages.dtype:
        raise ValueError("q and the k/v pages must share one dtype")
    if block_table.dim() != 2 or block_table.shape[0] != b:
        raise ValueError(f"block_table must be ({b}, nb)")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be ({b},)")


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """How one call is cut over the card (:func:`paged_attention_plan`).

    Pass 1 (SC only) has blocks of ``logit_threads`` threads, as many as
    the card holds at once (the launcher asks the occupancy API), which
    take the (kv position, query row, batch row, kv head) logits of the
    table in that order, the position slowest, from a counter on the
    card, and stop past the last position any row sees; pass 2 one block per (batch row, kv head, tile of
    ``ROW_TILE`` query rows, split of ``pages_per_split`` pages); pass 3,
    when ``splits > 1``, one block per (batch row, kv head, query row).
    Split blocks past their tile's last live page exit at once, so the
    work follows the lengths without the host reading them.
    """

    b: int
    kvh: int
    rows: int
    sc: int
    nb: int
    bs: int
    row_tiles: int
    pages_per_split: int
    splits: int
    logit_threads: int  # 0: exact QK^T, no logits pass

    @property
    def launches(self) -> int:
        """Device kernels one call launches."""
        return (self.logit_threads > 0) + 1 + (self.splits > 1)

    def last_page(self, length: int, row: int) -> int:
        """The last page query row ``row`` sees at this length."""
        return min(self.nb - 1, (length + row % self.sc) // self.bs)

    def row_splits(self, length: int, row: int) -> list:
        """[first, end) page ranges of the splits the row merges: the
        pages of each split that hold its live positions."""
        last, per = self.last_page(length, row), self.pages_per_split
        return [(p, min(p + per, last + 1)) for p in range(0, last + 1, per)]

    def live_blocks(self, lengths) -> dict:
        """The work of each pass at these (host) lengths: live logits
        (each computed by one block of pass 1), and pass 2's and pass 3's
        blocks that do work.  :func:`paged_attention_work` counts the
        same on the card."""
        per, tile = self.pages_per_split, ROW_TILE
        logits = split = 0
        for length in lengths:
            for r in range(self.rows):
                logits += min(self.nb * self.bs, length + r % self.sc + 1)
            for t in range(self.row_tiles):
                rows = range(t * tile, min(self.rows, (t + 1) * tile))
                last = max(self.last_page(length, r) for r in rows)
                split += last // per + 1
        return dict(
            logits=self.kvh * logits if self.logit_threads else 0,
            split=self.kvh * split,
            combine=self.b * self.kvh * self.rows if self.splits > 1 else 0,
        )


@functools.lru_cache(maxsize=256)
def paged_attention_plan(
    b: int, kvh: int, rows: int, sc: int, hd: int, nb: int, bs: int,
    nbit: int = 0,
) -> AttentionPlan:
    """Split count and tiles of one call: a pure function of the shapes.

    The context is cut into the fewest splits of whole pages that give
    the (batch row, kv head) pairs at least ``NUM_SMS`` blocks between
    them, so a long row's pages spread over the card instead of one
    block walking them (1 page a split at a 4-page table).  The split
    count depends on ``b``, ``kvh`` and ``nb`` only, never on the query
    rows: a row's softmax is then merged from the same splits in the
    same order whatever the width of the call, so a width-(k+1)
    speculative verify gives each row the bits a width-1 decode gives
    it.  (Counting row tiles too gave a 64-page table 32 splits at
    width 1 and 11 at width 5.)  The logits pass (``nbit > 0``) gives a
    logit's block one thread per (d, word) pair, 32 to
    ``MAX_LOGIT_THREADS``.
    """
    row_tiles = -(-rows // ROW_TILE)
    splits = min(nb, -(-NUM_SMS // (b * kvh)))
    per = -(-nb // splits)
    threads = 0
    if nbit:
        pairs = hd * (nbit // LANE_BITS)
        threads = min(MAX_LOGIT_THREADS, max(32, -(-pairs // 32) * 32))
    return AttentionPlan(
        b=b, kvh=kvh, rows=rows, sc=sc, nb=nb, bs=bs, row_tiles=row_tiles,
        pages_per_split=per, splits=-(-nb // per), logit_threads=threads,
    )


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def paged_attention_fused(q, k_pages, v_pages, block_table, lengths):
    """Fused paged attention, deterministic QK^T.

    q: (b, sc, h, hd) post-rope queries (chunk token i of row r sits at
    absolute position ``lengths[r] + i``, K/V already scattered);
    k/v_pages: (P, bs, kvh, hd) block pools; block_table: (b, nb);
    lengths: (b,) pre-chunk fill.  Returns (b, sc, h, hd) in q's dtype.
    """
    _check(q, k_pages, v_pages, block_table, lengths)
    if not q.is_cuda:
        return paged_attention_fused_plain(
            q, k_pages, v_pages, block_table, lengths
        )
    out = _launch(q, k_pages, v_pages, block_table, lengths, None)
    cuda_lib.launches["paged_attention_fused"] += 1
    return out


def paged_attention_fused_sc(
    keys,
    q,
    k_pages,
    v_pages,
    block_table,
    lengths,
    *,
    nbit: int,
    operand_bits: int = 10,
    quantize: bool = True,
):
    """Fused paged attention with the SC-sampled QK^T.

    keys: (b, sc, 2) raw per-token keys, each already folded from its
    request key and absolute position upstream.  Other operands as
    :func:`paged_attention_fused`.
    """
    _check(q, k_pages, v_pages, block_table, lengths)
    if nbit % LANE_BITS or nbit <= 0:
        raise ValueError("SC attention packs 32 cells per word")
    if keys.shape != q.shape[:2] + (2,):
        raise ValueError(f"keys must be {tuple(q.shape[:2]) + (2,)}")
    kw = dict(nbit=nbit, operand_bits=operand_bits, quantize=quantize)
    if not q.is_cuda:
        return paged_attention_fused_sc_plain(
            keys, q, k_pages, v_pages, block_table, lengths, **kw
        )
    keys = ctr_rng.raw_key(keys).contiguous()
    out = _launch(q, k_pages, v_pages, block_table, lengths, keys, **kw)
    cuda_lib.launches["paged_attention_fused_sc"] += 1
    return out


def sc_logits(
    keys,
    q,
    k_pages,
    block_table,
    lengths,
    *,
    nbit: int,
    operand_bits: int = 10,
    quantize: bool = True,
):
    """The SC logits of :func:`paged_attention_fused_sc` alone: its
    logits pass on the card.  Returns (b, kvh, rows, nb·bs) float32 in
    the ``_rows_layout`` row order, ``NEG_INF`` where the mask hides a
    position; equal bit for bit to :func:`sc_logits_plain`."""
    _check(q, k_pages, k_pages, block_table, lengths)
    if nbit % LANE_BITS or nbit <= 0:
        raise ValueError("SC attention packs 32 cells per word")
    kw = dict(nbit=nbit, operand_bits=operand_bits, quantize=quantize)
    if not q.is_cuda:
        return sc_logits_plain(keys, q, k_pages, block_table, lengths, **kw)
    keys = ctr_rng.raw_key(keys).contiguous()
    logits = _launch(q, k_pages, k_pages, block_table, lengths, keys,
                     logits_only=True, **kw)
    cuda_lib.launches["paged_attention_sc_logits"] += 1
    _, sc, h, _ = q.shape
    live = _live(lengths, h // k_pages.shape[2] * sc, sc, logits.shape[-1])
    return torch.where(live[:, None], logits, NEG_INF)


def paged_attention_work(
    q, k_pages, v_pages, block_table, lengths, keys=None, *, nbit: int = 0,
    operand_bits: int = 10, quantize: bool = True,
) -> dict:
    """One call of :func:`paged_attention_fused` (``keys=None``) or
    :func:`paged_attention_fused_sc` on the card, with its passes
    counting the work they did: ``logits`` computed, ``logit_blocks``
    that computed one, ``split`` blocks past the early exit, ``combine``
    blocks (integer atomics into a zeroed int32 array; a measurement the
    serving path never makes).  Counts one launch of that wrapper.
    Needs CUDA tensors."""
    if not q.is_cuda:
        raise ValueError("paged_attention_work counts the card's work")
    _check(q, k_pages, v_pages, block_table, lengths)
    counters = torch.zeros(4, dtype=torch.int32, device=q.device)
    if keys is None:
        _launch(q, k_pages, v_pages, block_table, lengths, None,
                counters=counters)
        cuda_lib.launches["paged_attention_fused"] += 1
    else:
        if nbit % LANE_BITS or nbit <= 0:
            raise ValueError("SC attention packs 32 cells per word")
        keys = ctr_rng.raw_key(keys).contiguous()
        _launch(q, k_pages, v_pages, block_table, lengths, keys, nbit=nbit,
                operand_bits=operand_bits, quantize=quantize,
                counters=counters)
        cuda_lib.launches["paged_attention_fused_sc"] += 1
    names = ("logits", "logit_blocks", "split", "combine")
    return dict(zip(names, counters.tolist()))


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_lib.load("paged_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention.argtypes = [p] * 12 + [i] * 2 + [p]
        lib.paged_attention.restype = ctypes.c_int
        lib.paged_attention_sc_logits.argtypes = [p] * 8 + [i, p]
        lib.paged_attention_sc_logits.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _launch(
    q,
    k_pages,
    v_pages,
    block_table,
    lengths,
    keys,
    *,
    nbit=0,
    operand_bits=10,
    quantize=True,
    logits_only=False,
    counters=None,
):
    dev = q.device
    tensors = (k_pages, v_pages, block_table, lengths)
    if keys is not None:
        tensors += (keys,)
    if any(t.device != dev for t in tensors):
        raise ValueError("all operands must lie on q's CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q dtype {q.dtype} is not float32 or bfloat16")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("block_table and lengths must be int32")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("k/v pages must be contiguous")
    b, sc, h, hd = q.shape
    # the split pass reads K/V rows in 16-byte loads
    if (hd * q.element_size()) % 16 or any(
        t.data_ptr() % 16 for t in (k_pages, v_pages)
    ):
        raise ValueError("every K/V row must start on 16 bytes: hd * "
                         "element size a multiple of 16, aligned pools")
    kvh, bs = k_pages.shape[2], k_pages.shape[1]
    nb = block_table.shape[1]
    g = h // kvh
    rows = g * sc
    plan = paged_attention_plan(b, kvh, rows, sc, hd, nb, bs,
                                nbit if keys is not None else 0)
    q = q.contiguous()
    bt = block_table.contiguous()
    ln = lengths.contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    logits = next_unit = parts = out = None
    if keys is not None:
        logits = torch.empty((b, kvh, rows, nb * bs), **f32)
        next_unit = torch.empty(1, dtype=torch.int32, device=dev)
    if not logits_only:
        out = torch.empty_like(q)
        if plan.splits > 1:
            parts = torch.empty((b, kvh, rows, plan.splits, hd + 2), **f32)
    dims = (ctypes.c_int * 15)(
        b, kvh, rows, hd, bs, nb, sc, h, g, nbit, 1 << operand_bits,
        int(quantize), plan.pages_per_split, plan.splits,
        plan.logit_threads,
    )
    ptr = (lambda t: None if t is None else t.data_ptr())
    bf16 = int(q.dtype == torch.bfloat16)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = cuda_lib.stream_ptr(dev)
        if logits_only:
            code = lib.paged_attention_sc_logits(
                q.data_ptr(), k_pages.data_ptr(), bt.data_ptr(),
                ln.data_ptr(), keys.data_ptr(), logits.data_ptr(),
                next_unit.data_ptr(), dims, bf16, stream,
            )
        else:
            code = lib.paged_attention(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                bt.data_ptr(), ln.data_ptr(), ptr(keys), ptr(logits),
                ptr(next_unit), ptr(parts), out.data_ptr(), ptr(counters),
                dims, bf16,
                int(keys is not None), stream,
            )
    cuda_lib.check(lib, code, "paged_attention")
    return logits if logits_only else out


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def paged_attention_fused_plain(q, k_pages, v_pages, block_table, lengths):
    """:func:`paged_attention_fused`'s function in ordinary tensor ops:
    the gathered cache view through ``chunk_decode_attention``."""
    from repro_torch.models import attention

    return attention.chunk_decode_attention(
        q,
        attention.paged_gather(k_pages, block_table),
        attention.paged_gather(v_pages, block_table),
        lengths,
    )


def _sc_counts(keys4, fxq, fxk, c0, *, nbit: int):
    """Pop-count core of the SC logits (int64 words masked to 32 bits).

    keys4: (bq, 4) operand key words; fxq: (bq, hd) and fxk: (bs, hd)
    fx16 words; c0: (bq, bs, hd) product counters.  Returns (bq, bs, hd)
    int64 pop-count totals.
    """
    nwords = nbit // LANE_BITS
    keys = keys4.to(torch.int64)
    kq0, kq1, kk0, kk1 = (keys[:, i, None, None, None] for i in range(4))
    c0_4 = c0[..., None]
    pq4 = fxq[:, None, :, None]
    pk4 = fxk[None, :, :, None]
    counts = torch.zeros(c0.shape, dtype=torch.int64, device=c0.device)
    wc = max(1, min(nwords, _PLAIN_CHUNK // max(c0.numel(), 1)))
    for w0 in range(0, nwords, wc):
        widx = torch.arange(
            w0, min(nwords, w0 + wc), dtype=torch.int64, device=c0.device
        )
        shape = c0.shape + (len(widx),)
        tq = torch.zeros(shape, dtype=torch.int64, device=c0.device)
        tk = torch.zeros_like(tq)
        for s in range(NSLICES):  # LSB -> MSB Horner ladder
            c1 = s * nwords + widx
            uq = ctr_rng.threefry2x32(kq0, kq1, c0_4, c1)[0]
            tq = horner_step(tq, uq, pq4, s)
            uk = ctr_rng.threefry2x32(kk0, kk1, c0_4, c1)[0]
            tk = horner_step(tk, uk, pk4, s)
        counts += popcount32(tq & tk).sum(dim=-1)
    return counts


def _sc_logits(q_blk, k_blk, keys4, c0, *, nbit, levels, quantize):
    """SC-sampled QK^T logits from exact q (bq, hd) / k (bs, hd) rows, in
    the reference's f32 order ``((total / nbit) * sq) * sk * scale``."""
    q_blk = q_blk.to(torch.float32)
    k_blk = k_blk.to(torch.float32)
    scq = torch.clamp_min(q_blk.abs().amax(dim=1), _SCALE_GUARD)
    sck = torch.clamp_min(k_blk.abs().amax(dim=1), _SCALE_GUARD)
    fxq = encode_fx16(q_blk.abs() / scq[:, None], levels, quantize)
    fxk = encode_fx16(k_blk.abs() / sck[:, None], levels, quantize)
    sgq = torch.sign(q_blk).to(torch.int64)
    sgk = torch.sign(k_blk).to(torch.int64)
    counts = _sc_counts(keys4, fxq, fxk, c0, nbit=nbit)
    signed = sgq[:, None, :] * sgk[None, :, :] * counts
    total = signed.sum(dim=-1).to(torch.float32)  # (bq, bs)
    est = total / nbit * scq[:, None] * sck[None, :]
    return est * _scale(q_blk.shape[-1])


def _counters(t_abs, heads, n_heads: int, hd: int):
    """``c0 = (t_abs·n_heads + head)·hd + d`` for (rows, T, hd)."""
    d = torch.arange(hd, dtype=torch.int64, device=t_abs.device)
    c0 = t_abs[None, :, None] * n_heads + heads[:, None, None]
    return (c0 * hd + d[None, None, :]) & _MASK32


def _live(lengths, rows: int, sc: int, t_len: int):
    """(b, rows, T) mask: query row r sees t <= lengths[b] + r % sc."""
    dev = lengths.device
    t = torch.arange(t_len, dtype=torch.int64, device=dev)
    r = torch.arange(rows, dtype=torch.int64, device=dev)
    q_pos = lengths.to(torch.int64)[:, None] + r[None, :] % sc  # (b, rows)
    return t[None, None, :] <= q_pos[:, :, None]


def sc_logits_plain(
    keys,
    q,
    k_pages,
    block_table,
    lengths,
    *,
    nbit: int,
    operand_bits: int = 10,
    quantize: bool = True,
):
    """:func:`sc_logits`' function in ordinary tensor ops: the SC logits
    of every (row, position) of each row's gathered view, then masked."""
    from repro_torch.models import attention

    b, sc, h, hd = q.shape
    kvh = k_pages.shape[2]
    g = h // kvh
    rows = g * sc
    kc = attention.paged_gather(k_pages, block_table).to(torch.float32)
    t_len = kc.shape[1]
    qr = _rows_layout(q, kvh).to(torch.float32)
    keys4 = split_keys4(ctr_rng.raw_key(keys))  # (b, sc, 4)
    rowk = keys4[:, None].expand(b, g, sc, 4).reshape(b, rows, 4)
    dev = q.device
    t_abs = torch.arange(t_len, dtype=torch.int64, device=dev)
    r = torch.arange(rows, dtype=torch.int64, device=dev)
    logits = torch.empty((b, kvh, rows, t_len), device=dev)
    for kh in range(kvh):
        c0 = _counters(t_abs, kh * g + r // sc, h, hd)
        for bi in range(b):
            logits[bi, kh] = _sc_logits(
                qr[bi, kh],
                kc[bi, :, kh],
                rowk[bi],
                c0,
                nbit=nbit,
                levels=1 << operand_bits,
                quantize=quantize,
            )
    live = _live(lengths, rows, sc, t_len)
    return torch.where(live[:, None], logits, NEG_INF)


def paged_attention_fused_sc_plain(
    keys,
    q,
    k_pages,
    v_pages,
    block_table,
    lengths,
    *,
    nbit: int,
    operand_bits: int = 10,
    quantize: bool = True,
):
    """:func:`paged_attention_fused_sc`'s function in ordinary tensor ops:
    SC logits over each row's whole gathered view, masked, softmax, PV."""
    from repro_torch.models import attention

    b, sc, h, hd = q.shape
    logits = sc_logits_plain(
        keys, q, k_pages, block_table, lengths, nbit=nbit,
        operand_bits=operand_bits, quantize=quantize,
    )
    vc = attention.paged_gather(v_pages, block_table).to(torch.float32)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrt,btkd->bkrd", w, vc)
    return _rows_unlayout(out, sc=sc, h=h).to(q.dtype)


def paged_attention_split_plain(
    q,
    k_pages,
    v_pages,
    block_table,
    lengths,
    keys=None,
    *,
    nbit: int = 0,
    operand_bits: int = 10,
    quantize: bool = True,
):
    """The kernels' decomposition in float32 tensor ops, for the tests.

    Exact (``keys=None``) or SC logits (``keys`` and ``nbit``), then per
    split of :func:`paged_attention_plan` a local (max, denom, acc), and
    the merge in split order of the splits that hold a live position of
    the row.  The main path never calls it.  Returns (b, sc, h, hd) in
    q's dtype.
    """
    from repro_torch.models import attention

    b, sc, h, hd = q.shape
    kvh, bs = k_pages.shape[2], k_pages.shape[1]
    nb = block_table.shape[1]
    rows = h // kvh * sc
    if keys is None:
        kc = attention.paged_gather(k_pages, block_table).to(torch.float32)
        qr = _rows_layout(q, kvh).to(torch.float32)
        logits = torch.einsum("bkrd,btkd->bkrt", qr, kc) * _scale(hd)
        live = _live(lengths, rows, sc, nb * bs)
        logits = torch.where(live[:, None], logits, NEG_INF)
    else:
        logits = sc_logits_plain(
            keys, q, k_pages, block_table, lengths, nbit=nbit,
            operand_bits=operand_bits, quantize=quantize,
        )
    vc = attention.paged_gather(v_pages, block_table).to(torch.float32)
    plan = paged_attention_plan(b, kvh, rows, sc, hd, nb, bs, nbit)
    span = plan.pages_per_split * bs
    pad = plan.splits * span - nb * bs
    lg = torch.nn.functional.pad(logits, (0, pad), value=NEG_INF)
    lg = lg.reshape(b, kvh, rows, plan.splits, span)
    vs = torch.nn.functional.pad(vc, (0, 0, 0, 0, 0, pad))
    vs = vs.reshape(b, plan.splits, span, kvh, hd)
    m_i = lg.amax(dim=-1)  # (b, kvh, rows, splits)
    p = torch.exp(lg - m_i[..., None])
    d_i = p.sum(dim=-1)
    acc_i = torch.einsum("bkrsp,bspkd->bkrsd", p, vs)
    # the splits a row merges: those up to the one of its last position
    dev = q.device
    r = torch.arange(rows, device=dev)
    last = torch.clamp(
        lengths.to(torch.int64)[:, None] + r[None, :] % sc, max=nb * bs - 1
    )  # (b, rows)
    s_idx = torch.arange(plan.splits, device=dev)
    merged = s_idx[None, None, :] <= (last // span)[:, :, None]
    merged = merged[:, None]  # (b, 1, rows, splits)
    m = torch.where(merged, m_i, -torch.inf).amax(dim=-1, keepdim=True)
    e = torch.where(merged, torch.exp(m_i - m), 0.0)
    den = (d_i * e).sum(dim=-1)
    acc = (acc_i * e[..., None]).sum(dim=-2)
    out = acc / torch.clamp_min(den, _DENOM_GUARD)[..., None]
    return _rows_unlayout(out, sc=sc, h=h).to(q.dtype)


def sc_qk_logits_host(
    key,
    q_row,
    k_rows,
    t_abs,
    head: int,
    n_heads: int,
    *,
    nbit: int,
    operand_bits: int = 10,
    quantize: bool = True,
):
    """Plain twin of the kernel's SC QK^T for ONE query token.

    key: raw (2,) token key; q_row: (hd,) post-rope query; k_rows:
    (T, hd) cache rows at absolute positions ``t_abs`` (T,); ``head`` is
    the query's flat head index.  Returns the (T,) pre-mask logits, bit
    for bit the kernel's.
    """
    hd = q_row.shape[-1]
    keys4 = split_keys4(ctr_rng.raw_key(key)[None])  # (1, 4)
    t_abs = torch.as_tensor(t_abs, dtype=torch.int64, device=q_row.device)
    heads = torch.tensor([head], dtype=torch.int64, device=q_row.device)
    c0 = _counters(t_abs, heads, n_heads, hd)
    logits = _sc_logits(
        q_row[None],
        k_rows,
        keys4,
        c0,
        nbit=nbit,
        levels=1 << operand_bits,
        quantize=quantize,
    )
    return logits[0]
