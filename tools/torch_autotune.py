"""Refresh the PyTorch/CUDA port's launch-tile cache on the card.

Times every candidate launch shape of the port's bit-exact kernels at
the requested call shapes through their real wrappers on the GPU (a
warm-up first; kernel 1 with CUDA events, the attention calls on the
card's clock from the profiler's kernel records, since their host time
exceeds their device time) and writes the winners, each with its µs and
the card's name, to the versioned table the wrappers consult
(``src/repro_torch/sc/autotune_cache.json`` by default, or
``$REPRO_TORCH_SC_AUTOTUNE_CACHE``):

* kernel 1 (``csrc/sc_fused.cu``): threads a block and K split, at
  ``--shapes MxKxN``;
* kernels 2 and 3 (``csrc/paged_attention.cu``): the SC logits pass's
  block size, at ``--attn-shapes ROWSxBLOCKxHD@L1,L2,...`` (query rows
  per kv head, page size, head dim; each batch row's cache length
  before the chunk, or without ``@`` one row whose chunk ends its
  table) with ``--attn-heads``, ``--attn-pages`` and ``--attn-dtype``;
  ``--attn-nbit 0`` is the exact QK^T (kernel 2), whose one candidate
  is the heuristic.

    PYTHONPATH=src python3 tools/torch_autotune.py      # the main path's
    PYTHONPATH=src python3 tools/torch_autotune.py --shapes 2x896x128 \\
        --attn-shapes 7x16x64@15,11 --out /tmp/cache.json

No tile changes a bit (``src/repro_torch/sc/autotune.py``), so the cache
moves only time.  A shape keeps its heuristic tile unless a candidate
beats it by ``MIN_GAIN``: a difference inside the run-to-run spread
moves no launch.  It needs a CUDA device: without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.sc import autotune

# The main path's kernel-1 shapes (qwen2-0.5b at full width: d_model 896,
# 2 KV heads of 64, d_ff 4,864, vocab 151,936 tied): chip_smoke.py's phase
# A decode rows (M = 2) at wq / wo, wk / wv, mlp_wi (gate and up), mlp_wo
# and the unembed; phase F's prefill of a 12-token prompt at the same
# projections, and its unembed of the last position (M = 1); phase S's
# wdt (mamba2-370m, M = 2, d_model 1,024 -> 32 heads).
DEFAULT_SHAPES = [
    "2x896x896", "2x896x128", "2x896x9728", "2x4864x896", "2x896x151936",
    "12x896x896", "12x896x128", "12x896x9728", "12x4864x896",
    "1x896x151936", "2x1024x32",
]
# phase A's attention (14 query heads over 2 KV heads: 7 rows a query
# position, pages of 16, head dim 64, 4 pages a row): its decode ticks
# (1 position, rows at 15 and 11) and its first prefill chunk (8
# positions, rows at 8 and 0)
DEFAULT_ATTN_SHAPES = ["7x16x64@15,11", "56x16x64@8,0"]
# the least gain over the heuristic that moves a launch: the spread of
# kernel 1's times between two runs of this tool on one H100 reached
# 2 % (2x896x896: 4,728.3 / 4,657.8 µs for one tile)
MIN_GAIN = 0.03


def parse_attn_shape(s: str) -> tuple:
    """``ROWSxBLOCKxHD[@L1,L2,...]`` -> ((rows, block, hd), lengths or
    None)."""
    shape, _, lens = s.partition("@")
    try:
        lengths = [int(v) for v in lens.split(",")] if lens else None
    except ValueError:
        raise SystemExit(f"bad lengths in {s!r}; expected e.g. 7x16x64@15,11")
    return parse_shape(shape, "ROWSxBLOCKxHD[@L1,L2,...]"), lengths


def parse_shape(s: str, what: str = "MxKxN") -> tuple:
    try:
        dims = tuple(int(v) for v in s.lower().split("x"))
    except ValueError:
        dims = ()
    if len(dims) != 3 or min(dims) < 1:
        raise SystemExit(f"bad shape {s!r}; expected {what}, e.g. 2x896x128")
    return dims


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="*", default=DEFAULT_SHAPES,
                    metavar="MxKxN", help="kernel-1 call shapes to tune")
    ap.add_argument("--nbit", type=int, nargs="+", default=[1024],
                    help="stochastic bits per product (multiple of 32)")
    ap.add_argument("--attn-shapes", nargs="*", default=DEFAULT_ATTN_SHAPES,
                    metavar="ROWSxBLOCKxHD@L1,L2",
                    help="attention call shapes to tune, with each batch "
                    "row's cache length")
    ap.add_argument("--attn-nbit", type=int, nargs="+", default=[0, 1024],
                    help="0: exact QK^T (kernel 2); else SC (kernel 3)")
    ap.add_argument("--attn-heads", type=int, nargs=2, default=[14, 2],
                    metavar=("H", "KVH"), help="query and KV heads")
    ap.add_argument("--attn-pages", type=int, default=4,
                    help="pages a row's block table holds")
    ap.add_argument("--attn-dtype", nargs="+",
                    default=["bfloat16", "float32"],
                    choices=["bfloat16", "float32"],
                    help="q's and the pages' dtype (the serving path's "
                    "is bfloat16)")
    ap.add_argument("--out", default=None,
                    help="cache file (default: the shipped table, or "
                    "$REPRO_TORCH_SC_AUTOTUNE_CACHE)")
    ap.add_argument("--iters", type=int, default=3,
                    help="timing repetitions per candidate")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    for nbit in args.nbit:
        if nbit <= 0 or nbit % 32:
            raise SystemExit(f"--nbit {nbit} is not a positive multiple "
                             "of 32")
    for nbit in args.attn_nbit:
        if nbit < 0 or nbit % 32:
            raise SystemExit(f"--attn-nbit {nbit} is not 0 or a positive "
                             "multiple of 32")
    shapes = [parse_shape(s) for s in args.shapes]
    attn = [parse_attn_shape(s) for s in args.attn_shapes]

    import torch

    if not torch.cuda.is_available():
        print("torch_autotune: no CUDA device; the tiles are timed on the "
              "card", file=sys.stderr)
        return 1
    card = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)

    entries = autotune.load_cache(args.out)
    verbose = not args.quiet

    def record(key, best, best_us, table, heur):
        heur_us = dict(table)[heur]
        print(f"  best {best.kwargs()} at {best_us:.1f} us "
              f"(heuristic {heur.kwargs()} at {heur_us:.1f} us)",
              flush=True)
        if best_us > (1 - MIN_GAIN) * heur_us:
            best, best_us = heur, heur_us  # within the spread
        entries[key] = dict(best.kwargs(), wall_us=round(best_us, 1),
                            heuristic_us=round(heur_us, 1), card=card)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m, k, n in shapes:
        for nbit in args.nbit:
            cands = autotune.candidate_tiles(m, k, n, nbit, sms)
            print(f"tuning {m}x{k}x{n} nbit={nbit} ({len(cands)} "
                  "candidates)", flush=True)
            best, best_us, table = autotune.tune_shape(
                m, k, n, nbit, candidates=cands, iters=args.iters,
                verbose=verbose)
            record(autotune.cache_key(m, k, n, nbit), best, best_us, table,
                   autotune.heuristic_tile(m, k, n, nbit, sms))
    for (rows, bs, hd), lengths in attn:
        for dtype in args.attn_dtype:
            for nbit in args.attn_nbit:
                cands = autotune.candidate_attn_tiles(rows, bs, hd, nbit)
                print(f"tuning attn {rows}x{bs}x{hd} nbit={nbit} {dtype} "
                      f"({len(cands)} candidates)", flush=True)
                best, best_us, table = autotune.tune_attn_shape(
                    rows, bs, hd, nbit, candidates=cands, iters=args.iters,
                    verbose=verbose, heads=tuple(args.attn_heads),
                    lengths=lengths, num_pages=args.attn_pages, dtype=dtype)
                record(autotune.attn_cache_key(rows, bs, hd, nbit, dtype),
                       best, best_us, table,
                       autotune.heuristic_attn_tile(rows, bs, hd, nbit))
    path = autotune.save_cache(entries, args.out)
    autotune.reset_cache()
    print(f"[wrote {path}: {len(entries)} entries, "
          f"version {autotune.CACHE_VERSION}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
