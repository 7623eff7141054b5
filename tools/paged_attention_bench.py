"""Time the two paged-attention kernels on the card at ``chip_smoke.py``'s
attention shapes, for a checkout given by its ``src`` directory.

    python3 tools/paged_attention_bench.py [--src DIR] [--tag NAME]
                                           [--heads qwen|moe|hyb]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
so the same inputs can time an unpacked parent tree and this one in
turns (parent, change, change, parent: one process each).  The shapes,
inputs, timers and the SDPA yardstick are ``chip_smoke.py``'s
(``ATTN_CASES``, ``_attn_inputs``, ``time_ms``, ``device_trace``,
``_sdpa_ms``); ``--heads moe`` / ``hyb`` take phase M's / H's heads and
cases (``MOE_ATTN_CASES``, ``HYB_ATTN_CASES``) instead of qwen2-0.5b's.  Prints the card's name and power limit, then one JSON
line per (shape, kernel): the median CUDA-event ms of a call of
``paged_attention_fused`` (exact QK^T) or ``paged_attention_fused_sc``
(nbit 1024), the device ms and launches of its ``paged_attn`` kernels in
one call under ``torch.profiler``, the host ms per call over 200
back-to-back calls (the SC kernel at the 1,024-token cache excepted:
its device time decides there), and SDPA's ms beside kernel 2.  Needs a
CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_ms(torch, fn, calls=200):
    """Host ms per call over ``calls`` back-to-back calls (one sync at the
    end): the wrapper's own cost where the device is quicker."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="this")
    ap.add_argument("--heads", choices=("qwen", "moe", "hyb"),
                    default="qwen")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # puts this checkout's src first on the path
    import torch

    sys.path.insert(0, os.path.abspath(args.src))
    if not torch.cuda.is_available():
        print("paged_attention_bench: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import attention

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cases, heads = {
        "qwen": (cs.ATTN_CASES, cs.QWEN_HEADS),
        "moe": (cs.MOE_ATTN_CASES, cs.MOE_HEADS),
        "hyb": (cs.HYB_ATTN_CASES, cs.HYB_HEADS),
    }[args.heads]
    for case, sc, lengths, nb in cases:
        rng = np.random.default_rng(2)
        keys, q, kp, vp, bt, ln = cs._attn_inputs(rng, sc, lengths, nb,
                                                  heads=heads)
        calls = {
            "paged_attention_fused": (
                lambda: pa.paged_attention_fused(q, kp, vp, bt, ln)),
            "paged_attention_fused_sc": (
                lambda: pa.paged_attention_fused_sc(
                    keys, q, kp, vp, bt, ln, nbit=1024)),
        }
        for name, kern in calls.items():
            exact = name == "paged_attention_fused"
            _, tr = cs.device_trace(kern)
            dev, n = cs.kernel_ms(tr, "paged_attn")
            rec = dict(tag=args.tag, shape=case, sc=sc, lengths=lengths,
                       nb=nb, kernel=name, ms=cs.time_ms(kern, 20 if exact
                                                         else 5),
                       device_ms=dev, device_launches=n,
                       all_device_ms=tr["device_ms"])
            if case != "long" or exact:
                rec["host_ms"] = host_ms(torch, kern)
            if exact:
                rec["library_ms"] = cs._sdpa_ms(q, kp, vp, bt, ln, attention)
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
