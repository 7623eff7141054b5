"""Readings of a training cell's comparison with its program, its
control or a planted fault in the program's place, on the card at the
cell's own size (or, with ``--device cpu``, wherever a test runs it).
Not part of a benchmark run.

    python3 perfbench/control.py --workload NAME --mode MODE --seeds 1 2 3

``--mode``: ``program`` (the program's set-up steps as a run takes
them, no window: the readings a limit's lower end comes from), ``tf32``
(the control: the plain reference with its float32 matmuls in TF32 in
the program's place), or a fault planted under the program's step
(``half_batch``, ``frozen``; see ``drivers/train.py``).  Prints one JSON
line a seed with each number, and whether the cell's own limits call
that reading correct (``run.is_correct``).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from perfbench import run  # noqa: E402  (puts the checkout's src/ first)
from perfbench.drivers import train  # noqa: E402
from perfbench.ref import train as ref_train  # noqa: E402

MODES = ("program", "tf32", "half_batch", "frozen")


def readings(cell, mode: str) -> dict:
    """``{number: value}`` of the cell's comparison with ``mode`` in the
    program's place."""
    if mode in ("program", "half_batch", "frozen"):
        cell.fault = None if mode == "program" else mode
        cell.seconds = 0.0
        return {name: v for name, v, _ in train.run(cell)["checks"]}
    if mode != "tf32":
        raise ValueError(f"unknown mode {mode!r}")
    source = train.batch_source(cell)
    batches = [source() for _ in range(cell.mix["checked_steps"])]
    ref = train.reference_readings(cell, batches)
    probe = ref_train.UnembedProbe()
    ctl = train.reference_readings(cell, batches, tf32=True, probe=probe)
    ctl["dx"] = train.judge_unembed(cell, probe)
    return train.gaps(ctl, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=MODES, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    for seed in args.seeds:
        cell = run.load_cell(bench, args.workload, seed, 0.0, False,
                             torch.device(args.device))
        limits = dict(cell.limits)
        # every number is read, whether the cell's limits name it or not
        cell.limits = {k: math.inf for k in ("loss", "grad", "change", "dx")}
        got = readings(cell, args.mode)
        checks = [(k, got[k], lim) for k, lim in limits.items()]
        print(json.dumps({"workload": cell.name, "mode": args.mode,
                          "seed": seed, **got,
                          "correct": run.is_correct(checks)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
