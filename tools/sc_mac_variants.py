"""Time textual variants of the moment kernel on the card: where its time goes.

    python3 tools/sc_mac_variants.py [--variants base,noepi,...] [--reps N]
    python3 tools/sc_mac_variants.py --splits [--reps N]
    python3 tools/sc_mac_variants.py --fit SWEEP_LOG

Each variant is ``src/repro_torch/csrc/sc_mac.cu`` with one piece of work
cut out (a string replacement, so a variant whose anchor is gone fails
loudly).  All variants build at once with the flags of
``kernels/cuda_lib.py`` into ``src/repro_torch/build/variants/``, then run
in turns (each variant, then all again in reverse order) through the
wrapper at three trainer shapes (M = 512), on the operand grid
(``on_grid=True``, as ``pallas_moment`` launches it) and off it.  Every
variant but ``base`` computes a wrong result on purpose: its time says
what the cut work costs, its error is printed only to show the cut took.

Prints one JSON line per (variant, shape, grid) with both medians of
CUDA-event times (ms) and the error against the plain version, and the
card's name and power limit first.  Needs a CUDA device and ``nvcc``.

``--splits`` instead times the unchanged kernel at every split-K count
(up to 40) of the three trainer shapes whose tiles underfill the card
(mlp_wo, wq, wk at M = 512, on the grid), split pass included, in turns
(all counts, then again in reverse): the data ``sc_mac_plan``'s cost
terms are set from.  One JSON line per (shape, splits) with both
medians, the blocks and waves, the error against the plain version and
whether the plan picks it, then the fit of ``sc_mac_plan``'s cost model
to those times.  ``--fit`` refits a saved ``--splits`` output (no device
needed).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels import sc_mac as km  # noqa: E402

# name -> [(text in sc_mac.cu, its replacement)]
VARIANTS = {
    "base": [],
    # the epilogue's output stores (the noise loads go with them)
    "noepi": [(
        "    if (!index(i, idx)) continue;\n    args.out[idx]",
        "    if (!index(i, idx) || args.M > 0) continue;\n    args.out[idx]",
    )],
    # the producer's derived x operands (the MMAs read stale tiles)
    "noderive": [(
        "      derive_x<kGrid>(sm.x[s], sm.d[b], ptid);\n", "",
    )],
    # the w tiles' TMA loads (the MMAs read whatever the ring holds)
    "nowload": [
        ("mbar_expect_tx(&sm.full[s], (kWTileFloats + kXTileFloats) * 4);",
         "mbar_expect_tx(&sm.full[s], kXTileFloats * 4);"),
        ("      if constexpr (kKMajor) {\n        tma_load_2d(sm.w[s]",
         "      if constexpr (false) {\n        tma_load_2d(sm.w[s]"),
        ("        for (int b = 0; b < kBN / 32; ++b) {\n          tma_load_2d",
         "        for (int b = 0; b < 0; ++b) {\n          tma_load_2d"),
    ],
    # the x tiles' TMA loads
    "noxload": [
        ("mbar_expect_tx(&sm.full[s], (kWTileFloats + kXTileFloats) * 4);",
         "mbar_expect_tx(&sm.full[s], kWTileFloats * 4);"),
        ("      tma_load_2d(sm.x[s], &xmap, &sm.full[s], k, m0);\n", ""),
    ],
    # every MMA of a k8 step but the mean's first
    "onemma": [(
        "  wgmma_rs(av, a[0].ahi, a[1].ahi, a[2].ahi, a[3].ahi, desc(2));\n"
        "  wgmma_rs<-1>(av, a[0].qhi, a[1].qhi, a[2].qhi, a[3].qhi, "
        "desc(4));\n"
        "  wgmma_rs<-1>(av, a[0].qhi, a[1].qhi, a[2].qhi, a[3].qhi, "
        "desc(5));\n"
        "  wgmma_rs<-1>(av, a[0].qlo, a[1].qlo, a[2].qlo, a[3].qlo, "
        "desc(4));\n"
        "  if constexpr (!kGrid) {",
        "  if constexpr (false) {",
    )],
}

# (name, K, N, w is the K-major view) at M = 512
SHAPES = (
    ("unembed", 896, 151936, True),
    ("mlp_wi", 896, 9728, False),
    ("mlp_wo", 4864, 896, False),
)


# (name, K, N) at M = 512 whose output tiles underfill the 132 SMs
SPLIT_SHAPES = (("mlp_wo", 4864, 896), ("wq", 896, 896), ("wk", 896, 128))


def split_candidates(k: int, most: int = 40) -> list:
    """Distinct (splits, stages per split) of a K range, fewest first."""
    nk = -(-k // km.BLOCK_K)
    out = []
    for want in range(1, min(nk, most) + 1):
        per = -(-nk // want)
        splits = -(-nk // per)
        if not out or out[-1][0] != splits:
            out.append((splits, per))
    return out


def sweep_splits(reps: int) -> None:
    gen = torch.Generator(device="cuda").manual_seed(1)

    def grid(shape):
        v = torch.rand(shape, generator=gen, device="cuda") * 2 - 1
        return torch.round(v * 1024) / 1024

    m = 512
    cases = []
    for name, k, n in SPLIT_SHAPES:
        x, w = grid((m, k)), grid((k, n))
        z = torch.randn((m, n), generator=gen, device="cuda")
        ref = km.sc_mac_fused_plain(x, w, z)
        for splits, per in split_candidates(k):
            cases.append((name, splits, per, x, w, z, ref))
    plan = km.sc_mac_plan
    res: dict = {}
    try:
        for name, splits, per, x, w, z, ref in cases + cases[::-1]:
            km.sc_mac_plan = lambda m_, n_, k_, s=splits, p=per: (
                s, p * km.BLOCK_K)

            def run():
                return km.sc_mac_fused(x, w, z, on_grid=True)

            err = float((run() - ref).abs().max() / ref.abs().max())
            res.setdefault((name, splits, per), []).append(
                (time_ms(run, reps), err))
    finally:
        km.sc_mac_plan = plan
    rows = []
    for name, k, n in SPLIT_SHAPES:
        tiles = -(-n // km.BLOCK_N) * -(-m // km.BLOCK_M)
        pick = plan(m, n, k)
        for splits, per in split_candidates(k):
            runs = res[(name, splits, per)]
            rows.append(dict(
                case=name, shape=[m, k, n], splits=splits,
                stages_per_split=per, blocks=tiles * splits,
                waves=-(-(tiles * splits) // km.NUM_SMS),
                ms=[ms for ms, _ in runs],
                max_abs_err=max(e for _, e in runs),
                plan_picks=pick == (splits, per * km.BLOCK_K),
            ))
            print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"fit": fit_splits(rows)}), flush=True)


def fit_splits(rows) -> dict:
    """Least squares of t = t0 + a·waves·(stages per split + c0) +
    b·splits·M·N over the sweep's rows (median of each row's times), for
    c0 in 0, 0.5, .., 8: the prologue term c0 with the least residual,
    the rest's fit at c0 = 0 and 2, and a/b, the outputs of partial sums
    that cost one stage-time (log2)."""
    y = np.array([np.median(r["ms"]) for r in rows])

    def fit(c0):
        a = np.array([[1.0, r["waves"] * (r["stages_per_split"] + c0),
                       r["splits"] * r["shape"][0] * r["shape"][2]]
                      for r in rows])
        coef = np.linalg.lstsq(a, y, rcond=None)[0]
        return coef, float(((a @ coef - y) ** 2).sum())

    c0s = [c / 2 for c in range(17)]
    best = min(c0s, key=lambda c: fit(c)[1])
    out = {"points": len(rows), "best_c0": best}
    for c0 in (0.0, 2.0):
        coef, rss = fit(c0)
        out[f"c0={c0:g}"] = dict(
            t0_ms=float(coef[0]), stage_us=float(coef[1] * 1e3),
            log2_outputs_per_stage=float(np.log2(coef[1] / coef[2])),
            rss=rss,
        )
    return out


def build(names) -> dict:
    src = (cuda_lib.CSRC / "sc_mac.cu").read_text()
    out_dir = cuda_lib.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"variant {name}: anchor not in sc_mac.cu")
            text = text.replace(old, new)
        cu = out_dir / f"sc_mac_{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"libsc_mac_{name}.so"
        cmd = [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS,
               "-I", str(cuda_lib.CSRC), "-o", str(lib), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} failed to build:\n{text}")
        libs[name] = str(lib)
    return libs


def use(path: str) -> None:
    """Point the wrapper at one variant's library."""
    lib = ctypes.CDLL(path)
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    cuda_lib._LIBS["sc_mac"] = lib
    km._LIB = None


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--splits", action="store_true",
                    help="time every split-K count instead of variants")
    ap.add_argument("--fit", metavar="SWEEP_LOG",
                    help="fit the plan's cost model to a saved sweep")
    args = ap.parse_args(argv)
    if args.fit:
        with open(args.fit) as f:
            rows = [json.loads(ln) for ln in f if ln.startswith('{"case"')]
        print(json.dumps({"fit": fit_splits(rows)}))
        return 0
    if not torch.cuda.is_available():
        print("sc_mac_variants: no CUDA device", file=sys.stderr)
        return 1
    names = args.variants.split(",")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(smi, flush=True)
    if args.splits:
        sweep_splits(args.reps)
        return 0
    libs = build(names)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def grid(shape):
        v = torch.rand(shape, generator=gen, device="cuda") * 2 - 1
        return torch.round(v * 1024) / 1024

    cases = {}
    for name, k, n, kmajor in SHAPES:
        x = grid((512, k))
        w = grid((n, k)).T if kmajor else grid((k, n))
        z = torch.randn((512, n), generator=gen, device="cuda")
        cases[name] = (x, w, z, km.sc_mac_fused_plain(x, w, z))
    res: dict = {}
    for name in names + names[::-1]:
        use(libs[name])
        for case, (x, w, z, ref) in cases.items():
            for on_grid in (True, False):
                def run():
                    return km.sc_mac_fused(x, w, z, on_grid=on_grid)

                err = float((run() - ref).abs().max() / ref.abs().max())
                ms = time_ms(run, args.reps)
                res.setdefault((name, case, on_grid), []).append((ms, err))
    for (name, case, on_grid), runs in res.items():
        print(json.dumps(dict(
            variant=name, case=case, on_grid=on_grid,
            ms=[ms for ms, _ in runs],
            max_abs_err=max(e for _, e in runs),
        )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
