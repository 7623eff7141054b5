"""Drive the PyTorch/CUDA port's paged SC serving path, its trainer,
and its validation / faulty-device path on one GPU.

    python3 chip_smoke.py [--layers N]

Phases, each printing one JSON line (any failure raises, so the exit
code is non-zero):

1. environment (card name and power limit, torch / CUDA / nvcc versions)
   and the build of every CUDA kernel from ``src/`` (one ``nvcc`` per
   source, all at once);
2. each kernel against its plain PyTorch version on the card at the
   main paths' shapes (kernel 4 also at every size phase V launches;
   ``sc_fused`` and ``sc_mul_popcount`` bit-equal; both paged-attention
   kernels within 1e-5 in float32 and bit-equal over two launches at
   phase A's decode and prefill shapes, over a 1,024-token cache and
   with A's decode rows in that 64-page table, the SC one's logits pass
   bit-equal to the plain logits, each with the device ms and kernels
   of one traced call and the work of each of its passes counted on the
   card, equal to the plan's count (at A's decode at least one logits
   block an SM), and over the 1,024-token cache a row's output at width
   1 bit-equal to row 0 of a width-3 call; both moment kernels and the moment
   kernel's split-K pass within 1e-5 of max |out|, plus the in-kernel
   noise's mean and variance, and two launches of the moment kernel
   bit-equal), with its median time, the plain version's time, the
   least time the card could take (``bound_ms``; for the moment kernels
   the faster of 3xTF32 on the tensor cores and FP32 FMAs, with the FP32
   bound beside it), and a PyTorch yardstick where one computes the
   same function (``scaled_dot_product_attention``; three float32
   ``torch.matmul`` calls plus the moment epilogue, timed in turns with
   the kernel); the SASS census must show the moment kernel's wgmma
   (HGMMA) opcodes;
3. serve phase A: qwen2-0.5b at full width, depth cut to ``--layers``
   (default 2), bf16, random weights from seed 0, ``pallas_bitexact``
   (the fused SC matmul kernel) with ``fused_sc`` attention at
   nbit 1024: two greedy requests through ``build_engine``; decode
   tick 3 under ``torch.profiler``: the SC attention kernels' device
   time and launches, which must be the plan's per call;
4. serve phase B: phase A's model with ``paged_attn="fused"``, one slot,
   one request;
   serve phase P: phase A's model with prefix caching and speculative
   decoding.  Three greedy requests sharing a 32-token prefix (one is
   the prefix alone, so its adoption copies on write; the first is fed
   past the prefix before the others arrive) under
   ``rng_mode="content"`` with the cache off, then on: equal tokens,
   at least 32 hit tokens, fewer prefill tokens, a copy-on-write.  Phase
   A's prompts with ``speculative=True, spec_k=2`` (a ``moment`` draft
   and a width-3 verify): tokens equal to phase A's; its first
   speculative tick traced (kernel 3's launches per call and, counted
   on the card, the verify call's work must be the plan's at width 3);
   the cache and speculation together: tokens equal to the cache-on
   run's; the ms of each draft and verify step; and one decode step at
   width 1 against the same token as row 0 of a width-3 step: logits
   and K/V bit-equal;
5. the tiny parity-test configuration served on the card and on the CPU
   (``device="cpu"``, plain versions) in this process: equal tokens;
6. train phase T: qwen2-0.5b at full width, depth ``--layers``, float32,
   ``pallas_moment`` (the fused moment kernel) at nbit 1024 with
   ``remat="full"``, batch 8 x seq 64, through
   ``repro_torch.launch.train.main``: 4 steps, a checkpoint every 2, a
   failure injected before the fourth (``--inject-failure-at 3``, a
   0-based index) and recovered from the step-2 checkpoint; then an
   uninterrupted run from the same seed, whose losses must equal the
   first run's at every step; then one profiled step;
7. the tiny trainer (paper-sc smoke, ``pallas_moment``) for 2 steps on
   the card and on the CPU in this process: losses within 1e-4;
8. validation phase V: qwen2-0.5b layer-0 weights at full width, one
   decode row through ``sc_dot`` under ``pallas_bitexact`` (the packed
   kernel, fed its stream in chunks) for wk, wv, wq and wo, each equal
   bit for bit to ``pallas_fused`` under the same key; the wq call once
   more under ``torch.profiler`` (kernel 4's and the stream's device
   time); then one ``array``-backend call per numerics size class
   (packed kernel, binomial, moment);
9. serve phase D: qwen2-0.5b at full width, depth ``--layers``, on the
   ``harsh`` faulty device (``fault_profile``, so every matmul runs on
   the ``array`` simulator) with ``fused_attention=True`` and
   ``collect_arch_trace=True``: two greedy requests, the arch bill, the
   bit-error census and one decode tick under ``torch.profiler`` (the
   device noise, its powers, kernel 2, the idle share); then the SMOKE
   model on the ``tiny`` device on the card and on the CPU: equal
   tokens;
10. the kernels line and the device line.

Launch counts are reset just before phases A, B, P, T, V and D and read
just after each; a kernel of a phase's path that did not launch fails
the run.  Without a CUDA device the script exits non-zero before
printing any result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# Integer issue model of an H100 SM (NVIDIA Hopper architecture white
# paper; sub-partition pipes): 4 sub-partitions each issue one 32-lane
# warp instruction per clock, so at most 128 lane operations per clock;
# logic ops and funnel shifts (LOP3, SHF) run only on the integer ALU
# pipe, 64 lanes per clock, while adds may also issue as IMAD on the FMA
# pipe.  The bound of an SC kernel is the larger of the two limits.
ISSUE_PER_SM_CLOCK = 128
ALU_PER_SM_CLOCK = 64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak (NVIDIA H100 datasheet)
FP32_FLOPS = 67e12  # H100 SXM, outside the tensor cores (same datasheet)
FP32_LANES_PER_SM = 128  # FP32 FMA lanes per Hopper SM (white paper)
# Dense TF32 flops per SM clock on the tensor cores: the datasheet's 495
# TFLOP/s over 132 SMs at ~1.83 GHz.  Taken at the card's max SM clock,
# as the FP32 rate is, so the two routes of a bound share one clock.
TF32_FLOPS_PER_SM_CLOCK = 2048
# One Threefry-2x32 call as csrc/sc_device.cuh writes it, counting only
# what its first output word needs (the last round's rotate and xor of
# x1 are dead): 19 funnel-shift rotates and 19 xors on the ALU pipe, plus
# one Horner-ladder select (LOP3) per slice; 20 round adds, 2 adds per
# key injection of the first four groups, 1 in the last, 1 initial add
# (the other folds into the product's counter).  The "sass" phase prints
# the compiled opcode mix these counts are checked against.
THREEFRY_ALU = 19 * 2 + 1
THREEFRY_ADDS = 20 + 4 * 2 + 1 + 1


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def sc_mul_ops(nbit: int) -> tuple:
    """(ALU-pipe ops, all integer ops) of one SC MUL at ``nbit`` cells:
    2 operands x 16 slices x nbit/32 words of Threefry + ladder, plus an
    AND, a pop-count and an add per word."""
    nwords = nbit // 32
    alu = nwords * (2 * 16 * THREEFRY_ALU + 2)
    return alu, alu + nwords * (2 * 16 * THREEFRY_ADDS + 1)


def int_bound_s(n_mul: int, nbit: int, rates: dict) -> float:
    alu, total = sc_mul_ops(nbit)
    return max(n_mul * alu / rates["alu"], n_mul * total / rates["issue"])


def time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs (one warm-up)."""
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


def device_trace(fn, ranges=()):
    """Run ``fn`` once under ``torch.profiler``.  Returns (its result,
    a dict): the host ms of the call (the profiler slows the host), the
    device ms of all its kernels (``None`` where the trace shows no
    device time), each kernel's (device ms, launches) by name, and, for
    each ``record_function`` range named in ``ranges`` (the package's
    own), the device ms of the kernels that start inside the range's
    spans on the device timeline.  (The profiler's CPU-side attribution
    is not used: in a 13-chunk ``pallas_bitexact`` call it attached
    4,951 kernels 8,110 times.)"""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        out = fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, spans, starts = {}, {r: [] for r in ranges}, []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = ev.time_range
        if ev.is_user_annotation:
            if ev.name in spans:
                spans[ev.name].append((t.start, t.end))
            continue
        ms, n = kernels.get(ev.name, (0.0, 0))
        kernels[ev.name] = (ms + t.elapsed_us() / 1e3, n + 1)
        starts.append((t.start, t.elapsed_us() / 1e3))
    range_ms = {
        r: sum(ms for t, ms in starts if any(a <= t < b for a, b in sp))
        for r, sp in spans.items()
    }
    busy = sum(ms for ms, _ in kernels.values())
    return out, dict(
        wall_ms=wall_ms,
        device_ms=busy if busy else None,
        kernels=kernels,
        ranges_ms=range_ms,
    )


def _top(trace: dict, n: int = 6) -> list:
    """The ``n`` kernels of a trace with the most device time."""
    rows = sorted(trace["kernels"].items(), key=lambda kv: -kv[1][0])
    return [[round(ms, 3), cnt, name[:60]] for name, (ms, cnt) in rows[:n]]


def kernel_ms(trace: dict, name: str) -> tuple:
    """(device ms, launches) of the traced kernels whose names hold
    ``name``."""
    hits = [v for k, v in trace["kernels"].items() if name in k]
    return sum(ms for ms, _ in hits), sum(n for _, n in hits)


def environment():
    smi = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit,clocks.max.sm",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip().splitlines()[0]
    name, power, clock = (s.strip() for s in smi.split(","))
    from repro_torch.kernels import cuda_lib

    nvcc = subprocess.run(
        [cuda_lib.nvcc_path(), "--version"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip().splitlines()[-1]
    emit(
        "env",
        card=name,
        power_limit=power,
        max_sm_clock=clock,
        torch=torch.__version__,
        cuda=torch.version.cuda,
        nvcc=nvcc,
        python=sys.version.split()[0],
    )
    t0 = time.perf_counter()
    report = cuda_lib.build()
    regs = {
        k: [ln.strip() for ln in v["ptxas"].splitlines() if "registers" in ln]
        for k, v in report.items()
    }
    emit(
        "build",
        seconds=round(time.perf_counter() - t0, 3),
        per_source={k: round(v["seconds"], 3) for k, v in report.items()},
        ptxas=regs,
    )
    mhz = float(clock.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rates = {
        "alu": sms * ALU_PER_SM_CLOCK * mhz * 1e6,
        "issue": sms * ISSUE_PER_SM_CLOCK * mhz * 1e6,
        # FP32 FMA on the CUDA cores: 128 lanes per SM, 2 flops each
        "fp32": sms * FP32_LANES_PER_SM * 2 * mhz * 1e6,
        "tf32": sms * TF32_FLOPS_PER_SM_CLOCK * mhz * 1e6,
    }
    census = {n: sass_census(n) for n in cuda_lib.SOURCES}
    mma = tensor_core_ops(census["sc_mac"])
    emit("sass", **{n: _top_ops(c) for n, c in census.items()},
         sc_mac_tensor_core_ops=mma)
    if not any(ops.get("HGMMA") for ops in mma.values()):
        raise AssertionError("sc_mac: no HGMMA (wgmma) in its SASS")
    return f"{name}, {power}", rates


def sass_census(name: str) -> dict:
    """Static opcode counts per kernel of one built library
    (``cuobjdump -sass``): the instruction mix the integer bound models."""
    from repro_torch.kernels import cuda_lib

    tool = os.path.join(os.path.dirname(cuda_lib.nvcc_path()), "cuobjdump")
    text = subprocess.run(
        [tool, "-sass", str(cuda_lib.lib_path(name))],
        capture_output=True,
        text=True,
        check=True,
    ).stdout
    census: dict = {}
    fn = None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            # drop the anonymous namespace's mangled prefix, so that the
            # instantiations of one template keep apart
            fn = line.split(":", 1)[1].strip()
            fn = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+", "", fn)
            fn = fn[:48]
            census[fn] = {}
        elif fn and line.startswith("/*") and "*/" in line:
            body = line.split("*/", 1)[1].strip()
            if not body or body.startswith("/*"):
                continue
            op = body.split()[0]
            if op.startswith("@"):
                op = body.split()[1]
            op = op.split(".")[0].rstrip(";")
            census[fn][op] = census[fn].get(op, 0) + 1
    return census


def _top_ops(census: dict, n: int = 8) -> dict:
    return {
        fn: dict(sorted(ops.items(), key=lambda kv: -kv[1])[:n])
        for fn, ops in census.items()
    }


def tensor_core_ops(census: dict) -> dict:
    """Tensor-core MMA opcodes (HGMMA: wgmma; HMMA: mma.sync) per kernel
    of a census."""
    return {
        fn: {op: c for op, c in ops.items() if op in ("HGMMA", "HMMA")}
        for fn, ops in census.items()
    }


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_sc_fused(rates: dict) -> dict:
    from repro_torch.kernels import sc_fused as kf

    rng = np.random.default_rng(1)
    dev = "cuda"
    nbit, levels = 1024, 1 << 10
    shapes = [
        ("wk", 2, 896, 128, 128, True),
        ("mlp_wi", 2, 896, 9728, 9728, True),
        ("unembed_window", 2, 896, 512, 151936, True),
        ("wk_per_call", 2, 896, 128, 128, False),
    ]
    rows = {}
    for name, m, k, n, n_orig, row_keys in shapes:
        keys = rng.integers(0, 2**32, (m, 4), dtype=np.uint64)
        keys = torch.tensor(keys.astype(np.uint32)).to(dev)
        if not row_keys:
            keys = keys[:1].expand(m, 4).contiguous()
        x = torch.tensor(rng.uniform(-1, 1, (m, k)), dtype=torch.float32)
        w = torch.tensor(rng.uniform(-1, 1, (k, n)), dtype=torch.float32)
        x, w = x.to(dev), w.to(dev)
        kw = dict(
            k_orig=k,
            n_orig=n_orig,
            nbit=nbit,
            levels=levels,
            row_keys=row_keys,
        )
        got = kf.sc_fused_popcount(keys, x, w, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = kf.sc_fused_popcount_plain(keys, x, w, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = int((got.long() - ref.long()).abs().max())
        if err != 0:
            raise AssertionError(f"sc_fused {name}: differs by {err}")
        ms = time_ms(lambda: kf.sc_fused_popcount(keys, x, w, **kw), 3)
        n_mul = m * k * n
        bytes_ = 4 * (m * 4 + m * k + k * n + m * n)
        bound_s = int_bound_s(n_mul, nbit, rates)
        bound_ms = max(bound_s, bytes_ / HBM_BYTES_PER_S) * 1e3
        rows[name] = dict(
            shape=[m, k, n],
            n_orig=n_orig,
            row_keys=row_keys,
            bit_equal=True,
            ms=ms,
            plain_ms=plain_ms,
            bound_ms=bound_ms,
            sc_muls=n_mul,
        )
        emit("kernel_check", kernel="sc_fused", case=name, **rows[name])
    return rows


P_SPEC_K = 2  # phase P's draft length: a verify chunk is 3 rows

# Kernels 2 and 3 at phase A's decode and prefill shapes, at phase P's
# speculative verify (a chunk of P_SPEC_K + 1 rows, each with its own
# key), over a 1,024-token cache (one row at its end; a verify chunk
# ending there), and phase A's decode rows in that 64-page table (most
# of its positions masked): (name, sc, lengths, pages a row).
ATTN_CASES = (
    ("decode", 1, (15, 11), 4),
    ("prefill", 8, (8, 0), 4),
    ("verify", P_SPEC_K + 1, (15, 11), 4),
    ("long", 1, (1023, 700), 64),
    ("long_verify", P_SPEC_K + 1, (1021, 700), 64),
    ("sparse", 1, (15, 11), 64),
)


def _attn_inputs(rng, sc: int, lengths, nb: int, dtype=torch.float32):
    b, h, kvh, hd, bs = 2, 14, 2, 64, 16
    n_pages = 1 + b * nb
    dev = "cuda"
    kp = torch.tensor(rng.normal(size=(n_pages, bs, kvh, hd)), dtype=dtype)
    vp = torch.tensor(rng.normal(size=(n_pages, bs, kvh, hd)), dtype=dtype)
    q = torch.tensor(rng.normal(size=(b, sc, h, hd)), dtype=dtype)
    perm = rng.permutation(np.arange(1, n_pages))[: b * nb]
    bt = torch.tensor(perm.reshape(b, nb), dtype=torch.int32)
    ln = torch.tensor(lengths, dtype=torch.int32)
    keys = rng.integers(0, 2**32, (b, sc, 2), dtype=np.uint64)
    keys = torch.tensor(keys.astype(np.uint32))
    return [t.to(dev) for t in (keys, q, kp, vp, bt, ln)]


def _attn_bytes(q, kp, bt, ln) -> int:
    """Bytes the attention function must move: q in, out (f32) out, and
    the K/V pages up to each row's last visible position."""
    b, sc, h, hd = q.shape
    bs, kvh = kp.shape[1], kp.shape[2]
    pages = sum(min(bt.shape[1], (int(n) + sc - 1) // bs + 1) for n in ln)
    kv = 2 * pages * bs * kvh * hd * kp.element_size()
    return kv + q.numel() * q.element_size() + q.numel() * 4 + bt.numel() * 4


def _live_pairs(q, ln) -> int:
    """(query row, kv position) logits the causal mask leaves live."""
    b, sc, h, _ = q.shape
    return h * sum(int(n) + i + 1 for n in ln for i in range(sc))


def _attn_trace(fn, launches: int) -> dict:
    """One call under the profiler: the device ms and launches of the
    attention kernels (``paged_attn_*``) and of everything it ran.  In
    this script's process a trace has at times missed the call's first
    kernel (the long SC call's logits pass, the split pass of the exact
    one over the sparse table); traced in a process of its own
    (``tools/paged_attention_bench.py``) the calls have always shown
    every kernel.  So the call is traced up to three times, and where
    no trace holds the plan's ``launches`` the device ms is None (not
    measured), not the sum of what it holds."""
    for attempt in range(1, 4):
        _, tr = device_trace(fn)
        ms, n = kernel_ms(tr, "paged_attn_")
        if n == launches:
            break
    return dict(
        device_ms=ms if n == launches else None,
        device_launches=n,
        traces=attempt,
        all_device_ms=tr["device_ms"],
        all_launches=sum(c for _, c in tr["kernels"].values()),
        by_kernel={k[:40]: [round(v, 4), c] for k, (v, c) in
                   tr["kernels"].items() if "paged_attn_" in k},
    )


def _attn_work(plan, lengths, count, case: str, name: str) -> dict:
    """The work one call did on the card (``paged_attention_work``'s
    counters) beside the plan's count of it, which it must equal; at
    phase A's decode shape the SC logits must come from at least as many
    blocks as the card has SMs."""
    want = plan.live_blocks(lengths)
    got = count()
    for k, v in want.items():
        if got[k] != v:
            raise AssertionError(f"{name} {case}: {got} on the card, "
                                 f"{want} planned")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if case == "decode" and plan.logit_threads and not (
            got["logit_blocks"] >= sms):
        raise AssertionError(f"{name} decode: {got['logit_blocks']} "
                             "logits-pass blocks did work")
    return dict(card_work=got, plan_work=want)


def _width_invariant(call, ln, rng, b: int, h: int, hd: int,
                     name: str) -> bool:
    """Every row of a width-3 verify chunk (random queries and per-row
    keys) against a width-1 call of that row alone at its own length
    (row i of a chunk starting at ``ln - 2`` sits at ``ln - 2 + i``)
    over the same cache: the bits must be equal, as a speculative verify
    needs.  ``call(q, keys, lengths)`` runs one kernel."""
    w = P_SPEC_K + 1
    dev = ln.device
    q = torch.tensor(rng.normal(size=(b, w, h, hd)), dtype=torch.float32,
                     device=dev)
    keys = rng.integers(0, 2**32, (b, w, 2), dtype=np.uint64)
    keys = torch.tensor(keys.astype(np.uint32), device=dev)
    base = ln - (w - 1)
    wide = call(q, keys, base)
    for i in range(w):
        one = call(q[:, i:i + 1].contiguous(), keys[:, i:i + 1].contiguous(),
                   base + i)
        if not torch.equal(one, wide[:, i:i + 1]):
            diff = float((one - wide[:, i:i + 1]).abs().max())
            raise AssertionError(f"{name}: row {i} of a width-{w} call and "
                                 f"a width-1 call differ by {diff}")
    return True


def check_attention(rates: dict) -> dict:
    """Kernels 2 and 3 against their plain versions (float32, 1e-5) at
    ``ATTN_CASES``: the wrapper's median CUDA-event ms, the device ms and
    launches of one traced call, the bound, the plain version's time
    (the SC one run once), SDPA on the gathered view beside kernel 2,
    and the work of each pass counted on the card in one more call
    (``paged_attention_work``), which must equal the plan's count;
    two launches of each kernel bit-equal."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import attention

    rng = np.random.default_rng(2)
    nbit = 1024
    out = {"paged_attention_fused": {}, "paged_attention_fused_sc": {}}
    for case, sc, lengths, nb in ATTN_CASES:
        keys, q, kp, vp, bt, ln = _attn_inputs(rng, sc, lengths, nb)
        b, _, h, hd = q.shape
        kvh, bs = kp.shape[2], kp.shape[1]
        bytes_ = _attn_bytes(q, kp, bt, ln)
        pairs = _live_pairs(q, ln)
        shape = dict(case=case, sc=sc, lengths=list(lengths), nb=nb)

        # exact QK^T
        kern = (lambda: pa.paged_attention_fused(q, kp, vp, bt, ln))
        got = kern()
        ref = pa.paged_attention_fused_plain(q, kp, vp, bt, ln)
        err = float((got - ref).abs().max())
        if not err <= 1e-5:
            raise AssertionError(f"paged_attention_fused {case}: {err}")
        if not torch.equal(got, kern()):
            raise AssertionError(f"paged_attention_fused {case}: launches "
                                 "differ")
        plain_ms = time_ms(
            lambda: pa.paged_attention_fused_plain(q, kp, vp, bt, ln), 10
        )
        ms = time_ms(kern, 20)
        flops = 4 * pairs * hd
        t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / FP32_FLOPS
        bound = max(t_bytes, t_ops) * 1e3
        by = "bytes" if t_bytes >= t_ops else "operations"
        plan = pa.paged_attention_plan(b, kvh, h // kvh * sc, sc, hd, nb, bs)
        rec = dict(
            **shape,
            max_abs_err=err,
            ms=ms,
            plain_ms=plain_ms,
            bound_ms=bound,
            bound_by=by,
            library_ms=_sdpa_ms(q, kp, vp, bt, ln, attention),
            bytes=bytes_,
            splits=plan.splits,
            pages_per_split=plan.pages_per_split,
            **_attn_work(plan, lengths,
                         lambda: pa.paged_attention_work(q, kp, vp, bt, ln),
                         case, "paged_attention_fused"),
            **_attn_trace(kern, plan.launches),
        )
        if case == "long":
            rec["width_invariant"] = _width_invariant(
                lambda q_, _k, ln_: pa.paged_attention_fused(q_, kp, vp, bt,
                                                             ln_),
                ln, rng, b, h, hd, "paged_attention_fused",
            )
        out["paged_attention_fused"][case] = rec
        emit("kernel_check", kernel="paged_attention_fused", **rec)

        # SC-sampled QK^T
        kw = dict(nbit=nbit)
        kern = (lambda: pa.paged_attention_fused_sc(keys, q, kp, vp, bt, ln,
                                                    **kw))
        got = kern()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = pa.paged_attention_fused_sc_plain(keys, q, kp, vp, bt, ln, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = float((got - ref).abs().max())
        if not err <= 1e-5:
            raise AssertionError(f"paged_attention_fused_sc {case}: {err}")
        if not torch.equal(got, kern()):
            raise AssertionError(f"paged_attention_fused_sc {case}: "
                                 "launches differ")
        logits = pa.sc_logits(keys, q, kp, bt, ln, **kw)
        want = pa.sc_logits_plain(keys, q, kp, bt, ln, **kw)
        if not torch.equal(logits, want):
            raise AssertionError(f"sc logits {case}: not bit-equal")
        ms = time_ms(kern, 5)
        bound_s = int_bound_s(pairs * hd, nbit, rates)
        bound = max(bound_s, bytes_ / HBM_BYTES_PER_S) * 1e3
        plan = pa.paged_attention_plan(b, kvh, h // kvh * sc, sc, hd, nb, bs,
                                       nbit)
        rec = dict(
            **shape,
            max_abs_err=err,
            logits_bit_equal=True,
            ms=ms,
            plain_ms=plain_ms,
            bound_ms=bound,
            bound_by="operations",
            library_ms=None,
            sc_muls=pairs * hd,
            splits=plan.splits,
            pages_per_split=plan.pages_per_split,
            **_attn_work(plan, lengths,
                         lambda: pa.paged_attention_work(q, kp, vp, bt, ln,
                                                         keys, **kw),
                         case, "paged_attention_fused_sc"),
            **_attn_trace(kern, plan.launches),
        )
        if case == "long":
            rec["width_invariant"] = _width_invariant(
                lambda q_, k_, ln_: pa.paged_attention_fused_sc(
                    k_, q_, kp, vp, bt, ln_, **kw),
                ln, rng, b, h, hd, "paged_attention_fused_sc",
            )
        out["paged_attention_fused_sc"][case] = rec
        emit("kernel_check", kernel="paged_attention_fused_sc", **rec)
    return out


def _by_shape(recs: dict) -> dict:
    """The kernels line's per-shape numbers of one attention kernel."""
    keys = ("ms", "device_ms", "device_launches", "bound_ms", "plain_ms",
            "library_ms", "max_abs_err", "card_work")
    return {case: {k: r[k] for k in keys} for case, r in recs.items()}


def _sdpa_ms(q, kp, vp, bt, ln, attention) -> float:
    """PyTorch's fused attention on the gathered view (a yardstick the
    port never calls): same masked GQA attention, one library call."""
    b, sc, h, hd = q.shape
    kc = attention.paged_gather(kp, bt).transpose(1, 2)  # (b, kvh, T, hd)
    vc = attention.paged_gather(vp, bt).transpose(1, 2)
    qt = q.transpose(1, 2)  # (b, h, sc, hd)
    t = torch.arange(kc.shape[2], device=q.device)
    pos = ln.long()[:, None] + torch.arange(sc, device=q.device)[None]
    mask = (t[None, None, :] <= pos[:, :, None])[:, None]  # (b,1,sc,T)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def run():
        return sdpa(qt, kc, vc, attn_mask=mask, enable_gqa=True)

    return time_ms(run, 20)


def _moment_operands(rng, m: int, k: int, n: int, kmajor: bool = False):
    """Signed probabilities on the 10-bit grid (what ``pallas_moment``
    hands the kernel) and standard-normal noise, made on the card; w
    row-major, or (``kmajor``) the transposed view of an (n, k) tensor,
    as the tied unembed passes it."""
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(2**31)))

    def grid(shape):
        v = torch.rand(shape, generator=gen, device="cuda") * 2 - 1
        return torch.round(v * 1024) / 1024

    z = torch.randn((m, n), generator=gen, device="cuda")
    w = grid((n, k)).T if kmajor else grid((k, n))
    return grid((m, k)), w, z


def _moment_bound(m: int, k: int, n: int, rates: dict, noise_in: bool,
                  on_grid: bool) -> dict:
    """The least time of the moment kernel's work over its float32-
    accurate routes, never below x, w (and the noise) read once and the
    output written once: 3xTF32 on the tensor cores (9 TF32 products per
    operand pair, 18·M·K·N flops at ``rates["tf32"]``; 5 products where
    the operands are on the grid and exact in TF32) or 3 FMAs per pair
    on the FP32 cores (6·M·K·N flops at ``rates["fp32"]``).  Returns
    bound_ms, bound_by, the route that sets it, and the FP32-core bound
    beside it."""
    bytes_ = 4 * (m * k + k * n + (2 if noise_in else 1) * m * n)
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_tf32 = 2 * (5 if on_grid else 9) * m * k * n / rates["tf32"]
    t_fp32 = 6 * m * k * n / rates["fp32"]
    t_ops = min(t_tf32, t_fp32)
    return dict(
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        bound_route="tf32x3" if t_tf32 <= t_fp32 else "fp32",
        bound_fp32_ms=max(t_fp32, t_bytes) * 1e3,
    )


def paired_ms(lib_fn, kern_fn, reps: int) -> tuple:
    """(library ms, kernel ms): medians of CUDA-event times taken in
    turns (library, kernel, kernel, library), ``reps`` runs each turn."""
    a1 = time_ms(lib_fn, reps)
    k1 = time_ms(kern_fn, reps)
    k2 = time_ms(kern_fn, reps)
    a2 = time_ms(lib_fn, reps)
    return float(np.median([a1, a2])), float(np.median([k1, k2]))


# The trainer's moment-kernel shapes: M = batch 8 x seq 64 rows; K =
# d_model 896, or d_ff 4864 for the MLP's output projection; the tied
# unembed's w is the K-major view table.T, the others row-major.
SC_MAC_SHAPES = (
    ("unembed", 896, 151936, True),
    ("mlp_wi", 896, 9728, False),
    ("mlp_wo", 4864, 896, False),
    ("wq", 896, 896, False),
    ("wk", 896, 128, False),
)


def check_sc_mac(rates: dict) -> dict:
    """Kernels 5 and 6 (and kernel 5's split-K pass) at the trainer's
    shapes, against their plain versions, each timed in turns with the
    three-``torch.matmul`` call; kernel 5 on grid operands as
    ``pallas_moment`` launches it (``on_grid``), and off the grid."""
    from repro_torch.kernels import sc_mac as km

    rng = np.random.default_rng(3)
    nbit = 1024
    m = 512
    rows = {}
    for name, k, n, kmajor in SC_MAC_SHAPES:
        x, w, z = _moment_operands(rng, m, k, n, kmajor)
        ref = km.sc_mac_fused_plain(x, w, z, nbit=nbit)
        scale = ref.abs().max()
        got = km.sc_mac_fused(x, w, z, nbit=nbit, on_grid=True)
        err = float((got - ref).abs().max() / scale)
        again = km.sc_mac_fused(x, w, z, nbit=nbit, on_grid=True)
        bit_equal = bool(torch.equal(got, again))
        # the same inputs through the general (9-product) route
        err_general = float(
            (km.sc_mac_fused(x, w, z, nbit=nbit) - ref).abs().max() / scale
        )
        del again
        if not (err <= 1e-5 and err_general <= 1e-5):
            raise AssertionError(
                f"sc_mac_fused {name}: rel err {err} / {err_general}"
            )
        if not bit_equal:
            raise AssertionError(f"sc_mac_fused {name}: two launches differ")
        xa, wa, xq, wq = x.abs(), w.abs(), x * x, w * w

        def library():
            mean = torch.matmul(x, w)
            p = torch.matmul(xa, wa)
            p2 = torch.matmul(xq, wq)
            var = torch.clamp_min(p - p2, 0.0) * (1.0 / nbit)
            return mean + z * torch.sqrt(var)

        lib_ms, ms = paired_ms(
            library,
            lambda: km.sc_mac_fused(x, w, z, nbit=nbit, on_grid=True),
            10,
        )
        _, ms_general = paired_ms(
            library, lambda: km.sc_mac_fused(x, w, z, nbit=nbit), 5
        )
        plain_ms = time_ms(
            lambda: km.sc_mac_fused_plain(x, w, z, nbit=nbit), 10
        )
        bound = _moment_bound(m, k, n, rates, True, True)
        splits, kper = km.sc_mac_plan(m, n, k)
        rows[name] = dict(
            shape=[m, k, n],
            w_layout="K-major view (table.T)" if kmajor else "row-major",
            splits=splits,
            k_per_split=kper,
            max_abs_err=err,
            max_abs_err_general=err_general,
            two_launches_bit_equal=bit_equal,
            ms=ms,
            plain_ms=plain_ms,
            library_ms=lib_ms,
            vs_library=ms / lib_ms,
            **bound,
            of_bound=bound["bound_ms"] / ms,
            ms_general=ms_general,
            bound_general_ms=_moment_bound(m, k, n, rates, True,
                                           False)["bound_ms"],
        )
        emit("kernel_check", kernel="sc_mac_fused", case=name, **rows[name])
        if name == "mlp_wo":
            rows["reduce"] = check_sc_mac_reduce(
                km, x, w, z, splits, kper, nbit
            )
            check_sc_mac_cancel(km, m, k, n, nbit)
        del x, w, z, got, ref, xa, wa, xq, wq
    torch.cuda.empty_cache()

    # kernel 6 at the unembed shape (its one, general route): against its
    # plain version, and its noise z = (out - mean) / sd must be standard
    # normal
    k, n = 896, 151936
    x, w, _ = _moment_operands(rng, m, k, n, True)
    seed = torch.tensor([20261017], dtype=torch.int32)
    got = km.sc_mac_fused_prng(seed, x, w, nbit=nbit)
    ref = km.sc_mac_fused_prng_plain(seed, x, w, nbit=nbit)
    err = float((got - ref).abs().max() / ref.abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"sc_mac_fused_prng: rel err {err}")
    del ref
    mean = x @ w
    sd = torch.sqrt(
        torch.clamp_min(x.abs() @ w.abs() - (x * x) @ (w * w), 0.0) / nbit
    )
    live = sd > 0
    zs = ((got - mean) / torch.where(live, sd, 1.0))[live].double()
    mu, var = float(zs.mean()), float(zs.var())
    del mean, sd, live, zs
    if not (abs(mu) < 0.01 and abs(var - 1.0) < 0.02):
        raise AssertionError(f"sc_mac_fused_prng noise: mean {mu} var {var}")
    ms = time_ms(
        lambda: km.sc_mac_fused_prng(seed, x, w, nbit=nbit), 10
    )
    plain_ms = time_ms(
        lambda: km.sc_mac_fused_prng_plain(seed, x, w, nbit=nbit), 3
    )
    rows["prng"] = dict(
        shape=[m, k, n],
        max_abs_err=err,
        noise_mean=mu,
        noise_var=var,
        ms=ms,
        plain_ms=plain_ms,
        **_moment_bound(m, k, n, rates, False, False),
        library_ms=None,
    )
    emit("kernel_check", kernel="sc_mac_fused_prng", case="unembed",
         **rows["prng"])
    del x, w, got
    torch.cuda.empty_cache()
    return rows


def check_sc_mac_cancel(km, m: int, k: int, n: int, nbit: int) -> None:
    """Kernel 5 where p - p2 cancels: |x| = 1 against |w| = 1023/1024
    (and the other way round), so every pair leaves 1023/1024^2 of the
    variance and a lost low part of x^2 or w^2 moves the sd by ~25 %,
    which the 1e-5-of-max-|out| contract cannot see (the mean sets it).
    Unit noise minus zero noise isolates the sd; it must be within 1e-3
    of sqrt(k·(1023/1024)/1024/nbit) (float32 ulps of the mean), on the
    grid route and the general one; prints the worst relative error of
    each (orientation, route)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    near = 1023 / 1024
    want = math.sqrt(k * near / 1024 / nbit)
    ones = torch.ones((m, n), device="cuda")
    zeros = torch.zeros((m, n), device="cuda")

    def signs(shape, mag):
        b = torch.rand(shape, generator=gen, device="cuda") < 0.5
        return torch.where(b, -mag, mag)

    errs = {}
    for side in ("x", "w"):
        x = signs((m, k), near if side == "x" else 1.0)
        w = signs((k, n), 1.0 if side == "x" else near)
        for on_grid in (True, False):
            sd = (km.sc_mac_fused(x, w, ones, nbit=nbit, on_grid=on_grid)
                  - km.sc_mac_fused(x, w, zeros, nbit=nbit,
                                    on_grid=on_grid))
            err = float((sd / want - 1).abs().max())
            errs[f"{side}_near_{'grid' if on_grid else 'general'}"] = err
            if not err <= 1e-3:
                raise AssertionError(
                    f"sc_mac_fused cancel ({side} at 1023/1024, on_grid "
                    f"{on_grid}): sd off by {err} of its law"
                )
    emit("kernel_check", kernel="sc_mac_fused", case="cancel",
         shape=[m, k, n], sd=want, sd_rel_err=errs)


def check_sc_mac_reduce(km, x, w, z, splits, kper, nbit) -> dict:
    """Kernel 5's split-K pass at the partial sums its mlp_wo launch
    makes (computed here with torch ops, one K range per split), against
    its plain version; bytes bound (partials and noise read once, the
    output written once)."""
    k = x.shape[1]
    parts = torch.stack([
        torch.stack([
            x[:, a:a + kper] @ w[a:a + kper],
            x[:, a:a + kper].abs() @ w[a:a + kper].abs()
            - (x[:, a:a + kper] ** 2) @ (w[a:a + kper] ** 2),
        ])
        for a in range(0, k, kper)
    ])
    if not splits > 1 or parts.shape[0] != splits:
        raise AssertionError(f"sc_mac_reduce: mlp_wo plans {splits} splits")
    got = km.sc_mac_reduce(parts, z, nbit=nbit)
    ref = km.sc_mac_reduce_plain(parts, z, nbit=nbit)
    err = float((got - ref).abs().max() / ref.abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"sc_mac_reduce: rel err {err}")
    ms = time_ms(lambda: km.sc_mac_reduce(parts, z, nbit=nbit), 20)
    plain_ms = time_ms(lambda: km.sc_mac_reduce_plain(parts, z, nbit=nbit),
                       10)
    bytes_ = 4 * (parts.numel() + 2 * z.numel())
    row = dict(
        shape=list(parts.shape),
        max_abs_err=err,
        ms=ms,
        plain_ms=plain_ms,
        bound_ms=bytes_ / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
        library_ms=None,
    )
    emit("kernel_check", kernel="sc_mac_reduce", case="mlp_wo", **row)
    return row


# Integer ops of the packed MUL per word pair: 16 ladder slices x 2
# operands x (shift-and bit test, select) = 64 ALU ops, plus AND, POPC and
# the add; the issue rate (128 lanes per SM clock) bounds them.
SC_MUL_OPS_PER_WORD = 2 * 16 * 2 + 3


def _u32_words(gen, shape):
    w = torch.randint(0, 2**32, shape, generator=gen, device="cuda",
                      dtype=torch.int64)
    return w.to(torch.uint32)


# Kernel 4's cases, W = 32 words (nbit 1024): the wk and wq decode rows
# (one MUL per (k, n) product of a 1 x 896 row) whole, and every size
# phase V launches: ``pallas_bitexact`` walks its stream in chunks of
# 65,536 products, so a wq / wo row is 12 chunks and a 16,384 tail, a
# wk / wv row one chunk and a 49,152 tail, and the ``array`` backend's
# packed class launches 64 products.
SC_MUL_CASES = (
    ("wk", 896 * 128),
    ("wq", 896 * 896),
    ("chunk", 65536),
    ("wk_tail", 49152),
    ("wq_tail", 16384),
    ("packed", 64),
)


def check_sc_mul(rates: dict) -> dict:
    """Kernel 4 against its plain version at ``SC_MUL_CASES``."""
    from repro_torch.kernels import sc_mul as kmul

    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = {}
    for name, m in SC_MUL_CASES:
        w = 32
        bias = _u32_words(gen, (2, m)).to(torch.int64) & 0xFFFF
        px, py = bias.to(torch.uint32)
        rx, ry = _u32_words(gen, (m, 16, w)), _u32_words(gen, (m, 16, w))
        got = kmul.sc_mul_popcount(px, py, rx, ry)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = kmul.sc_mul_popcount_plain(px, py, rx, ry)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = int((got.long() - ref.long()).abs().max())
        if err != 0:
            raise AssertionError(f"sc_mul_popcount {name}: differs by {err}")
        # 10 launches back to back per timed run, so the wrapper's host
        # time overlaps the previous launch instead of adding to it
        ms = time_ms(lambda: [kmul.sc_mul_popcount(px, py, rx, ry)
                              for _ in range(10)], 10) / 10
        bytes_ = 2 * m * 16 * w * 4 + 2 * m * 4 + m * 4
        t_bytes = bytes_ / HBM_BYTES_PER_S
        t_ops = m * w * SC_MUL_OPS_PER_WORD / rates["issue"]
        rows[name] = dict(
            shape=[m, 16, w],
            max_abs_err=0.0,
            ms=ms,
            plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None,
            bytes=bytes_,
            tb_per_s=bytes_ / ms / 1e9,
        )
        emit("kernel_check", kernel="sc_mul_popcount", case=name,
             **rows[name])
        del px, py, rx, ry, got, ref, bias
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phases 3-5: serving
# ---------------------------------------------------------------------------


def _qwen_params(cfg, device):
    from repro_torch.models import lm, params

    gen = torch.Generator().manual_seed(0)
    specs = lm.lm_param_specs(cfg)
    return params.init_params(specs, gen, device, cfg.param_dtype)


def serve(params, cfg, opts, prompts, max_new: int, device,
          traced_tick=None, ranges=(), stagger=None, **build):
    """Serve ``prompts`` greedily to the end.  Returns (engine, tokens by
    request, host ms per tick, trace): tick ``traced_tick`` runs under
    the profiler (``device_trace`` with ``ranges``), else trace is None.
    With ``stagger`` the first request is served alone until it has fed
    that many tokens (or finished), so that the rest find its blocks
    registered in the prefix cache.
    """
    from repro_torch.serve import Request, build_engine

    eng = build_engine(params, cfg, opts, device=device, **build)
    reqs = [Request(rid=rid, prompt=prompt, max_new_tokens=max_new)
            for rid, prompt in enumerate(prompts)]
    waiting = reqs[1:] if stagger else []
    for r in reqs[:1] if stagger else reqs:
        eng.submit(r)
    tick_ms, trace = [], None
    while eng.scheduler.has_work() or waiting:
        first = [s for s in eng.scheduler.rows
                 if s is not None and s.req is reqs[0]]
        if waiting and (reqs[0].done or first and first[0].fed >= stagger):
            for r in waiting:
                eng.submit(r)
            waiting = []
        if len(tick_ms) == traced_tick:
            _, trace = device_trace(eng.step, ranges)
            tick_ms.append(trace["wall_ms"])
            continue
        t0 = time.perf_counter()
        eng.step()
        if device != "cpu":
            torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
    toks = {r.rid: list(r.generated) for r in eng.finished}
    return eng, toks, tick_ms, trace


def serve_phase(name, cfg, opts, prompts, max_new, params, expect,
                **build):
    from repro_torch.kernels import cuda_lib

    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    eng, toks, tick_ms, trace = serve(params, cfg, opts, prompts, max_new,
                                      "cuda", **build)
    counts = dict(cuda_lib.launches)
    n_tok = sum(len(t) for t in toks.values())
    emit(
        name,
        tokens=toks,
        ticks=eng.ticks,
        tick_ms=tick_ms,
        wall_s=sum(tick_ms) / 1e3,
        traced_tick=build.get("traced_tick"),
        launches=counts,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
    )
    for k in expect:
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"{name}: kernel {k} never launched")
    if n_tok != len(prompts) * max_new:
        raise AssertionError(f"{name}: {n_tok} tokens generated")
    if not all(0 <= t < cfg.vocab for ts in toks.values() for t in ts):
        raise AssertionError(f"{name}: token outside the vocabulary")
    return counts, tick_ms, eng, trace


A_TRACED_TICK = 3  # a decode tick of phase A (both requests decoding)


def attention_trace(trace, cfg, opts, name: str) -> dict:
    """The SC attention kernels of a traced decode tick: device ms and
    launches, and the launches of one call (one call a layer), which
    must be the plan's."""
    from repro_torch.kernels import paged_attention as pa

    ms, n = kernel_ms(trace, "paged_attn_")
    kvh = cfg.n_kv_heads
    plan = pa.paged_attention_plan(
        opts.slots, kvh, cfg.n_heads // kvh, 1, cfg.resolved_head_dim,
        -(-opts.max_len // opts.block_size), opts.block_size, cfg.sc_nbit,
    )
    rec = dict(
        tick=A_TRACED_TICK,
        host_ms=trace["wall_ms"],
        device_ms=trace["device_ms"],
        attention_ms=ms,
        attention_launches=n,
        launches_per_call=n / cfg.n_layers,
        plan_launches=plan.launches,
        top=_top(trace),
    )
    emit(name, **rec)
    if n != plan.launches * cfg.n_layers:
        raise AssertionError(f"{name}: {n} attention launches in the tick")
    return rec


def unembed_ms(params, cfg, rows: int) -> float:
    """One tied-unembed SC matmul at a tick's row count."""
    from repro_torch.models import layers
    from repro_torch.sc import ctr_rng

    x = torch.randn(rows, cfg.d_model, generator=torch.Generator())
    x = x.to("cuda", cfg.act_dtype)
    keys = ctr_rng.split(ctr_rng.prng_key(3), rows).to("cuda")
    return time_ms(lambda: layers.unembed(x, params["embed"], cfg, keys), 2)


def cross_device() -> None:
    """The tiny parity-test configuration served on the card and on the
    CPU: the greedy tokens must be equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.serve import ServeOptions

    cfg = get_smoke_config("qwen2-0.5b").replace(
        d_model=32,
        d_ff=64,
        vocab=128,
        param_dtype=torch.float32,
        act_dtype=torch.float32,
        sc_backend="pallas_bitexact",
        sc_nbit=32,
        paged_attn="fused_sc",
    )
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab, 10).tolist() for _ in range(3)]
    opts = ServeOptions(
        paged=True, slots=3, max_len=32, block_size=8, prefill_chunk=6
    )
    toks = {}
    for device in ("cuda", "cpu"):
        params = _qwen_params(cfg, device)
        _, toks[device], _, _ = serve(params, cfg, opts, prompts, 5, device)
    emit("cross_device", cuda=toks["cuda"], cpu=toks["cpu"])
    if toks["cuda"] != toks["cpu"]:
        raise AssertionError("greedy tokens differ between card and CPU")


# ---------------------------------------------------------------------------
# Phase P: prefix caching, content-chain keys and speculative decoding
# ---------------------------------------------------------------------------

P_PREFIX = 32  # two full 16-token blocks
P_MAX_NEW = 4


def _prefix_prompts(rng, vocab: int) -> list:
    """Three prompts sharing a 32-token prefix: two longer, and the
    prefix alone (a block multiple, whose adoption copies on write)."""
    prefix = rng.integers(3, vocab, P_PREFIX).tolist()
    tails = [rng.integers(3, vocab, n).tolist() for n in (2, 3)]
    return [prefix + tails[0], prefix + tails[1], list(prefix)]


class _StepTimer:
    """Wraps ``lm.decode_paged`` while installed: the synced host ms of
    each call, split into draft steps (the draft backend) and verify
    steps (``all_logits``); and the arguments of the first SC attention
    call of a verify step (for the card-work count)."""

    def __init__(self, draft_backend: str):
        from repro_torch.kernels import paged_attention as pa
        from repro_torch.models import lm

        self.lm, self.pa = lm, pa
        self.draft_backend = draft_backend
        self.draft_ms, self.verify_ms, self.verify_args = [], [], None
        self._in_verify = False

    def __enter__(self):
        lm, pa = self.lm, self.pa
        self._step, self._attn = lm.decode_paged, pa.paged_attention_fused_sc
        timer = self

        def step(*args, **kw):
            timer._in_verify = bool(kw.get("all_logits"))
            out, ms = _synced_ms(lambda: timer._step(*args, **kw))
            timer._in_verify = False
            if kw.get("all_logits"):
                timer.verify_ms.append(ms)
            elif args[6].sc_backend == timer.draft_backend:
                timer.draft_ms.append(ms)
            return out

        def attn(keys, q, *rest, **kw):
            if timer._in_verify and timer.verify_args is None:
                timer.verify_args = (keys, q) + rest
            return timer._attn(keys, q, *rest, **kw)

        lm.decode_paged, pa.paged_attention_fused_sc = step, attn
        return self

    def __exit__(self, *exc):
        self.lm.decode_paged = self._step
        self.pa.paged_attention_fused_sc = self._attn


def width_check(params, cfg, prompt) -> dict:
    """One decode step at width 1 and the same token as row 0 of a
    width-3 ``all_logits`` step, from copies of one prefilled pool: the
    logits and the K/V the row writes must be bit-equal (every per-row
    step of the verify path is width-invariant: embedding, rms_norm,
    RoPE, kernels 1 and 3)."""
    from repro_torch.models import lm
    from repro_torch.sc import ctr_rng

    dev = "cuda"
    n = len(prompt)
    pages = lm.init_paged_cache(cfg, 5, 16, device=dev)
    table = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32, device=dev)
    rng = ctr_rng.prng_key(5)[None].to(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    lm.decode_paged(params, pages, table,
                    torch.tensor([prompt], **i32), torch.tensor([0], **i32),
                    torch.tensor([n], **i32), cfg, rng=rng)
    copy = {k: v.clone() for k, v in pages.items()}
    tok = torch.tensor([[prompt[-1]]], **i32)
    length = torch.tensor([n], **i32)
    one, _ = lm.decode_paged(params, pages, table, tok, length,
                             torch.tensor([1], **i32), cfg, rng=rng)
    wide_tok = torch.tensor([[prompt[-1], 7, 9]], **i32)
    wide, _ = lm.decode_paged(params, copy, table, wide_tok, length,
                              torch.tensor([3], **i32), cfg, rng=rng,
                              all_logits=True)
    pos = (n // 16 + 1, n % 16)
    rec = dict(
        logits_bit_equal=bool(torch.equal(one, wide[:, 0])),
        kv_bit_equal=all(
            torch.equal(pages[k][:, pos[0], pos[1]],
                        copy[k][:, pos[0], pos[1]]) for k in ("k", "v")
        ),
        max_abs_diff=float((one - wide[:, 0]).abs().max()),
    )
    if not (rec["logits_bit_equal"] and rec["kv_bit_equal"]):
        raise AssertionError(f"width check: {rec}")
    return rec


def prefix_spec_phase(params, cfg, opts, prompts_a, tokens_a) -> dict:
    """Phase P on phase A's model: prefix caching (cache off, then on,
    under content-chain keys), speculation on phase A's prompts (tokens
    must be phase A's), the two together, a traced speculative tick
    (kernel 3's launches per call and its card work at the verify's
    width must be the plan's), and the width check."""
    from repro_torch import sc
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import paged_attention as pa

    rng = np.random.default_rng(1)
    prompts = _prefix_prompts(rng, cfg.vocab)
    cuda_lib.reset_launches()
    runs = {}
    spec = dict(speculative=True, spec_k=P_SPEC_K)
    for name, kw in (
        ("cache_off", dict(rng_mode="content")),
        ("cache_on", dict(prefix_cache=True)),
        ("cache_on_spec", dict(prefix_cache=True, **spec)),
    ):
        eng, toks, tick_ms, _ = serve(
            params, cfg, opts.replace(**kw), prompts, P_MAX_NEW, "cuda",
            stagger=P_PREFIX,
        )
        runs[name] = (eng, toks, tick_ms)
    # phase A's prompts, speculating; tick 2 is the first decode tick
    # (both rows decoding), so it speculates, traced
    draft = sc.draft_backend(cfg.sc_backend)
    with _StepTimer(draft) as timer:
        eng, toks, tick_ms, trace = serve(
            params, cfg, opts.replace(**spec), prompts_a, P_MAX_NEW,
            "cuda", traced_tick=2,
        )
    runs["spec_a"] = (eng, toks, tick_ms)
    counts = dict(cuda_lib.launches)

    def metric(e, name, **lab):
        return e.metrics.value(name, **lab) or 0

    lines = {}
    for name, (e, t, ms) in runs.items():
        lines[name] = dict(
            tokens=t,
            ticks=e.ticks,
            tick_ms=ms,
            ms_per_tick=float(np.mean(ms)),
            spec_ticks=metric(e, "serve_ticks_total", kind="spec"),
            drafted=metric(e, "serve_spec_drafted_tokens_total"),
            accepted=metric(e, "serve_spec_accepted_tokens_total"),
            hits=metric(e, "serve_prefix_cache_hit_tokens_total"),
            cow=metric(e, "serve_prefix_cache_cow_total"),
            prefill_tokens=metric(e, "serve_prefill_tokens_total"),
        )
    off, on = lines["cache_off"], lines["cache_on"]
    both, spec_a = lines["cache_on_spec"], lines["spec_a"]
    # the traced tick: kernel 3's launches per call at the verify width
    kvh, h = cfg.n_kv_heads, cfg.n_heads
    nb, width = -(-opts.max_len // opts.block_size), P_SPEC_K + 1
    plan = pa.paged_attention_plan(
        opts.slots, kvh, h // kvh * width, width, cfg.resolved_head_dim,
        nb, opts.block_size, cfg.sc_nbit,
    )
    att_ms, att_n = kernel_ms(trace, "paged_attn_")
    keys, q, kp, vp, bt, ln = timer.verify_args
    work = pa.paged_attention_work(q, kp, vp, bt, ln, keys, nbit=cfg.sc_nbit)
    want = plan.live_blocks(ln.tolist())
    rec = dict(
        runs=lines,
        launches=counts,
        draft_ms=timer.draft_ms,
        draft_ms_median=float(np.median(timer.draft_ms)),
        verify_ms=timer.verify_ms,
        verify_ms_median=float(np.median(timer.verify_ms)),
        draft_backend=draft,
        traced_tick=dict(
            tick=2,
            host_ms=trace["wall_ms"],
            device_ms=trace["device_ms"],
            attention_ms=att_ms,
            attention_launches=att_n,
            launches_per_call=att_n / cfg.n_layers,
            plan_launches=plan.launches,
            verify_width=list(q.shape[:2]),
            card_work=work,
            plan_work=want,
            top=_top(trace),
        ),
        width_check=width_check(params, cfg, prompts_a[1]),
    )
    emit("serve_p", **rec)
    checks = [
        (on["tokens"] == off["tokens"], "cache-on tokens != cache-off"),
        (on["hits"] >= P_PREFIX, f"{on['hits']} prefix hits"),
        (on["prefill_tokens"] < off["prefill_tokens"], "no prefill saved"),
        (on["cow"] >= 1, "no copy-on-write"),
        (spec_a["tokens"] == tokens_a, "speculative tokens != serve_a's"),
        (spec_a["spec_ticks"] >= 1, "phase A's prompts never speculated"),
        (both["tokens"] == on["tokens"], "spec + cache tokens != cache-on"),
        (both["drafted"] > 0, "spec + cache never drafted"),
        (runs["spec_a"][0].spec_log[0]["tick"] == 2, "tick 2 not spec"),
        (list(q.shape[:2]) == [opts.slots, width], "verify width"),
        (att_n == plan.launches * cfg.n_layers,
         f"{att_n} attention launches in the traced tick"),
        (all(work[k] == v for k, v in want.items()),
         f"verify work {work} on the card, {want} planned"),
    ]
    for ok, what in checks:
        if not ok:
            raise AssertionError(f"serve_p: {what}")
    for k in ("sc_fused", "paged_attention_fused_sc"):
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"serve_p: kernel {k} never launched")
    return rec


# ---------------------------------------------------------------------------
# Phases 8-9: validation (V) and serving on a faulty device (D)
# ---------------------------------------------------------------------------


def _synced_ms(fn):
    """(result, host ms) of one call that ends in a device sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def validation_phase(params, cfg) -> dict:
    """Phase V: ``pallas_bitexact`` (kernel 4) at qwen2-0.5b's layer-0
    decode-row widths equals ``pallas_fused`` (kernel 1) bit for bit
    under one key; then one ``array`` call per numerics size class."""
    from repro_torch import arch, sc
    from repro_torch.kernels import cuda_lib
    from repro_torch.sc import ctr_rng

    blk = params["blocks"]["attn"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    row = torch.randn((1, cfg.d_model), generator=gen, device="cuda")
    weights = {
        name: blk[name][0].to(torch.float32)
        for name in ("wk", "wv", "wq", "wo")
    }
    key = ctr_rng.prng_key(7).to("cuda")
    bitexact = sc.ScConfig(backend="pallas_bitexact", nbit=1024)
    out = {"matmuls": {}, "array": {}}
    cuda_lib.reset_launches()
    for name, w in weights.items():
        torch.cuda.reset_peak_memory_stats()
        before = dict(cuda_lib.launches)
        y, ms = _synced_ms(lambda: sc.sc_dot(key, row, w, bitexact))
        peak = torch.cuda.max_memory_allocated()
        yf, fused_ms = _synced_ms(
            lambda: sc.sc_dot(key, row, w, bitexact.replace(
                backend="pallas_fused")))
        equal = bool(torch.equal(y, yf))
        products = row.shape[1] * w.shape[1]
        rec = dict(
            shape=[1, *w.shape],
            products=products,
            equal_to_fused=equal,
            ms=ms,
            fused_ms=fused_ms,
            max_memory_allocated=peak,
            launches={k: v - before.get(k, 0)
                      for k, v in cuda_lib.launches.items()},
        )
        out["matmuls"][name] = rec
        emit("validate_v", matmul=name, **rec)
        if not equal:
            raise AssertionError(f"validate_v {name}: pallas_bitexact != "
                                 "pallas_fused under one key")
    # the wq call once more under the profiler: kernel 4's device time
    # per call and per launch, and the stream's, read from the real call
    _, tr = device_trace(
        lambda: sc.sc_dot(key, row, weights["wq"], bitexact),
        ranges=("pallas_bitexact.stream",),
    )
    k4_ms, k4_n = kernel_ms(tr, "sc_mul_kernel")
    busy = tr["device_ms"]
    stream = tr["ranges_ms"]["pallas_bitexact.stream"]
    out["wq_trace"] = dict(
        host_ms=tr["wall_ms"],
        device_ms=busy,
        sc_mul_ms=k4_ms,
        sc_mul_launches=k4_n,
        sc_mul_ms_per_launch=k4_ms / k4_n if k4_n else None,
        stream_ms=stream,
        stream_share=stream / busy if busy else None,
        sc_mul_share=k4_ms / busy if busy else None,
        top=_top(tr),
    )
    emit("validate_v_trace", **out["wq_trace"])
    # the array backend's three numerics size classes at qwen widths
    wi = params["blocks"]["ffn"]["wi"][0].to(torch.float32)
    wq = weights["wq"]
    classes = (
        ("packed", row[:, :8], wq[:8, :8]),  # 64 products: kernel 4
        ("binomial", row, wq),  # 802,816 products
        ("moment", row, wi),  # 8,716,288 products
    )
    acfg = sc.ScConfig(backend="array", nbit=1024)
    for name, x, w in classes:
        before = dict(cuda_lib.launches)
        with arch.collect() as records:
            y, ms = _synced_ms(lambda: sc.sc_dot(key, x, w, acfg))
        exact = x @ w
        rel = float((y - exact).abs().max() / exact.abs().max())
        rec = dict(
            shape=[x.shape[0], *w.shape],
            ms=ms,
            max_rel_err_vs_exact=rel,
            records=len(records),
            cycles=records[0].report.cycles,
            energy_nj=records[0].report.energy_nj,
            launches={k: v - before.get(k, 0)
                      for k, v in cuda_lib.launches.items()},
        )
        out["array"][name] = rec
        emit("validate_v_array", size_class=name, **rec)
        if not bool(torch.isfinite(y).all()) or len(records) != 1:
            raise AssertionError(f"validate_v_array {name}")
    if out["array"]["packed"]["launches"].get("sc_mul_popcount", 0) <= 0:
        raise AssertionError("validate_v_array: the packed class did not "
                             "launch sc_mul_popcount")
    out["counts"] = dict(cuda_lib.launches)
    emit("validate_v_launches", launches=out["counts"])
    if out["counts"].get("sc_mul_popcount", 0) <= 0:
        raise AssertionError("validate_v: sc_mul_popcount never launched")
    return out


def _census() -> dict:
    from repro_torch import obs

    reg = obs.default_registry()
    return {
        kind: reg.value("arch_bit_errors_total", kind=kind, shard="1") or 0
        for kind in ("stuck0", "stuck1", "retention")
    }


# phase D's ticks 0 and 1 prefill, 2-4 decode; tick 3 runs traced
D_TRACED_TICK = 3


def faulty_serve_phase(params, cfg, prompts) -> dict:
    """Phase D: serve on the ``harsh`` device through ``build_engine``
    (an exact model moves onto ``array``), fused paged attention, the
    arch bill and the bit-error census."""
    from repro_torch import arch, obs
    from repro_torch.serve import ServeOptions

    obs.enable()
    before = _census()
    opts = ServeOptions(
        paged=True, slots=2, block_size=16, prefill_chunk=8, max_len=64,
        fault_profile="harsh", fused_attention=True,
    )
    counts, tick_ms, eng, tr = serve_phase(
        "serve_d", cfg, opts, prompts, 4, params,
        ("paged_attention_fused",), collect_arch_trace=True,
        traced_tick=D_TRACED_TICK, ranges=("array.noise", "array.powers"),
    )
    census = {k: v - before[k] for k, v in _census().items()}
    untraced = [t for i, t in enumerate(tick_ms) if i != D_TRACED_TICK]
    rep = eng.arch_report()
    records = len(eng.arch_collector.records)
    eng.close()
    if eng.cfg.sc_backend != "array" or rep is None or records == 0:
        raise AssertionError("serve_d: the model did not run on array")
    if not census["stuck0"] > 0:
        raise AssertionError(f"serve_d: empty bit-error census {census}")
    out = dict(
        counts=counts,
        arch_report=arch.report_dict(rep),
        energy_nj=rep.energy_nj,
        records=records,
        request_costs=eng.arch_request_costs(),
        bit_errors=census,
        median_tick_ms=float(np.median(untraced)),
    )
    emit("serve_d_arch", **out)
    # the traced decode tick: device time of the noise and powers ranges
    # of ``_device_numerics`` and of kernel 2; the profiler slows the
    # host, so the idle share is taken against the untraced decode ticks
    decode_ms = float(np.median(untraced[2:]))
    busy = tr["device_ms"]
    attn_ms, attn_n = kernel_ms(tr, "paged_attn_")
    out["trace"] = dict(
        tick=D_TRACED_TICK,
        host_ms=tr["wall_ms"],
        untraced_decode_tick_ms=decode_ms,
        device_ms=busy,
        idle_share=1 - busy / decode_ms if busy else None,
        noise_ms=tr["ranges_ms"]["array.noise"],
        powers_ms=tr["ranges_ms"]["array.powers"],
        attention_ms=attn_ms,
        attention_launches=attn_n,
        attention_launches_per_call=attn_n / eng.cfg.n_layers,
        top=_top(tr),
    )
    emit("serve_d_trace", **out["trace"])
    return out


def faulty_cross_device() -> None:
    """The SMOKE model on the ``tiny`` device, served on the card and on
    the CPU: the greedy tokens must be equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.serve import ServeOptions

    cfg = get_smoke_config("qwen2-0.5b").replace(
        param_dtype=torch.float32, act_dtype=torch.float32
    )
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, cfg.vocab, n).tolist() for n in (7, 4)]
    opts = ServeOptions(
        paged=True, slots=2, max_len=32, block_size=8, prefill_chunk=4,
        fault_profile="tiny",
    )
    toks = {}
    for device in ("cuda", "cpu"):
        params = _qwen_params(cfg, device)
        _, toks[device], _, _ = serve(params, cfg, opts, prompts, 4, device)
    emit("faulty_cross_device", cuda=toks["cuda"], cpu=toks["cpu"])
    if toks["cuda"] != toks["cpu"]:
        raise AssertionError("faulty-device tokens differ card vs CPU")


# ---------------------------------------------------------------------------
# Phases 6-7: training
# ---------------------------------------------------------------------------


def _train(args: list, ckpt_dir: str):
    from repro_torch.launch import train as launch_train

    return launch_train.main(args + ["--ckpt-dir", ckpt_dir])


def _by_step(history) -> dict:
    """Loss of each step as it last ran (replays overwrite)."""
    return {r["step"]: r["loss"] for r in history["steps"]}


def train_phase(layers: int, workdir: str) -> dict:
    """Phase T: 4 steps with an injected failure and recovery, then the
    same 4 steps uninterrupted; equal losses at every step."""
    from repro_torch.kernels import cuda_lib

    args = [
        "--arch", "qwen2-0.5b", "--layers", str(layers), "--steps", "4",
        "--batch", "8", "--seq", "64", "--sc-backend", "pallas_moment",
        "--ckpt-every", "2", "--seed", "0",
    ]
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    _, hist = _train(args + ["--inject-failure-at", "3"],
                     os.path.join(workdir, "t_fail"))
    wall = time.perf_counter() - t0
    counts = dict(cuda_lib.launches)
    peak = torch.cuda.max_memory_allocated()
    emit(
        "train_t",
        steps=hist["steps"],
        recoveries=hist["recoveries"],
        launches=counts,
        wall_s=wall,
        max_memory_allocated=peak,
    )
    for kern in ("sc_mac_fused", "sc_mac_reduce"):
        if counts.get(kern, 0) <= 0:
            raise AssertionError(f"train_t: kernel {kern} never launched")
    if hist["recoveries"] != [(2, 2)]:
        raise AssertionError(f"train_t: recoveries {hist['recoveries']}")
    if not all(math.isfinite(r["loss"]) for r in hist["steps"]):
        raise AssertionError("train_t: a loss is not finite")

    cuda_lib.reset_launches()
    _, ref = _train(args, os.path.join(workdir, "t_ref"))
    per_step = dict(cuda_lib.launches).get("sc_mac_fused", 0) / 4
    reduce_per_step = dict(cuda_lib.launches).get("sc_mac_reduce", 0) / 4
    got, want = _by_step(hist), _by_step(ref)
    # the replayed step 3 must also equal its first run
    first3 = hist["steps"][2]["loss"]
    emit(
        "train_t_uninterrupted",
        losses=want,
        recovered=got,
        first_run_step3=first3,
        sc_mac_launches_per_step=per_step,
        sc_mac_reduce_launches_per_step=reduce_per_step,
        bitwise_equal=got == want and first3 == want[3],
    )
    if got != want or first3 != want[3]:
        raise AssertionError("train_t: recovered losses differ from the "
                             "uninterrupted run's")
    prof = profile_step(layers)
    # the profiler slows the host; the idle share is taken against the
    # unprofiled steps' median
    step_ms = float(np.median([r["ms"] for r in ref["steps"][1:]]))
    idle = None
    if prof["device_ms"]:
        idle = 1 - prof["device_ms"] / step_ms
    emit("train_t_summary", median_step_ms=step_ms, idle_share=idle,
         sc_mac_ms_per_step=prof["by_class_ms"]["sc_mac"],
         sc_mac_share=prof["by_class_ms"]["sc_mac"] / step_ms,
         gemm_share=prof["by_class_ms"]["gemm"] / step_ms)
    return dict(
        counts=counts,
        per_step=per_step,
        steps=ref["steps"],
        peak=peak,
        profile=prof,
    )


def profile_step(layers: int) -> dict:
    """One training step under ``torch.profiler``: device time by kernel
    class (the moment kernel, GEMMs — the straight-through backward and
    the attention einsums — and everything else)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData, make_batch
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (
        TrainConfig,
        make_train_step,
        train_state_init,
    )

    cfg = get_config("qwen2-0.5b").replace(
        n_layers=layers,
        sc_backend="pallas_moment",
        param_dtype=torch.float32,
        act_dtype=torch.float32,
    )
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=1))
    state = train_state_init(0, cfg, tcfg)
    step = make_train_step(cfg, tcfg)
    batch = make_batch(SyntheticLMData(cfg.vocab, 64, 8), 0)
    state, _ = step(state, batch)  # warm-up

    def traced_step():
        new_state, m = step(state, batch)
        float(m["loss"])
        return new_state

    state, tr = device_trace(traced_step)
    classes = {"sc_mac": 0.0, "gemm": 0.0, "other": 0.0}
    for name, (ms, _) in tr["kernels"].items():
        low = name.lower()
        if "sc_mac" in low:
            cls = "sc_mac"
        elif "gemm" in low or "cutlass" in low or "matmul" in low:
            cls = "gemm"
        else:
            cls = "other"
        classes[cls] += ms
    out = dict(
        profiled_wall_ms=tr["wall_ms"],
        device_ms=tr["device_ms"],
        by_class_ms=classes,
        top=_top(tr, 8),
        parts_ms=step_parts(state, cfg, tcfg),
    )
    emit("train_t_profile", **out)
    del state
    torch.cuda.empty_cache()
    return out


def step_parts(state, cfg, tcfg) -> dict:
    """CUDA-event times of the plain-torch parts of a step that touch the
    whole vocabulary or every parameter: one unembed noise draw
    (``ctr_rng.normal`` at 512 x vocab), one encode of the tied table,
    and one AdamW update."""
    from repro_torch.optim import adamw_update
    from repro_torch.sc import ScConfig, ctr_rng, encoding

    key = ctr_rng.prng_key(1)
    params = state["params"]
    table_t = params["embed"]["table"].T
    sc_cfg = ScConfig()
    grads = params  # same shapes: the update's cost does not see values
    return dict(
        unembed_noise=time_ms(
            lambda: ctr_rng.normal(key, (512, cfg.vocab), device="cuda"), 3
        ),
        unembed_encode=time_ms(lambda: encoding.encode(table_t, sc_cfg), 3),
        adamw_update=time_ms(
            lambda: adamw_update(grads, state["opt"], params, tcfg.optimizer),
            3,
        ),
    )


def train_cross_device(workdir: str) -> None:
    """The tiny trainer on the card and on the CPU: losses within 1e-4."""
    args = [
        "--arch", "paper-sc", "--smoke", "--steps", "2", "--batch", "2",
        "--seq", "16", "--sc-backend", "pallas_moment",
    ]
    losses = {}
    for dev in ("cuda", "cpu"):
        _, hist = _train(args + ["--device", dev],
                         os.path.join(workdir, f"x_{dev}"))
        losses[dev] = hist["loss"]
    rel = max(
        abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"])
    )
    emit("train_cross_device", cuda=losses["cuda"], cpu=losses["cpu"],
         max_rel=rel)
    if not rel <= 1e-4:
        raise AssertionError(f"train losses differ card vs CPU: {rel}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2, help="depth (<= 24)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not 1 <= args.layers <= 24:
        raise SystemExit("--layers must be in 1..24")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card, rates = environment()
    fused = check_sc_fused(rates)
    attn = check_attention(rates)
    mac = check_sc_mac(rates)
    muls = check_sc_mul(rates)

    from repro_torch.configs import get_config
    from repro_torch.serve import ServeOptions

    cfg = get_config("qwen2-0.5b").replace(
        n_layers=args.layers,
        sc_backend="pallas_bitexact",
        sc_nbit=1024,
        paged_attn="fused_sc",
    )
    params = _qwen_params(cfg, "cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab, n).tolist() for n in (12, 8)]
    opts = ServeOptions(
        paged=True, slots=2, block_size=16, prefill_chunk=8, max_len=64
    )
    counts_a, ticks_a, eng_a, trace_a = serve_phase(
        "serve_a",
        cfg,
        opts,
        prompts,
        4,
        params,
        ("sc_fused", "paged_attention_fused_sc"),
        traced_tick=A_TRACED_TICK,
    )
    attention_trace(trace_a, cfg, opts, "serve_a_trace")
    # the untraced decode ticks (ticks 0 and 1 prefill the prompts)
    decode_a = float(np.median(
        [t for i, t in enumerate(ticks_a) if i >= 2 and i != A_TRACED_TICK]
    ))
    un_ms = unembed_ms(params, cfg, opts.slots)
    emit(
        "serve_a_unembed",
        unembed_ms=un_ms,
        median_tick_ms=decode_a,
        unembed_share=un_ms / decode_a,
    )
    counts_b, _, _, _ = serve_phase(
        "serve_b",
        cfg,
        opts.replace(slots=1, fused_attention=True),
        prompts[:1],
        4,
        params,
        ("sc_fused", "paged_attention_fused"),
    )
    tokens_a = {r.rid: list(r.generated) for r in eng_a.finished}
    serve_p = prefix_spec_phase(params, cfg, opts, prompts, tokens_a)
    val = validation_phase(params, cfg)
    faulty = faulty_serve_phase(
        params, cfg.replace(sc_backend="exact", paged_attn="unfused"),
        prompts,
    )
    del params
    torch.cuda.empty_cache()
    cross_device()
    faulty_cross_device()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        train = train_phase(args.layers, workdir)
        train_cross_device(workdir)

    serving = (counts_a, counts_b, serve_p["launches"], faulty["counts"])
    launches = {
        k: sum(c.get(k, 0) for c in serving)
        for k in set().union(*serving)
    }
    mlp = fused["mlp_wi"]
    fa = attn["paged_attention_fused"]["decode"]
    fs = attn["paged_attention_fused_sc"]["decode"]
    kernels = [
        dict(
            name="sc_fused",
            route="cuda",
            source="src/repro_torch/csrc/sc_fused.cu",
            replaces="src/repro/kernels/sc_fused.py:142",
            launches=launches.get("sc_fused", 0),
            max_abs_err=0.0,
            ms=mlp["ms"],
            plain_ms=mlp["plain_ms"],
            bound_ms=mlp["bound_ms"],
            bound_by="operations",
            library_ms=None,
            shape="rows mode M=2 K=896 N=9728 nbit=1024 (mlp_wi)",
        ),
        dict(
            name="paged_attention_fused",
            route="cuda",
            source="src/repro_torch/csrc/paged_attention.cu",
            replaces="src/repro/kernels/paged_attention.py:363",
            launches=launches.get("paged_attention_fused", 0),
            max_abs_err=fa["max_abs_err"],
            ms=fa["ms"],
            device_ms=fa["device_ms"],
            plain_ms=fa["plain_ms"],
            bound_ms=fa["bound_ms"],
            bound_by=fa["bound_by"],
            library_ms=fa["library_ms"],
            shape="b=2 sc=1 lengths 15/11 h=14 kvh=2 hd=64 bs=16 f32 "
            "(phase A's decode); by_shape: decode, prefill (sc=8, 8/0), "
            "verify (sc=3, 15/11), long (sc=1, 1023/700, 64 pages), "
            "long_verify (sc=3, 1021/700, 64 pages) and sparse (sc=1, "
            "15/11, 64 pages); ms is a wrapper call (CUDA events), "
            "device_ms its kernels in one traced call, card_work the work "
            "its passes counted on the card",
            by_shape=_by_shape(attn["paged_attention_fused"]),
        ),
        dict(
            name="paged_attention_fused_sc",
            route="cuda",
            source="src/repro_torch/csrc/paged_attention.cu",
            replaces="src/repro/kernels/paged_attention.py:422",
            launches=launches.get("paged_attention_fused_sc", 0),
            max_abs_err=fs["max_abs_err"],
            ms=fs["ms"],
            device_ms=fs["device_ms"],
            plain_ms=fs["plain_ms"],
            bound_ms=fs["bound_ms"],
            bound_by="operations",
            library_ms=None,
            shape="b=2 sc=1 lengths 15/11 h=14 kvh=2 hd=64 bs=16 nbit=1024 "
            "f32 (phase A's decode); by_shape as paged_attention_fused",
            by_shape=_by_shape(attn["paged_attention_fused_sc"]),
        ),
        dict(
            name="sc_mul_popcount",
            route="cuda",
            source="src/repro_torch/csrc/sc_mul.cu",
            replaces="src/repro/kernels/sc_mul.py:83",
            launches=val["counts"].get("sc_mul_popcount", 0),
            max_abs_err=max(r["max_abs_err"] for r in muls.values()),
            ms=muls["chunk"]["ms"],
            plain_ms=muls["chunk"]["plain_ms"],
            bound_ms=muls["chunk"]["bound_ms"],
            bound_by=muls["chunk"]["bound_by"],
            library_ms=None,
            shape="M=65536 MULs W=32 (nbit 1024): one chunk of "
            "pallas_bitexact's stream walk, the size of most of phase "
            "V's launches; launches from phase V",
        ),
        dict(
            name="sc_mac_fused",
            route="cuda",
            source="src/repro_torch/csrc/sc_mac.cu",
            replaces="src/repro/kernels/sc_mac.py:101",
            launches=train["counts"].get("sc_mac_fused", 0),
            max_abs_err=mac["unembed"]["max_abs_err"],
            ms=mac["unembed"]["ms"],
            plain_ms=mac["unembed"]["plain_ms"],
            bound_ms=mac["unembed"]["bound_ms"],
            bound_by=mac["unembed"]["bound_by"],
            bound_fp32_ms=mac["unembed"]["bound_fp32_ms"],
            library_ms=mac["unembed"]["library_ms"],
            shape="M=512 K=896 N=151936 f32 on the operand grid, w the "
            "K-major view table.T (tied unembed); max_abs_err relative to "
            "max |out|; bound 3xTF32, 5 products a pair on the grid",
        ),
        dict(
            name="sc_mac_reduce",
            route="cuda",
            source="src/repro_torch/csrc/sc_mac.cu",
            replaces="src/repro/kernels/sc_mac.py:101",
            launches=train["counts"].get("sc_mac_reduce", 0),
            max_abs_err=mac["reduce"]["max_abs_err"],
            ms=mac["reduce"]["ms"],
            plain_ms=mac["reduce"]["plain_ms"],
            bound_ms=mac["reduce"]["bound_ms"],
            bound_by="bytes",
            library_ms=None,
            shape=f"partials {tuple(mac['reduce']['shape'])}: kernel 5's "
            "split-K pass at mlp_wo (the TPU kernel's sequential K axis); "
            "max_abs_err relative to max |out|",
        ),
        dict(
            name="sc_mac_fused_prng",
            route="cuda",
            source="src/repro_torch/csrc/sc_mac.cu",
            replaces="src/repro/kernels/sc_mac.py:139",
            launches=train["counts"].get("sc_mac_fused_prng", 0),
            max_abs_err=mac["prng"]["max_abs_err"],
            ms=mac["prng"]["ms"],
            plain_ms=mac["prng"]["plain_ms"],
            bound_ms=mac["prng"]["bound_ms"],
            bound_by=mac["prng"]["bound_by"],
            bound_fp32_ms=mac["prng"]["bound_fp32_ms"],
            library_ms=None,
            shape="M=512 K=896 N=151936 f32 on the operand grid, taken on "
            "the general route (bound 9 products a pair); no path of the "
            "package runs it; max_abs_err relative to max |out|",
        ),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
