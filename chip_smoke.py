"""Drive the PyTorch/CUDA port's paged SC serving path and its trainer
on one GPU.

    python3 chip_smoke.py [--layers N]

Phases, each printing one JSON line (any failure raises, so the exit
code is non-zero):

1. environment (card name and power limit, torch / CUDA / nvcc versions)
   and the build of every CUDA kernel from ``src/`` (one ``nvcc`` per
   source, all at once);
2. each kernel against its plain PyTorch version on the card at the
   main paths' shapes (``sc_fused`` bit-equal; both paged-attention
   kernels within 1e-5 in float32; both moment kernels within 1e-5 of
   max |out|, plus the in-kernel noise's mean and variance), with its
   median time, the plain version's time, the least time the card could
   take (``bound_ms``), and a PyTorch yardstick where one computes the
   same function (``scaled_dot_product_attention``; three float32
   ``torch.matmul`` calls plus the moment epilogue);
3. serve phase A: qwen2-0.5b at full width, depth cut to ``--layers``
   (default 2), bf16, random weights from seed 0, ``pallas_bitexact``
   (the fused SC matmul kernel) with ``fused_sc`` attention at
   nbit 1024: two greedy requests through ``build_engine``;
4. serve phase B: phase A's model with ``paged_attn="fused"``, one slot,
   one request;
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
8. the kernels line and the device line.

Launch counts are reset just before phases A, B and T and read just
after each; a kernel of a phase's path that did not launch fails the
run.  Without a CUDA device the script exits non-zero before printing
any result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
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
    }
    emit("sass", **{n: sass_census(n) for n in cuda_lib.SOURCES})
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
            fn = line.split(":", 1)[1].strip()[:48]
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
    return {
        fn: dict(sorted(ops.items(), key=lambda kv: -kv[1])[:8])
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


def _attn_inputs(rng, sc: int, dtype=torch.float32):
    b, h, kvh, hd, bs, nb = 2, 14, 2, 64, 16, 4
    n_pages = 1 + b * nb
    dev = "cuda"
    kp = torch.tensor(rng.normal(size=(n_pages, bs, kvh, hd)), dtype=dtype)
    vp = torch.tensor(rng.normal(size=(n_pages, bs, kvh, hd)), dtype=dtype)
    q = torch.tensor(rng.normal(size=(b, sc, h, hd)), dtype=dtype)
    perm = rng.permutation(np.arange(1, n_pages))[: b * nb]
    bt = torch.tensor(perm.reshape(b, nb), dtype=torch.int32)
    lengths = [15, 11] if sc == 1 else [8, 0]
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


def check_attention(rates: dict) -> dict:
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import attention

    rng = np.random.default_rng(2)
    nbit = 1024
    out = {"paged_attention_fused": {}, "paged_attention_fused_sc": {}}
    for sc in (1, 8):
        keys, q, kp, vp, bt, ln = _attn_inputs(rng, sc)
        hd = q.shape[-1]
        bytes_ = _attn_bytes(q, kp, bt, ln)
        pairs = _live_pairs(q, ln)

        # exact QK^T
        got = pa.paged_attention_fused(q, kp, vp, bt, ln)
        ref = pa.paged_attention_fused_plain(q, kp, vp, bt, ln)
        err = float((got - ref).abs().max())
        if not err <= 1e-5:
            raise AssertionError(f"paged_attention_fused sc={sc}: {err}")
        plain_ms = time_ms(
            lambda: pa.paged_attention_fused_plain(q, kp, vp, bt, ln), 10
        )
        ms = time_ms(lambda: pa.paged_attention_fused(q, kp, vp, bt, ln), 20)
        flops = 4 * pairs * hd
        t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / FP32_FLOPS
        bound = max(t_bytes, t_ops) * 1e3
        by = "bytes" if t_bytes >= t_ops else "operations"
        lib_ms = _sdpa_ms(q, kp, vp, bt, ln, attention)
        rec = dict(
            sc=sc,
            max_abs_err=err,
            ms=ms,
            plain_ms=plain_ms,
            bound_ms=bound,
            bound_by=by,
            library_ms=lib_ms,
            bytes=bytes_,
        )
        out["paged_attention_fused"][sc] = rec
        emit("kernel_check", kernel="paged_attention_fused", **rec)

        # SC-sampled QK^T
        kw = dict(nbit=nbit)
        got = pa.paged_attention_fused_sc(keys, q, kp, vp, bt, ln, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = pa.paged_attention_fused_sc_plain(keys, q, kp, vp, bt, ln, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = float((got - ref).abs().max())
        if not err <= 1e-5:
            raise AssertionError(f"paged_attention_fused_sc sc={sc}: {err}")
        ms = time_ms(
            lambda: pa.paged_attention_fused_sc(keys, q, kp, vp, bt, ln, **kw),
            5,
        )
        bound_s = int_bound_s(pairs * hd, nbit, rates)
        bound = max(bound_s, bytes_ / HBM_BYTES_PER_S) * 1e3
        rec = dict(
            sc=sc,
            max_abs_err=err,
            ms=ms,
            plain_ms=plain_ms,
            bound_ms=bound,
            bound_by="operations",
            library_ms=None,
            sc_muls=pairs * hd,
        )
        out["paged_attention_fused_sc"][sc] = rec
        emit("kernel_check", kernel="paged_attention_fused_sc", **rec)
    return out


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


def _moment_operands(rng, m: int, k: int, n: int):
    """Signed probabilities on the 10-bit grid (what ``pallas_moment``
    hands the kernel) and standard-normal noise, made on the card."""
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(2**31)))

    def grid(shape):
        v = torch.rand(shape, generator=gen, device="cuda") * 2 - 1
        return torch.round(v * 1024) / 1024

    z = torch.randn((m, n), generator=gen, device="cuda")
    return grid((m, k)), grid((k, n)), z


def _moment_bound(m: int, k: int, n: int, rates: dict, noise_in: bool):
    """(bound ms, bound_by): 3 FMAs (6 flops) per operand pair on the
    FP32 CUDA cores against x, w (and the noise) read once and the
    output written once."""
    flops = 6 * m * k * n
    bytes_ = 4 * (m * k + k * n + (2 if noise_in else 1) * m * n)
    t_ops, t_bytes = flops / rates["fp32"], bytes_ / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes \
        else "bytes"


def check_sc_mac(rates: dict) -> dict:
    """Kernels 5 and 6 at the trainer's shapes (M = batch 8 x seq 64 rows;
    K = d_model 896, or d_ff 4864 for the MLP's output projection)."""
    from repro_torch.kernels import sc_mac as km

    rng = np.random.default_rng(3)
    nbit = 1024
    m = 512
    rows = {}
    for name, k, n in (
        ("unembed", 896, 151936),
        ("mlp_wi", 896, 9728),
        ("mlp_wo", 4864, 896),
        ("wq", 896, 896),
        ("wk", 896, 128),
    ):
        x, w, z = _moment_operands(rng, m, k, n)
        got = km.sc_mac_fused(x, w, z, nbit=nbit)
        ref = km.sc_mac_fused_plain(x, w, z, nbit=nbit)
        err = float((got - ref).abs().max() / ref.abs().max())
        if not err <= 1e-5:
            raise AssertionError(f"sc_mac_fused {name}: rel err {err}")
        ms = time_ms(lambda: km.sc_mac_fused(x, w, z, nbit=nbit), 10)
        plain_ms = time_ms(
            lambda: km.sc_mac_fused_plain(x, w, z, nbit=nbit), 10
        )
        xa, wa, xq, wq = x.abs(), w.abs(), x * x, w * w

        def library():
            mean = torch.matmul(x, w)
            p = torch.matmul(xa, wa)
            p2 = torch.matmul(xq, wq)
            var = torch.clamp_min(p - p2, 0.0) * (1.0 / nbit)
            return mean + z * torch.sqrt(var)

        lib_ms = time_ms(library, 10)
        bound, by = _moment_bound(m, k, n, rates, True)
        rows[name] = dict(
            shape=[m, k, n],
            max_abs_err=err,
            ms=ms,
            plain_ms=plain_ms,
            bound_ms=bound,
            bound_by=by,
            library_ms=lib_ms,
            tflops=6 * m * k * n / ms / 1e9,
        )
        emit("kernel_check", kernel="sc_mac_fused", case=name, **rows[name])
        del x, w, z, got, ref, xa, wa, xq, wq
    torch.cuda.empty_cache()

    # kernel 6 at the unembed shape: against its plain version, and its
    # noise z = (out - mean) / sd must be standard normal
    k, n = 896, 151936
    x, w, _ = _moment_operands(rng, m, k, n)
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
    ms = time_ms(lambda: km.sc_mac_fused_prng(seed, x, w, nbit=nbit), 10)
    plain_ms = time_ms(
        lambda: km.sc_mac_fused_prng_plain(seed, x, w, nbit=nbit), 3
    )
    bound, by = _moment_bound(m, k, n, rates, False)
    rows["prng"] = dict(
        shape=[m, k, n],
        max_abs_err=err,
        noise_mean=mu,
        noise_var=var,
        ms=ms,
        plain_ms=plain_ms,
        bound_ms=bound,
        bound_by=by,
        library_ms=None,
    )
    emit("kernel_check", kernel="sc_mac_fused_prng", case="unembed",
         **rows["prng"])
    del x, w, got
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


def serve(params, cfg, opts, prompts, max_new: int, device):
    from repro_torch.serve import Request, build_engine

    eng = build_engine(params, cfg, opts, device=device)
    for rid, prompt in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=max_new))
    tick_ms = []
    while eng.scheduler.has_work():
        t0 = time.perf_counter()
        eng.step()
        if device != "cpu":
            torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
    toks = {r.rid: list(r.generated) for r in eng.finished}
    return eng, toks, tick_ms


def serve_phase(name, cfg, opts, prompts, max_new, params, expect):
    from repro_torch.kernels import cuda_lib

    cuda_lib.reset_launches()
    eng, toks, tick_ms = serve(params, cfg, opts, prompts, max_new, "cuda")
    counts = dict(cuda_lib.launches)
    n_tok = sum(len(t) for t in toks.values())
    emit(
        name,
        tokens=toks,
        ticks=eng.ticks,
        tick_ms=tick_ms,
        wall_s=sum(tick_ms) / 1e3,
        launches=counts,
    )
    for k in expect:
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"{name}: kernel {k} never launched")
    if n_tok != len(prompts) * max_new:
        raise AssertionError(f"{name}: {n_tok} tokens generated")
    if not all(0 <= t < cfg.vocab for ts in toks.values() for t in ts):
        raise AssertionError(f"{name}: token outside the vocabulary")
    return counts, tick_ms


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
        _, toks[device], _ = serve(params, cfg, opts, prompts, 5, device)
    emit("cross_device", cuda=toks["cuda"], cpu=toks["cpu"])
    if toks["cuda"] != toks["cpu"]:
        raise AssertionError("greedy tokens differ between card and CPU")


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
    if counts.get("sc_mac_fused", 0) <= 0:
        raise AssertionError("train_t: kernel sc_mac_fused never launched")
    if hist["recoveries"] != [(2, 2)]:
        raise AssertionError(f"train_t: recoveries {hist['recoveries']}")
    if not all(math.isfinite(r["loss"]) for r in hist["steps"]):
        raise AssertionError("train_t: a loss is not finite")

    cuda_lib.reset_launches()
    _, ref = _train(args, os.path.join(workdir, "t_ref"))
    per_step = dict(cuda_lib.launches).get("sc_mac_fused", 0) / 4
    got, want = _by_step(hist), _by_step(ref)
    # the replayed step 3 must also equal its first run
    first3 = hist["steps"][2]["loss"]
    emit(
        "train_t_uninterrupted",
        losses=want,
        recovered=got,
        first_run_step3=first3,
        sc_mac_launches_per_step=per_step,
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
    from torch.profiler import ProfilerActivity, profile

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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        state, m = step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    classes = {"sc_mac": 0.0, "gemm": 0.0, "other": 0.0}
    top = []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if not us or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.key
        low = name.lower()
        if "sc_mac" in low:
            cls = "sc_mac"
        elif "gemm" in low or "cutlass" in low or "matmul" in low:
            cls = "gemm"
        else:
            cls = "other"
        classes[cls] += us / 1e3
        top.append((us / 1e3, name[:60]))
    top.sort(reverse=True)
    busy = sum(classes.values())
    out = dict(
        profiled_wall_ms=wall_ms,
        device_ms=busy if busy else None,
        by_class_ms=classes,
        top=[[round(t, 3), n] for t, n in top[:8]],
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
    counts_a, ticks_a = serve_phase(
        "serve_a",
        cfg,
        opts,
        prompts,
        4,
        params,
        ("sc_fused", "paged_attention_fused_sc"),
    )
    un_ms = unembed_ms(params, cfg, opts.slots)
    emit(
        "serve_a_unembed",
        unembed_ms=un_ms,
        median_tick_ms=float(np.median(ticks_a)),
        unembed_share=un_ms / float(np.median(ticks_a)),
    )
    counts_b, _ = serve_phase(
        "serve_b",
        cfg,
        opts.replace(slots=1, fused_attention=True),
        prompts[:1],
        4,
        params,
        ("sc_fused", "paged_attention_fused"),
    )
    del params
    torch.cuda.empty_cache()
    cross_device()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        train = train_phase(args.layers, workdir)
        train_cross_device(workdir)

    launches = {
        k: counts_a.get(k, 0) + counts_b.get(k, 0)
        for k in set(counts_a) | set(counts_b)
    }
    mlp = fused["mlp_wi"]
    fa = attn["paged_attention_fused"][1]
    fs = attn["paged_attention_fused_sc"][1]
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
            plain_ms=fa["plain_ms"],
            bound_ms=fa["bound_ms"],
            bound_by=fa["bound_by"],
            library_ms=fa["library_ms"],
            shape="b=2 sc=1 h=14 kvh=2 hd=64 bs=16 f32",
        ),
        dict(
            name="paged_attention_fused_sc",
            route="cuda",
            source="src/repro_torch/csrc/paged_attention.cu",
            replaces="src/repro/kernels/paged_attention.py:422",
            launches=launches.get("paged_attention_fused_sc", 0),
            max_abs_err=fs["max_abs_err"],
            ms=fs["ms"],
            plain_ms=fs["plain_ms"],
            bound_ms=fs["bound_ms"],
            bound_by="operations",
            library_ms=None,
            shape="b=2 sc=1 h=14 kvh=2 hd=64 bs=16 nbit=1024 f32",
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
            library_ms=mac["unembed"]["library_ms"],
            shape="M=512 K=896 N=151936 f32 (tied unembed); "
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
            library_ms=None,
            shape="M=512 K=896 N=151936 f32; no path of the package "
            "runs it; max_abs_err relative to max |out|",
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
