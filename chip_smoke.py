"""Drive the PyTorch/CUDA port's paged and fixed-slot SC serving paths,
its serve-fleet failover, serving on a device mesh of 4 ranks, the
paper's cell model, MoE, SSM and hybrid
serving, its trainer (dense, SSM, hybrid and audio; and on a device mesh
of 4 ranks), its validation / faulty-device path, the dry-run's
cost account against two measured cells, the launch-tile autotuner and
the four examples on one GPU.

    python3 chip_smoke.py [--layers N] [--moe-layers N] [--ssm-layers N]
                          [--hybrid-groups N] [--audio-layers N]

Phases, each printing one JSON line (any failure raises, so the exit
code is non-zero):

1. environment (card name and power limit, torch / CUDA / nvcc versions)
   and the build of every CUDA kernel from ``src/`` (one ``nvcc`` per
   source, all at once);
2. each kernel against its plain PyTorch version on the card at the
   main paths' shapes (kernel 4 also at every size phase V launches
   and at a rank's block of phase FM's sharded wq call;
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
   bit-equal; kernel 1 also with one key a call at phase F's prefill
   shape and at a rank's blocks of phase FM (mlp_wi, mlp_wo, the
   prefill's wq and unembed), at phase M's expert, router and wq shapes
   and at phases S and H's wz, wdt and out shapes, the plain version holding the first 128
   columns of the wide ones; both attention kernels also at phase M's
   and phase H's heads), with its median time, the plain version's
   time, the least time the card could take (``bound_ms``; for the
   moment kernels the faster of 3xTF32 on the tensor cores and FP32
   FMAs, with the FP32 bound beside it), and a PyTorch yardstick where one computes the
   same function (``scaled_dot_product_attention``; three float32
   ``torch.matmul`` calls plus the moment epilogue, timed in turns with
   the kernel); the SASS census must show the moment kernel's wgmma
   (HGMMA) opcodes; kernel 5 also at the family training phases' shapes
   (TS's row-key wz, wdt and out at M = 2,048 and its tied unembed, TH's
   wz, out and shared-MLP wi / wo at M = 1,024, TA's MLP and frontend
   projection at M = 512), and at each row-key shape the whole
   ``sc_dot_rows`` route: one kernel-5 launch for all rows, within 1e-5
   of the ``moment`` rows route in torch ops;
   phase AT, the launch-tile autotuner (``sc/autotune.py``): kernel 1
   under every candidate tile (threads a block, K split) at phase A's
   wk and mlp_wi, phase F's prefill wk and phase S's wdt, and kernels 2
   and 3 under every candidate (logits-pass threads) at phase A's
   decode and prefill in bf16 and float32: every output, and kernel 3's
   SC logits, bit-equal to the heuristic tile's (kernel 1's heuristic
   also to the plain version over ``PLAIN_COLS`` columns); each
   candidate's ms (the attention calls' on the device clock), the best,
   the heuristic's and the shipped cache's;
3. serve phase A: qwen2-0.5b at full width, depth cut to ``--layers``
   (default 2), bf16, random weights from seed 0, ``pallas_bitexact``
   (the fused SC matmul kernel) with ``fused_sc`` attention at
   nbit 1024: two greedy requests through ``build_engine``; decode
   tick 3 under ``torch.profiler``: the SC attention kernels' device
   time and launches, which must be the plan's per call, and its
   launch-tile lookups, which must all hit the shipped cache;
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
   serve phase F: phase A's model and prompts through the DEFAULT engine,
   ``build_engine(params, cfg, ServeOptions(slots=2, max_len=64))`` (the
   fixed-slot ``ServingEngine``: batch-1 prefills, one decode step over
   both slots a tick, kernel 1 with one key a call): each admission's
   prefill ms and each decode step's ms; only kernel 1 may launch; then
   the tiny configuration through that engine on the card and on the
   CPU: equal tokens;
   fleet phase FT: ``FleetSupervisor`` over 2 shards of phase A's paged
   engine with ``ChaosMonkey(at_tick=2, shard=1)``, four requests (A's
   two prompts, two new, the last sampling at 0.8): every request
   finishes, one drain, a warm resume, no shard error beyond the
   injected ones, A's tokens for A's prompts and one unfaulted engine's
   for the rest; then ``launch/serve.py --smoke`` on the card, plain and
   with ``--chaos``;
   mesh phase FM: ``launch/serve.py --mesh``'s engine, ``build_engine(
   ..., mesh=make_local_mesh(2), shard_rules=sc_shard_rules(mesh))``,
   in 4 ranks of this script (``--mesh-rank``) that it starts under
   ``torchrun`` once for phases FM and TM (each rank serves FM, then
   trains TM), sharing the card over gloo: phase F's model on a data 2
   x model 2 mesh, 4 slots, A's two prompts twice, 4 new tokens each,
   every SC call split over the ranks (``sc.sc_dot_sharded``).  Every
   rank's tokens equal; kernel 1's launches a rank equal to
   ``mesh_kernel1_plan`` and no other kernel; each rank's prefill and
   decode-step ms, peak memory and the ms of its merges.  Before it, a
   world of one (no ``torchrun``: the trivial mesh) with phase F's
   settings gives phase F's tokens; in the ranks, layer 0's wq on the
   mesh: ``pallas_fused`` (kernel 1) bit-equal to ``pallas_bitexact``
   (kernel 4) and ``pallas_moment`` (kernel 5, nbit 2^16) within 0.5 of
   the exact product, and the tiny configuration on the mesh with its
   ranks on the card and on the CPU: equal tokens; then FM-s in the same
   ranks: fixed-slot decode on the rank's block of the KV cache's
   sequence over ``model`` (``make_constrain(mesh).lay_out_cache``)
   against the whole cache, from the same random starting cache: (a)
   ``exact`` float32, 64 rows a data rank, a 32,768-position cache
   filled to 16,000-16,379, 8 teacher-forced steps across the block
   boundary at 16,384: the block half the whole cache's bytes, the peak
   at least 0.8 of that half lower, logits within 1e-5 of max |logit|
   and equal greedy tokens, one combine gather (span ``seq.combine``) a
   layer a step as ``sharding.seq.combine_plan`` counts, no kernel;
   (b) ``pallas_bitexact`` bf16, 2 rows a data rank, 2 steps across a
   64-position cache's boundary, every SC call's K split over the model
   pair: kernel 1's launches the unsharded step's, logits within 2e-2
   of max |logit| (FM_S_B_TOL); in both the ranks of a model group hold
   the same logits bits (FM-s runs with ``tensor_parallel=False``, the
   layout it came with); then FM-t in the same ranks: decode under the
   in-layer layout (``sharding/tp.py``) against the same mesh with
   ``make_constrain(..., tensor_parallel=False)``: (a) FM-s (b)'s shape
   on a whole cache (the attention on a rank's 7 of 14 heads, the MLP
   hidden's half): logits bit-equal or within 1e-6 of max |logit|,
   tokens equal, kernel 1's launches the whole layout's; (b)
   mamba2-370m at full width, 4 layers, ``exact`` float32, 2 rows a
   data rank, a 16-token prefill and 8 teacher-forced decode steps on a
   rank's block of the SSM state (``lay_out_cache``: 16 of 32 heads,
   ``conv_x`` 1,024 of 2,048): the state and ``conv_x`` half the whole
   layout's bytes, logits within 1e-5 of max |logit|, tokens equal;
   then FM-e in the same ranks: prefill and decode with the MoE FFN's
   experts over ``model`` at moonshot-v1-16b-a3b's full width, 1 layer:
   (a) ``exact`` float32 on 2 x 2 (32 of 64 experts a rank), 2 rows a
   data rank, a 16-token prefill and 4 teacher-forced decode steps
   against ``tensor_parallel=False``: logits within 1e-5 of max |logit|,
   tokens equal, no kernel; (b) ``pallas_bitexact`` bf16 on data 1 x
   model 4 (16 experts a rank), one row, a 4-token prefill with every
   one-key call whole on each rank: kernel 1's launches a rank
   ``moe_kernel1_plan``'s at 16 experts, and every rank's logits
   bit-equal to the experts-whole prefill, run once on rank 0 without a
   mesh (its launches the plan's at 64);
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
7. train phases TS (mamba2-370m at its published width, ``--ssm-layers``
   deep, batch 4 x seq 512: the SSD carry crosses a 256-token chunk),
   TH (zamba2-7b, ``--hybrid-groups`` groups, 2 x 512) and TA
   (musicgen-large, ``--audio-layers`` deep, default 2 of 48, 8 x 64
   frame embeddings from ``make_embedding_batch``): float32,
   ``pallas_moment`` at nbit 1024, ``remat="full"``, random weights from
   seed 0, 3 steps each through ``launch/train.py``; finite losses; kernel
   5's and ``sc_mac_reduce``'s launches a step equal to the count derived
   from the code before the run (``kernel5_plan``: a launch a site a
   layer, twice under remat, twice a loss chunk), kernel 5's the same at
   half the batch and half the sequence (the SSM's per-token keys take
   the row-key route, one launch a call); one step traced (kernel 5, the
   GEMMs, the rest, the idle share); then the SMOKE trainers of
   paper-sc and the three families, 2 steps on the card and on the CPU
   (``train_cross_device``): with the 10-bit operand grid off on both
   devices each step is also taken on the CPU from the card's state,
   and the loss, the grad norm, every gradient leaf and the card's
   AdamW update must agree, and so must the independent runs' losses
   (1e-4); with the grid on, the independent runs through
   ``launch/train.py`` (held within 1e-4 for paper-sc, printed for the
   families);
   train phase TM (after T): training on a device mesh.  TM-d, in this
   process (a world of one): ``make_train_step(cfg, tcfg,
   make_local_mesh())`` against the single-device step on T's model,
   batch and optimizer, 2 steps: losses and every leaf bit for bit, and
   the losses T's.  The 4 ranks (phase FM's launch, ``--mesh-rank
   DIR``), sharing the card over gloo, ran TM-a, qwen2-0.5b at
   full width, depth ``--layers``, float32, ``pallas_moment`` nbit 1024,
   remat, global batch 8 x 64 on a data 2 x model 2 mesh, 3 steps (each
   rank its 4 rows, each SC call its K half and a SUM over the model
   pair, the gradient all-reduced over the data pair): every rank's
   step ms, peak memory, the gradient all-reduce's and the SC merges'
   shares of a step (tracer spans, the device synchronised around
   each), the bytes all-reduced, kernel 5's launches a step against
   ``kernel5_plan`` at a rank's rows and K blocks, and an exact
   checksum of every parameter and optimizer leaf after each step,
   equal on every rank; TM-b, the SMOKE trainer on the same mesh, card
   against CPU (the ranks' CPU mesh, plain versions) with the operand
   grid off: losses and gradient leaves within 1e-4; TM-c, pod 2 x data
   1 x model 2 with ``cross_pod_compress``, 2 steps: equal finite losses
   and residuals on every rank, the residual non-zero with a leading
   pod dim of 2; TM-f, TM-a's model, batch, optimizer and data on the
   same mesh with ``TrainConfig(fsdp=True)`` (each rank its FSDP ∘ TP
   shard of the parameters, ``m`` and ``v``; each layer all-gathered
   inside its checkpoint, the gradients reduce-scattered over the data
   pair), 3 steps: a rank's persistent state bytes equal to the plan
   from ``param_shardings``, its peak below TM-a's, the all-gathers,
   reduce-scatters and gradient all-reduces of each step (tracer spans)
   equal in count and bytes to ``sharding.fsdp.collective_plan``,
   kernel 5's launches a step ``kernel5_plan``'s, the step ms and the
   collectives' share, and the gathered parameters after the steps
   within 2 lr a step of TM-a's with at most 1e-3 of them past 0.2 lr
   (``TM_F_TOL_LR``), TM-f with the residual sequence whole between
   layers (``make_constrain(..., seq_parallel=False)``); TM-s, TM-f's
   run with the sequence over ``model`` (the mesh step's default,
   ``sharding/seq.py``), 2 steps: losses and every leaf's checksum
   TM-f's bit for bit, kernel 5's launches ``kernel5_plan``'s, the
   sequence's gathers a step (span ``seq.all_gather``) and the FSDP
   collectives equal in count and bytes to their plans, the step ms
   and the peak beside TM-f's (TM-a, TM-f, TM-s and TM-c run with
   ``tensor_parallel=False``, the layout they came with; TM-b with the step's
   default); TM-t, TM-s with the in-layer layout on (the mesh step's
   default: 7 heads, 1 kv head, the MLP hidden's and the loss
   vocabulary's halves a rank), 2 steps: losses within 1e-6 of TM-s's,
   every step-1 gradient leaf within 1e-5 of its max |g|, the in-layer
   collectives a step (spans ``tp.gather`` / ``tp.sum`` / ``tp.vocab``)
   equal in count and bytes to ``sharding.tp.tp_collective_plan``,
   kernel 5's launches ``kernel5_plan``'s, the step ms and the peak
   beside TM-s's; TM-cp, the same on data 1 x model 4 (14 heads do not
   divide: the context-parallel branch) against that mesh with the
   layout off; TM-e, the MoE FFN's experts over ``model``
   (``sharding/ep.py``): T's recipe at moonshot-v1-16b-a3b's full width
   (64 experts, top-6), 1 of 48 layers, FSDP on data 2 x model 2, 2
   steps with the layout on (32 experts a rank, each gathering its
   experts' block of wi / wo over ``data`` only) against
   ``tensor_parallel=False``: losses and step-1 gradients within TM-t's
   tolerances, the ``ep.*`` / ``tp.*`` spans and each layout's FSDP
   collectives a step equal to their plans, kernel 5's launches a step
   ``kernel5_plan``'s at 32 experts (the layout off's at 64), step 1's
   forward and backward peak below the layout off's (the step's own
   peak, AdamW's, printed beside it), the step ms beside it;
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
10. phase C, the paper's cell model on the card (no kernel may
    launch): the bounds of the reference's Fig. 7 / Fig. 8 tests
    (``tests/test_engine.py``, ``tests/test_variance.py``) over 1,000
    MULs each; one ``sc_multiply`` of 65,536 MULs at nbit 1024 (a 67 M
    cell state: ms, peak memory, unbiased against the deterministic
    product); 4,096 MULs on the card and on the CPU under one key: cell
    states equal except where a cell's uniform lies between the two
    devices' float32 survival probabilities (the count printed);
11. phase M: moonshot-v1-16b-a3b at its published width (64 experts,
    top-6, 16 heads of 128), depth ``--moe-layers`` (default 1), bf16,
    random weights from seed 0.  ``pallas_bitexact`` (kernel 1, one
    row-key launch per expert) with ``fused_sc`` attention (kernel 3):
    one greedy request of 8 prompt tokens and 2 new, the decode tick
    traced (kernel 1's launches must be the plan's, 4 + 1 + 128 a layer
    and the unembed; the share of its MULs on empty capacity slots);
    float32 ``exact`` with ``fused`` attention (kernel 2): the paged
    engine's greedy tokens equal the fixed-slot engine's; both MoE SMOKE
    configs (1 of their 2 layers) on the card and on the CPU: equal
    tokens;
12. phase S: mamba2-370m at its published width (d_model 1024, d_inner
    2048, 32 SSM heads of 64, state 128, conv 4, vocab 50,280, tied),
    depth ``--ssm-layers`` (default 4 of 48), bf16, random weights from
    seed 0.  ``pallas_bitexact`` at nbit 1024 (kernel 1 for every
    projection, token by token through ``ssm_stream``), paged, 2 slots,
    block 16, chunk 8, phase A's prompt lengths: decode tick 3 traced,
    kernel 1's launches in it (read from the wrapper's count) 6 a layer
    plus the unembed, and no attention kernel; the same prompts at chunk
    4: equal tokens; float32 ``exact``: the paged engine's tokens equal
    the fixed-slot engine's; the SMOKE config on the card and the CPU:
    equal tokens;
13. phase H: zamba2-7b at its published width (d_model 3584, d_inner
    7168, 112 SSM heads of 64, state 64, 32 heads of 112 (MHA), d_ff
    14,336, vocab 32,000, untied), ``--hybrid-groups`` groups (default 1
    of 27) of 2 SSM layers and one invocation of the shared block, bf16.
    ``pallas_bitexact`` + ``fused_sc``, paged, 1 slot, one greedy
    request of 8 prompt tokens and 2 new, the decode tick traced:
    kernel 1's launches 18 a group plus the unembed, kernel 3 one call
    an invocation (the wrappers' counts decide; the trace's device
    launches are held to the attention plan where it shows them all);
    float32 ``exact`` with ``fused`` attention (kernel 2): paged tokens
    equal fixed-slot tokens; the SMOKE config on card and CPU;
14. phase R, the dry-run's cost account (``launch/dryrun.py``,
    ``launch/cost_analysis.py``): R-a traces qwen2-0.5b's ``train_4k``,
    ``prefill_32k`` and ``decode_32k`` and moonshot-v1-16b-a3b's
    ``decode_32k`` for rank 0 of the 16 x 16 production mesh on
    ``meta`` (per-rank GB, bound and roofline terms; nothing may be
    allocated off ``meta``); R-b runs qwen2-0.5b cut to ``--layers``
    at ``train_4k`` 8 x 4,096 and ``decode_32k`` 128 x 32,768 on the
    card (``launch/profile_cell.py:measure``): the matmul FLOPs
    ``FlopCounterMode`` counts on the card equal the meta trace's for
    the same cut cell, the device time is at least 0.95 of the
    roofline's largest term, and the measured and predicted peak
    memory are printed; no kernel of the package may launch;
15. phase X: ``examples/torch_quickstart.py``, ``torch_serve_batch.py``,
    ``torch_train_sc_lm.py`` and ``torch_fault_tolerance_demo.py`` on
    the card at their defaults, started together as subprocesses: each
    must exit with 0, and their key lines are echoed;
16. the kernels line and the device line.

Launch counts are reset just before phases A, B, P, F, FT, FM (the
world of one, and in each rank), T, TM (in each rank), TS, TH, TA, V,
D, C, M, S, H and R and
read just after each; a kernel of a phase's
path that did not launch fails the run (phase AT checks kernels, as
phase 2 does; phase X's examples count in their own processes).
Without a CUDA device the
script exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
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


_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": round(time.perf_counter() - _T0, 1)}),
          flush=True)


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


PLAIN_COLS = 128  # columns of a phase-M, S or H shape the plain version holds


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
        # phase F's prefill of A's first prompt: 12 rows, one key
        ("wk_prefill_per_call", 12, 896, 128, 128, False),
        # phase M (moonshot-v1-16b-a3b): one expert's launch (1 slot x 8
        # capacity rows), the router and wq of a decode tick
        ("moe_wi", 8, 2048, 2816, 2816, True),
        ("moe_wo", 8, 1408, 2048, 2048, True),
        ("moe_router", 1, 2048, 64, 64, True),
        ("moe_wq", 1, 2048, 2048, 2048, True),
        # phase S (mamba2-370m, 2 slots): wz, wdt and out of a decode tick
        ("ssm_wz", 2, 1024, 2048, 2048, True),
        ("ssm_wdt", 2, 1024, 32, 32, True),
        ("ssm_out", 2, 2048, 1024, 1024, True),
        # phase H (zamba2-7b, 1 slot): wz and out of a decode tick
        ("hyb_wz", 1, 3584, 7168, 7168, True),
        ("hyb_out", 1, 7168, 3584, 3584, True),
        # phase FM (data 2 x model 2 mesh, one key a call): a rank's
        # block of a 4-slot decode step's mlp_wi and mlp_wo (2 rows, K
        # halved), of the 12-token prefill's wq (6 rows) and of its
        # unembed (1 row: the data axis drops, K still halves)
        ("fm_mlp_wi", 2, 448, 9728, 9728, False),
        ("fm_mlp_wo", 2, 2432, 896, 896, False),
        ("fm_prefill_wq", 6, 448, 896, 896, False),
        ("fm_unembed_window", 1, 448, 512, 151936, False),
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
        # the plain version holds the first PLAIN_COLS columns (counters
        # depend on the column index and n_orig alone): all of a wide
        # expert or SSM projection would take it minutes
        wide = name.startswith(("moe_", "ssm_", "hyb_", "fm_"))
        cols = min(n, PLAIN_COLS) if wide else n
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = kf.sc_fused_popcount_plain(keys, x, w[:, :cols].contiguous(),
                                         **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = int((got[:, :cols].long() - ref.long()).abs().max())
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
            plain_cols=cols,
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
QWEN_HEADS = (14, 2, 64)  # (heads, KV heads, head dim) of qwen2-0.5b
MOE_HEADS = (16, 16, 128)  # moonshot-v1-16b-a3b's (phase M)
# Phase M's attention shapes: the exact half's decode rows (prompts of
# 12 and 8) and a prefill chunk beside a row in its first decode.
MOE_ATTN_CASES = (
    ("moe_decode", 1, (13, 9), 2),
    ("moe_prefill", 8, (0, 8), 2),
)
HYB_HEADS = (32, 32, 112)  # zamba2-7b's shared block (phase H): MHA, g = 1
HYB_ATTN_CASES = (
    ("hyb_decode", 1, (13, 9), 2),
    ("hyb_prefill", 8, (0, 8), 2),
)


def _attn_inputs(rng, sc: int, lengths, nb: int, dtype=torch.float32,
                 heads=QWEN_HEADS):
    h, kvh, hd = heads
    b, bs = 2, 16
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
    cases = [c + (QWEN_HEADS,) for c in ATTN_CASES]
    cases += [c + (MOE_HEADS,) for c in MOE_ATTN_CASES]
    cases += [c + (HYB_HEADS,) for c in HYB_ATTN_CASES]
    for case, sc, lengths, nb, heads in cases:
        keys, q, kp, vp, bt, ln = _attn_inputs(rng, sc, lengths, nb,
                                               heads=heads)
        b, _, h, hd = q.shape
        kvh, bs = kp.shape[2], kp.shape[1]
        bytes_ = _attn_bytes(q, kp, bt, ln)
        pairs = _live_pairs(q, ln)
        shape = dict(case=case, sc=sc, lengths=list(lengths), nb=nb,
                     heads=list(heads))

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
    xa, wa, xq, wq = x.abs(), w.abs(), x * x, w * w

    def library():  # row 5's yardstick, its noise drawn by torch.randn
        mean = torch.matmul(x, w)
        p = torch.matmul(xa, wa)
        p2 = torch.matmul(xq, wq)
        var = torch.clamp_min(p - p2, 0.0) * (1.0 / nbit)
        return mean + torch.randn_like(mean) * torch.sqrt(var)

    lib_ms, ms = paired_ms(
        library, lambda: km.sc_mac_fused_prng(seed, x, w, nbit=nbit), 10)
    del xa, wa, xq, wq
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
        library_ms=lib_ms,
        vs_library=ms / lib_ms,
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


# Kernel 5 at the training phases' shapes, M = batch x seq rows: TS's
# row-key SSM calls (mamba2-370m, 4 x 512) and its tied unembed, TH's SSM
# calls and the shared block's MLP (zamba2-7b, 2 x 512), TA's MLP and the
# frontend's projection (musicgen-large, 8 x 64).
# (case, M, K, N, w the K-major table.T, reached in row-key mode)
SC_MAC_TRAIN_SHAPES = (
    ("ts_wz", 2048, 1024, 2048, False, True),
    ("ts_wdt", 2048, 1024, 32, False, True),
    ("ts_out", 2048, 2048, 1024, False, True),
    ("ts_unembed", 2048, 1024, 50280, True, False),
    ("th_wz", 1024, 3584, 7168, False, True),
    ("th_out", 1024, 7168, 3584, False, True),
    ("th_mlp_wi", 1024, 3584, 28672, False, False),
    ("th_mlp_wo", 1024, 14336, 3584, False, False),
    ("ta_mlp_wi", 512, 2048, 8192, False, False),
    ("ta_mlp_wo", 512, 8192, 2048, False, False),
    ("ta_frontend_proj", 512, 2048, 2048, False, False),
    # phase TM: a rank's blocks on the data 2 x model 2 mesh (4 of the
    # 8 x 64 rows, half of K)
    ("tm_unembed", 256, 448, 151936, True, False),
    ("tm_mlp_wi", 256, 448, 9728, False, False),
    ("tm_mlp_wo", 256, 2432, 896, False, False),
    ("tm_wq", 256, 448, 896, False, False),
)


def rows_route_check(m: int, k: int, n: int, seed: int) -> dict:
    """``pallas_moment``'s row-key route (``sc_dot_rows``) at a row-key
    shape: one kernel-5 launch (plus the split-K pass where the plan
    splits) for all m rows, within 1e-5 of max |out| of the ``moment``
    rows route in torch ops on the same keys (its plain version: the
    same scales, grid and noise rows); the call's ms and the noise
    draw's (``ctr_rng.normal_rows``)."""
    from repro_torch import sc
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import sc_mac as km
    from repro_torch.sc import backends, ctr_rng

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device="cuda")
    x = x * torch.exp(torch.randn((m, 1), generator=gen, device="cuda"))
    w = torch.randn((k, n), generator=gen, device="cuda") * 0.05
    keys = ctr_rng.split(ctr_rng.prng_key(seed, device="cuda"), m)
    cfg = sc.ScConfig(backend="pallas_moment")
    before = dict(cuda_lib.launches)
    got = sc.sc_dot_rows(keys, x, w, cfg)
    torch.cuda.synchronize()
    launched = {
        name: cuda_lib.launches[name] - before.get(name, 0)
        for name in ("sc_mac_fused", "sc_mac_reduce")
    }
    splits = km.sc_mac_plan(m, n, k)[0]
    want = {"sc_mac_fused": 1, "sc_mac_reduce": int(splits > 1)}
    if launched != want:
        raise AssertionError(f"rows route {m}x{k}x{n}: launches {launched}"
                             f", planned {want}")
    ref = backends.moment_rows(keys, x, w, cfg.replace(backend="moment"))
    err = float((got - ref).abs().max() / ref.abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"rows route {m}x{k}x{n}: rel err {err}")
    return dict(
        launches=launched,
        max_abs_err=err,
        call_ms=time_ms(lambda: sc.sc_dot_rows(keys, x, w, cfg), 5),
        noise_ms=time_ms(lambda: ctr_rng.normal_rows(keys, n), 5),
    )


def check_sc_mac_train(rates: dict) -> dict:
    """Kernel 5 at the training phases' shapes (``SC_MAC_TRAIN_SHAPES``)
    on grid operands, as ``pallas_moment`` launches it: within 1e-5 of
    max |out| of its plain version, its median ms timed in turns with
    three float32 ``torch.matmul`` calls plus the epilogue, the plain
    version's ms and the bound; at the row-key shapes also the whole
    rows route (``rows_route_check``)."""
    from repro_torch.kernels import sc_mac as km

    rng = np.random.default_rng(11)
    nbit = 1024
    rows = {}
    for name, m, k, n, kmajor, row_keys in SC_MAC_TRAIN_SHAPES:
        x, w, z = _moment_operands(rng, m, k, n, kmajor)
        ref = km.sc_mac_fused_plain(x, w, z, nbit=nbit)
        got = km.sc_mac_fused(x, w, z, nbit=nbit, on_grid=True)
        err = float((got - ref).abs().max() / ref.abs().max())
        del got, ref
        if not err <= 1e-5:
            raise AssertionError(f"sc_mac_fused {name}: rel err {err}")
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
        plain_ms = time_ms(
            lambda: km.sc_mac_fused_plain(x, w, z, nbit=nbit), 5
        )
        bound = _moment_bound(m, k, n, rates, True, True)
        splits, kper = km.sc_mac_plan(m, n, k)
        rows[name] = dict(
            shape=[m, k, n],
            w_layout="K-major view (table.T)" if kmajor else "row-major",
            row_keys=row_keys,
            splits=splits,
            k_per_split=kper,
            max_abs_err=err,
            ms=ms,
            plain_ms=plain_ms,
            library_ms=lib_ms,
            vs_library=ms / lib_ms,
            **bound,
            of_bound=bound["bound_ms"] / ms,
        )
        del x, w, z, xa, wa, xq, wq
        if row_keys:
            rows[name]["rows_route"] = rows_route_check(m, k, n, len(rows))
        emit("kernel_check", kernel="sc_mac_fused", case=name, **rows[name])
        torch.cuda.empty_cache()
    return rows


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
    # phase FM's sharded pallas_bitexact call: a rank's 2 x 448 block of
    # layer 0's wq at a 4-slot decode step (the wq row's product count;
    # walked as 12 chunks and a 16,384 tail)
    ("fm_wq_shard", 2 * 448 * 896),
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
# Phase AT: the launch-tile autotuner on the card
# ---------------------------------------------------------------------------

# Kernel 1 at (case, M, K, N, row keys): phase A's decode wk and mlp_wi,
# phase F's prefill wk (one key a call), phase S's wdt (mamba2-370m)
AT_FUSED_SHAPES = (
    ("a_wk", 2, 896, 128, True),
    ("a_mlp_wi", 2, 896, 9728, True),
    ("f_prefill_wk", 12, 896, 128, False),
    ("s_wdt", 2, 1024, 32, True),
)
AT_ATTN_CASES = ("decode", "prefill")  # phase A's, from ATTN_CASES
# the serving phases' dtype (bf16) and kernel_check's (float32)
AT_ATTN_DTYPES = (torch.bfloat16, torch.float32)


def _tile_name(tile) -> str:
    return "x".join(str(v) for v in dataclasses.astuple(tile))


def _tile_table(cands, heur, shipped, outputs, timer) -> tuple:
    """Each candidate tile's ``outputs(tile)`` (a tuple of tensors) held
    bit-equal to the heuristic's, and its ms, ``timer(tile)``; the best
    against the heuristic and the shipped tile.  Returns (the record,
    the heuristic's outputs)."""
    base = outputs(heur)
    ms = {}
    for tile in cands:
        got = outputs(tile)
        if not all(torch.equal(u, v) for u, v in zip(got, base)):
            raise AssertionError(f"tile {tile}: bits differ from the "
                                 f"heuristic {heur}'s")
        ms[_tile_name(tile)] = timer(tile)
    best = min(ms, key=ms.get)
    heur_ms = ms[_tile_name(heur)]
    return dict(
        candidates=len(ms), ms=ms, bit_equal=True,
        heuristic=_tile_name(heur), heuristic_ms=heur_ms,
        best=best, best_ms=ms[best], shipped=_tile_name(shipped),
        shipped_ms=ms.get(_tile_name(shipped)),
        best_over_heuristic=ms[best] / heur_ms,
    ), base


def autotune_phase() -> dict:
    """Every candidate tile of ``sc/autotune.py`` on the card: kernel 1
    at ``AT_FUSED_SHAPES`` (the heuristic's totals also bit-equal to the
    plain version's over the first ``PLAIN_COLS`` columns), kernels 2 and
    3 at phase A's decode and prefill in bf16 and float32 (outputs, and
    kernel 3's SC logits, bit-equal to the heuristic's).  Prints each
    candidate's ms (kernel 1: CUDA events of a call; attention: device
    ms of a call, ``autotune.device_us``, as the tuner times it), the
    best, the heuristic's and the shipped cache's."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sc_fused as kf
    from repro_torch.sc import autotune

    rng = np.random.default_rng(5)
    nbit = 1024
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for case, m, k, n, row_keys in AT_FUSED_SHAPES:
        keys = torch.tensor(rng.integers(0, 2**32, (m, 4), dtype=np.uint64)
                            .astype(np.uint32)).to("cuda")
        if not row_keys:
            keys = keys[:1].expand(m, 4).contiguous()
        x = torch.tensor(rng.uniform(-1, 1, (m, k)), dtype=torch.float32,
                         device="cuda")
        w = torch.tensor(rng.uniform(-1, 1, (k, n)), dtype=torch.float32,
                         device="cuda")
        kw = dict(k_orig=k, n_orig=n, nbit=nbit, levels=1 << 10,
                  row_keys=row_keys)

        def call(t):
            return kf.sc_fused_popcount(keys, x, w, tile=t, **kw)

        rec, (base,) = _tile_table(
            autotune.candidate_tiles(m, k, n, nbit, sms),
            autotune.heuristic_tile(m, k, n, nbit, sms),
            autotune.get_tile(m, k, n, nbit, sms=sms),
            lambda t: (call(t),), lambda t: time_ms(lambda: call(t), 3))
        cols = min(n, PLAIN_COLS)
        ref = kf.sc_fused_popcount_plain(keys, x, w[:, :cols].contiguous(),
                                         **kw)
        if not torch.equal(base[:, :cols], ref):
            raise AssertionError(f"sc_fused {case}: the heuristic tile "
                                 "differs from the plain version")
        out[case] = dict(shape=[m, k, n], row_keys=row_keys,
                         plain_cols=cols, **rec)
        emit("autotune_at", kernel="sc_fused", case=case, **out[case])

    cases = {c[0]: c for c in ATTN_CASES}
    h, kvh, hd = QWEN_HEADS
    for case, dtype in itertools.product(AT_ATTN_CASES, AT_ATTN_DTYPES):
        _, sc, lengths, nb = cases[case]
        keys, q, kp, vp, bt, ln = _attn_inputs(rng, sc, lengths, nb, dtype)
        rows, bs, b = h // kvh * sc, kp.shape[1], q.shape[0]
        dt = autotune.dtype_name(dtype)
        for name, n in (("paged_attention_fused", 0),
                        ("paged_attention_fused_sc", nbit)):
            if n:
                def call(t):
                    return pa.paged_attention_fused_sc(
                        keys, q, kp, vp, bt, ln, nbit=n, tile=t)

                def outputs(t):
                    return call(t), pa.sc_logits(keys, q, kp, bt, ln,
                                                 nbit=n, tile=t)
            else:
                def call(t):
                    return pa.paged_attention_fused(q, kp, vp, bt, ln,
                                                    tile=t)

                def outputs(t):
                    return (call(t),)

            def device_ms(t):
                plan = pa.paged_attention_plan(b, kvh, rows, sc, hd, nb, bs,
                                               n, t)
                return autotune.device_us(lambda: call(t), plan.launches,
                                          "paged_attn_") / 1e3

            rec, _ = _tile_table(
                autotune.candidate_attn_tiles(rows, bs, hd, n),
                autotune.heuristic_attn_tile(rows, bs, hd, n),
                autotune.get_attn_tile(rows, bs, hd, n, dt), outputs,
                device_ms)
            key = f"{name}_{case}_{dt}"
            out[key] = dict(rows=rows, nbit=n, sc=sc, dtype=dt,
                            lengths=list(lengths), nb=nb, clock="device",
                            **rec)
            emit("autotune_at", kernel=name, case=case, **out[key])
    return out


def tick_lookups(looked: dict) -> int:
    """Phase A's traced decode tick looked every launch tile up in the
    shipped cache: at least one hit and no miss.  Returns the hits."""
    hits = sum(v for k, v in looked.items() if "result=hit" in k)
    misses = sum(v for k, v in looked.items() if "result=miss" in k)
    emit("serve_a_autotune", tick=A_TRACED_TICK, lookups=looked, hits=hits,
         misses=misses)
    if hits == 0 or misses:
        raise AssertionError(f"serve_a: {hits} tile-cache hits and "
                             f"{misses} misses in the traced decode tick")
    return hits


# ---------------------------------------------------------------------------
# Phase X: the four examples on the card
# ---------------------------------------------------------------------------

# each example, and the lines of its output echoed (those holding a key)
X_EXAMPLES = {
    "torch_quickstart": ("SC product", "repeats", "sc_dot[", "packed",
                         "LM forward", "array backend", "done on"),
    "torch_serve_batch": ("serving", "served", "req 0"),
    "torch_train_sc_lm": ("params", "SC substrate", "exact baseline",
                          "SC loss penalty"),
    "torch_fault_tolerance_demo": ("final loss", "max |param",
                                   "BIT-IDENTICAL"),
}
X_TIMEOUT = 300  # s, for the four together


def examples_phase() -> dict:
    """The four ``examples/torch_*.py`` on the card at their defaults,
    started together as subprocesses: each must exit with 0; its key
    lines are echoed."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    procs = {
        name: subprocess.Popen(
            [sys.executable, os.path.join(HERE, "examples", f"{name}.py")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=HERE)
        for name in X_EXAMPLES
    }
    out, failed = {}, []
    try:
        for name, proc in procs.items():
            left = max(1.0, X_TIMEOUT - (time.perf_counter() - t0))
            try:
                text, _ = proc.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                proc.kill()
                text, _ = proc.communicate()
                text += f"\n[killed after {X_TIMEOUT} s]"
            lines = text.strip().splitlines()
            keep = [ln for ln in lines
                    if any(key in ln for key in X_EXAMPLES[name])]
            out[name] = dict(rc=proc.returncode,
                             seconds=time.perf_counter() - t0,
                             lines=keep if proc.returncode == 0
                             else lines[-12:])
            emit("examples_x", example=name, **out[name])
            if proc.returncode != 0:
                failed.append(name)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise AssertionError(f"examples failed on the card: {failed}")
    return out


# ---------------------------------------------------------------------------
# Phases 3-5: serving
# ---------------------------------------------------------------------------


def _qwen_params(cfg, device):
    from repro_torch.models import lm, params

    gen = torch.Generator().manual_seed(0)
    specs = lm.lm_param_specs(cfg)
    return params.init_params(specs, gen, device, cfg.param_dtype)


def serve(params, cfg, opts, prompts, max_new: int, device,
          traced_tick=None, ranges=(), stagger=None, lookups=False,
          **build):
    """Serve ``prompts`` greedily to the end.  Returns (engine, tokens by
    request, host ms per tick, trace): tick ``traced_tick`` runs under
    the profiler (``device_trace`` with ``ranges``), else trace is None;
    with ``lookups`` the trace also holds the launch-tile lookups the
    tick made (``autotune_lookups``).
    With ``stagger`` the first request is served alone until it has fed
    that many tokens (or finished), so that the rest find its blocks
    registered in the prefix cache.
    """
    from repro_torch.kernels import cuda_lib
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
            before = dict(cuda_lib.launches)
            with autotune_lookups(lookups) as looked:
                _, trace = device_trace(eng.step, ranges)
            trace["autotune"] = looked
            # the wrappers' own counts in the traced tick, beside the trace
            trace["counted"] = {
                k: n - before.get(k, 0) for k, n in cuda_lib.launches.items()
                if n - before.get(k, 0)
            }
            tick_ms.append(trace["wall_ms"])
            continue
        t0 = time.perf_counter()
        eng.step()
        if device != "cpu":
            torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
    toks = {r.rid: list(r.generated) for r in eng.finished}
    return eng, toks, tick_ms, trace


@contextlib.contextmanager
def autotune_lookups(on: bool = True):
    """The launch-tile lookups made inside the block, by series
    (``sc_autotune_lookups_total{kind, result}`` of the default
    registry, which is on for the block); an empty dict when ``on`` is
    false."""
    from repro_torch import obs

    out: dict = {}
    if not on:
        yield out
        return
    reg = obs.default_registry()
    was = reg.enabled

    def series():
        return {k: v for k, v in reg.snapshot()["counters"].items()
                if k.startswith("sc_autotune_lookups_total")}

    reg.enable()
    before = series()
    try:
        yield out
    finally:
        out.update({k: v - before.get(k, 0) for k, v in series().items()
                    if v != before.get(k, 0)})
        if not was:
            reg.disable()


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
    from repro_torch.serve import ServeOptions

    cfg = _tiny_cfg()
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
# Phases F and FT: the fixed-slot engine, and fleet failover
# ---------------------------------------------------------------------------

# kernel launch counts a phase on kernel 1 alone must leave at zero
NOT_KERNEL_1 = (
    "paged_attention_fused",
    "paged_attention_fused_sc",
    "sc_mul_popcount",
    "sc_mac_fused",
    "sc_mac_fused_prng",
    "sc_mac_reduce",
)


class _CallTimer:
    """Wraps the named functions of ``repro_torch.models.lm`` while
    installed: the synced host ms of each call, by name, in order."""

    def __init__(self, *names):
        from repro_torch.models import lm

        self.lm, self.names = lm, names
        self.ms = {n: [] for n in names}

    def __enter__(self):
        self._orig = {n: getattr(self.lm, n) for n in self.names}
        for n, fn in self._orig.items():
            def timed(*args, _fn=fn, _n=n, **kw):
                out, ms = _synced_ms(lambda: _fn(*args, **kw))
                self.ms[_n].append(ms)
                return out

            setattr(self.lm, n, timed)
        return self

    def __exit__(self, *exc):
        for n, fn in self._orig.items():
            setattr(self.lm, n, fn)


def fixed_slot_phase(params, cfg, prompts, max_new: int) -> dict:
    """Phase F: phase A's model and prompts through the DEFAULT engine,
    ``build_engine(params, cfg, ServeOptions(slots=2, max_len=64))``,
    the fixed-slot ``ServingEngine``: batch-1 prefills spliced into
    slots and one ``decode_step`` over both slots a tick, every matmul
    on kernel 1 with one key a call.  The ms of each admission prefill
    and each decode step; no other kernel may launch.  Then the tiny
    parity configuration through the default engine on the card and
    on the CPU: equal tokens."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.serve import Request, ServeOptions, ServingEngine
    from repro_torch.serve import build_engine

    opts = ServeOptions(slots=2, max_len=64)
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    eng = build_engine(params, cfg, opts, device="cuda")
    if not isinstance(eng, ServingEngine):
        raise AssertionError(f"serve_f: default engine {type(eng)}")
    for rid, prompt in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=max_new))
    tick_ms = []
    with _CallTimer("prefill", "decode_step") as timer:
        while eng.queue or any(eng.active):
            _, ms = _synced_ms(eng.step)
            tick_ms.append(ms)
    counts = dict(cuda_lib.launches)
    toks = {r.rid: list(r.generated) for r in eng.finished}
    rec = dict(
        tokens=toks,
        ticks=len(tick_ms),
        tick_ms=tick_ms,
        prefill_ms=timer.ms["prefill"],
        prompt_tokens=[len(p) for p in prompts],
        decode_ms=timer.ms["decode_step"],
        wall_s=sum(tick_ms) / 1e3,
        launches=counts,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
    )
    emit("serve_f", **rec)
    n_tok = sum(len(t) for t in toks.values())
    for ok, what in (
        (counts.get("sc_fused", 0) > 0, "kernel sc_fused never launched"),
        (not any(counts.get(k, 0) for k in NOT_KERNEL_1),
         "a kernel other than sc_fused launched"),
        (n_tok == len(prompts) * max_new, f"{n_tok} tokens generated"),
        (all(0 <= t < cfg.vocab for ts in toks.values() for t in ts),
         "token outside the vocabulary"),
        (len(timer.ms["prefill"]) == len(prompts), "prefill count"),
    ):
        if not ok:
            raise AssertionError(f"serve_f: {what}")
    fixed_slot_cross_device()
    return rec


def _tiny_cfg():
    from repro_torch.configs import get_smoke_config

    return get_smoke_config("qwen2-0.5b").replace(
        d_model=32,
        d_ff=64,
        vocab=128,
        param_dtype=torch.float32,
        act_dtype=torch.float32,
        sc_backend="pallas_bitexact",
        sc_nbit=32,
        paged_attn="fused_sc",
    )


def fixed_slot_cross_device() -> None:
    """The tiny parity-test configuration through the default
    (fixed-slot) engine on the card and on the CPU: equal tokens."""
    from repro_torch.serve import Request, ServeOptions, build_engine

    cfg = _tiny_cfg()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab, 10).tolist() for _ in range(3)]
    toks = {}
    for device in ("cuda", "cpu"):
        eng = build_engine(_qwen_params(cfg, device), cfg,
                           ServeOptions(slots=2, max_len=32), device=device)
        for rid, prompt in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=5))
        toks[device] = {r.rid: r.generated for r in eng.run_until_drained()}
    emit("serve_f_cross_device", cuda=toks["cuda"], cpu=toks["cpu"])
    if toks["cuda"] != toks["cpu"]:
        raise AssertionError("fixed-slot tokens differ between card and CPU")


FT_TEMPERATURE = 0.8  # rid 3 of phase FT samples


def fleet_phase(params, cfg, opts, prompts_a, tokens_a, max_new) -> dict:
    """Phase FT: ``FleetSupervisor`` over 2 shards of phase A's paged
    engine (kernels 1 and 3) with ``ChaosMonkey(at_tick=2, shard=1)``.
    Rids 0-1 are phase A's prompts (their tokens must be phase A's),
    rids 2-3 new (rid 3 sampling; their tokens must be one unfaulted
    engine's).  Every request finishes, one drain, at least one warm
    resume, and no shard counts an error the monkey did not inject.
    Then ``launch/serve.py --smoke`` on the card, plain and ``--chaos``:
    every request finishes."""
    from repro_torch import obs
    from repro_torch.ft import ChaosMonkey, FleetSupervisor
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import serve as serve_launch
    from repro_torch.serve import Request, build_engine

    rng = np.random.default_rng(2)
    prompts = list(prompts_a) + [
        rng.integers(3, cfg.vocab, n).tolist() for n in (10, 6)
    ]

    def requests():
        return [
            Request(rid=rid, prompt=p, max_new_tokens=max_new,
                    temperature=FT_TEMPERATURE if rid == 3 else 0.0)
            for rid, p in enumerate(prompts)
        ]

    tracer = obs.Tracer()
    monkey = ChaosMonkey(at_tick=2, shard=1)
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    fleet = FleetSupervisor(
        lambda s: build_engine(params, cfg, opts, device="cuda",
                               tracer=tracer),
        shards=2,
        chaos=monkey,
    )
    homes = [fleet.submit(r) for r in requests()]
    tick_ms = []
    while fleet.has_work():
        _, ms = _synced_ms(fleet.step)
        tick_ms.append(ms)
        if len(tick_ms) > 100:
            raise AssertionError("serve_ft: the fleet does not drain")
    counts = dict(cuda_lib.launches)
    toks = {r.rid: list(r.generated) for r in fleet.finished}
    resumes = [s.attrs for s in tracer.spans if s.name == "request.resume"]
    errors = [e.metrics.value("serve_errors_total") for e in fleet.engines]
    ref = build_engine(params, cfg, opts, device="cuda")
    for r in requests()[2:]:
        ref.submit(r)
    ref_toks = {r.rid: list(r.generated) for r in ref.run_until_drained()}
    rec = dict(
        tokens=toks,
        homes=homes,
        ticks=len(tick_ms),
        tick_ms=tick_ms,
        wall_s=sum(tick_ms) / 1e3,
        drains=fleet.drains,
        resumed=fleet.resumed,
        readmissions=fleet.readmissions,
        resumes=resumes,
        serve_errors=errors,
        unfaulted_tokens=ref_toks,
        launches=counts,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
    )
    emit("serve_ft", **rec)
    want_errors = [monkey.errors if s == monkey.shard else 0
                   for s in range(fleet.shards)]
    for ok, what in (
        (sorted(toks) == [0, 1, 2, 3], f"finished {sorted(toks)}"),
        (all(len(t) == max_new for t in toks.values()), "short requests"),
        (fleet.drains == 1 and fleet.resumed > 0,
         f"{fleet.drains} drains, {fleet.resumed} resumed"),
        (errors == want_errors and not fleet.failures,
         f"serve_errors_total {errors}, failures {fleet.failures}"),
        (any(a["warm"] for a in resumes), "no warm resume"),
        (all(toks[rid] == tokens_a[rid] for rid in (0, 1)),
         "rids 0-1 differ from phase A"),
        (all(toks[rid] == ref_toks[rid] for rid in (2, 3)),
         "rids 2-3 differ from the unfaulted engine"),
    ):
        if not ok:
            raise AssertionError(f"serve_ft: {what}")
    for k in ("sc_fused", "paged_attention_fused_sc"):
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"serve_ft: kernel {k} never launched")
    runs = {}
    for name, extra in (("default", []), ("chaos", ["--chaos"])):
        argv = ["--smoke", "--requests", "4", "--slots", "2",
                "--max-len", "48", "--max-new", "4"] + extra
        done, ms = _synced_ms(lambda: serve_launch.main(argv))
        runs[name] = dict(ms=ms, finished=sorted(r.rid for r in done),
                          tokens=sum(len(r.generated) for r in done))
        if runs[name]["finished"] != [0, 1, 2, 3]:
            raise AssertionError(f"serve_ft launcher {name}: {runs[name]}")
    emit("serve_ft_launcher", **runs)
    rec["launcher"] = runs
    return rec


# ---------------------------------------------------------------------------
# Phases 8-9: validation (V) and serving on a faulty device (D)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Phase FM: the fixed-slot engine on a device mesh (4 ranks sharing the card)
# ---------------------------------------------------------------------------

FM_RANKS = 4
FM_MODEL_PARALLEL = 2  # a data 2 x model 2 mesh
FM_SLOTS = 4
FM_NEW = 4
MESH_TIMEOUT = 900  # s, the limit of the 4-rank launch of FM and TM
# the reference's sharded moment check (tests/_sharded_subprocess.py):
# nbit 2^16, within 0.5 of the exact product
FM_MOMENT_NBIT = 1 << 16
FM_MOMENT_BOUND = 0.5


def mesh_kernel1_plan(cfg, requests: int, max_new: int) -> int:
    """Kernel 1's launches on each rank of the mesh engine, derived from
    the code: one a dense call (the rank's block under one key), a call
    a site of the forward (``arch.dense_workload``), over one prefill a
    request and ``max_new - 1`` decode steps (every request admitted in
    the first tick)."""
    from repro_torch import arch

    per_forward = sum(s.count for s in arch.dense_workload(cfg, 1))
    return per_forward * (requests + max_new - 1)


class _GatherTimer:
    """Wraps ``repro_torch.sc.sharded._gather`` (the SUM and the row
    gather of every sharded call) while installed: the synced host ms of
    each."""

    def __enter__(self):
        from repro_torch.sc import sharded

        self.mod, self.orig, self.ms = sharded, sharded._gather, []

        def timed(*args, **kw):
            out, ms = _synced_ms(lambda: self.orig(*args, **kw))
            self.ms.append(ms)
            return out

        sharded._gather = timed
        return self

    def __exit__(self, *exc):
        self.mod._gather = self.orig


def _fm_serve(params, cfg, mesh, prompts, slots: int, max_len: int,
              max_new: int):
    """An engine holding greedy ``prompts``, built by ``build_engine(...,
    mesh=, shard_rules=)`` as ``launch/serve.py --mesh`` builds it."""
    from repro_torch.serve import Request, ServeOptions, build_engine
    from repro_torch.sharding import sc_shard_rules

    opts = ServeOptions(mesh=True, model_parallel=mesh.shape["model"],
                        slots=slots, max_len=max_len)
    eng = build_engine(params, cfg, opts, device=mesh.device, mesh=mesh,
                       shard_rules=sc_shard_rules(mesh))
    for rid, prompt in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=max_new))
    return eng


def fm_sharded_kernels(params, mesh, prompts) -> dict:
    """Phase FM, check 4 (on every rank): layer 0's wq on the mesh at a
    decode step's width, the first token of each prompt embedded
    (FM_SLOTS x 896 @ 896 x 896, a rank's block 2 x 448): ``pallas_fused``
    (kernel 1) and ``pallas_bitexact`` (kernel 4, fed its stream) bit for
    bit, and ``pallas_moment`` (kernel 5) at nbit 2^16 within the
    reference's 0.5 of the exact product."""
    from repro_torch import sc
    from repro_torch.kernels import cuda_lib
    from repro_torch.sc import ctr_rng
    from repro_torch.sharding import sc_shard_rules

    table = params["embed"]["table"]
    rows = torch.tensor([p[0] for p in prompts[:FM_SLOTS]])
    x = table[rows.to(table.device)].float()
    w = params["blocks"]["attn"]["wq"][0].float()
    key = ctr_rng.prng_key(7).to(mesh.device)
    rules = sc_shard_rules(mesh)
    out, rec = {}, {}
    for backend, nbit, kernel in (
        ("pallas_fused", 1024, "sc_fused"),
        ("pallas_bitexact", 1024, "sc_mul_popcount"),
        ("pallas_moment", FM_MOMENT_NBIT, "sc_mac_fused"),
    ):
        cfg = sc.ScConfig(backend=backend, nbit=nbit)
        cuda_lib.reset_launches()
        out[backend], ms = _synced_ms(lambda: sc.sc_dot_sharded(
            key, x, w, cfg, mesh=mesh, rules=rules))
        counts = dict(cuda_lib.launches)
        if counts.get(kernel, 0) <= 0:
            raise AssertionError(f"serve_fm: {backend} did not launch "
                                 f"{kernel}: {counts}")
        rec[backend] = dict(ms=ms, launches=counts)
    rec["shape"] = [x.shape[0], x.shape[1], w.shape[1]]
    rec["fused_equals_bitexact"] = bool(
        torch.equal(out["pallas_fused"], out["pallas_bitexact"]))
    rec["moment_max_abs_err"] = float(
        (out["pallas_moment"] - x @ w).abs().max())
    return rec


def fm_smoke(device: str) -> dict:
    """Phase FM, check 3 (on every rank): the tiny configuration on the
    2 x 2 mesh, its ranks on ``device``."""
    from repro_torch.launch.mesh import make_local_mesh

    cfg = _tiny_cfg()
    mesh = make_local_mesh(FM_MODEL_PARALLEL, device=device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab, 10).tolist()
               for _ in range(FM_SLOTS)]
    eng = _fm_serve(_qwen_params(cfg, mesh.device), cfg, mesh, prompts,
                    FM_SLOTS, 32, FM_NEW)
    return {str(r.rid): r.generated for r in eng.run_until_drained()}


# Phase FM-s: decode on a rank's block of the cache's sequence.  (a)
# exact float32, FM_S_ROWS rows a data rank, a cache of FM_S_LEN
# positions (two blocks of 16,384 over model), fills in FM_S_FILLS and
# FM_S_STEPS teacher-forced steps across the block boundary; (b)
# pallas_bitexact bf16 (kernel 1), FM_S_B_ROWS rows a data rank, a cache
# of FM_S_B_LEN, FM_S_B_STEPS steps across its boundary.
FM_S_ROWS, FM_S_LEN, FM_S_FILLS, FM_S_STEPS = 64, 32768, (16000, 16380), 8
FM_S_B_ROWS, FM_S_B_LEN, FM_S_B_FILLS, FM_S_B_STEPS = 2, 64, (30, 32), 2
FM_S_TOL = 1e-5  # (a): of the unsharded step's max |logit|
# (b): of its max |logit|.  The layout changes the float order of the
# attention's softmax sums, so a bf16 attention output can move by an
# ulp, and with the 10-bit operand grid on such an ulp can move an SC
# operand by a grid step, whose bits then differ: logits may part a
# little.
FM_S_B_TOL = 2e-2


def _fm_s_cache(cfg, mesh, rows: int, max_len: int, blocks, seed: int):
    """A decode cache of random K/V for this rank's ``rows`` rows (the
    same on the ranks of a data coordinate), made block by block of the
    sequence over ``model`` so that a rank can make its block alone:
    ``blocks`` the block indices to make, concatenated in order."""
    from repro_torch.models import lm

    span = mesh.shape["model"]
    shape = (cfg.n_layers, rows, max_len // span, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    out = {}
    for i, name in enumerate(lm.init_cache(cfg, 0, 0, device="meta")):
        parts = []
        for j in blocks:
            gen = torch.Generator(mesh.device).manual_seed(
                seed + 1000 * mesh.coords["data"] + 10 * j + i)
            parts.append(torch.randn(shape, generator=gen,
                                     device=mesh.device).to(cfg.act_dtype))
        out[name] = torch.cat(parts, 2)
        del parts
    return out


def _fm_s_inputs(cfg, mesh, rows: int, fills, steps: int, seed: int):
    """This rank's rows of the global fills and teacher-forced tokens."""
    rng = np.random.default_rng(seed)
    batch = rows * mesh.shape["data"]
    lengths = rng.integers(fills[0], fills[1], batch)
    tokens = rng.integers(0, cfg.vocab, (steps, batch))
    d = mesh.coords["data"]
    mine = slice(d * rows, (d + 1) * rows)
    return (torch.from_numpy(lengths[mine]).to(mesh.device),
            torch.from_numpy(tokens[:, mine]).to(mesh.device), batch)


def _fm_s_decode(params, cfg, cache, lengths, tokens, cst) -> dict:
    """``len(tokens)`` decode steps from ``cache`` under ``cst`` (step i
    under ``fold_in(prng_key(5), i)`` on a stochastic backend): each
    step's logits (on the host) and synced ms, the combine's gathers
    (tracer span ``seq.combine``: count and bytes a step), the peak
    memory from the start and kernel 1's launches."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import lm
    from repro_torch.obs.trace import Tracer, install_tracer, uninstall_tracer
    from repro_torch.sc import ctr_rng

    root = None if cfg.sc_backend == "exact" else ctr_rng.prng_key(5).to(
        lengths.device)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    tracer = install_tracer(Tracer())
    rec = {"logits": [], "ms": [], "combine": []}
    try:
        with torch.no_grad():
            for i, t in enumerate(tokens):
                key = None if root is None else ctr_rng.fold_in(root, i)
                (logits, cache), ms = _synced_ms(lambda: lm.decode_step(
                    params, cache, t, lengths, cfg, rng=key, constrain=cst))
                rec["logits"].append(logits.float().cpu())
                rec["ms"].append(ms)
                sp = _span_totals(tracer, ("seq.combine",))["seq.combine"]
                rec["combine"].append({"count": sp["count"],
                                       "bytes": sp["bytes"]})
                lengths = lengths + 1
    finally:
        uninstall_tracer(tracer)
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    rec["launches"] = dict(cuda_lib.launches)
    return rec


def _logit_gap(got: list, want: list) -> tuple:
    """(max |got - want| over the steps, max |want|, greedy tokens equal,
    got's bits' checksum)."""
    gap = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    same = all(torch.equal(g.argmax(-1), w.argmax(-1))
               for g, w in zip(got, want))
    bits = sum(int(g.contiguous().view(torch.int32).to(torch.int64).sum())
               for g in got)
    return gap, scale, same, bits


def fm_seq(mesh, layers: int) -> dict:
    """Phase FM-s (on every rank): qwen2-0.5b at full width, depth
    ``layers``, decode on the whole cache and on the rank's block of its
    sequence over ``model`` (``make_constrain(mesh).lay_out_cache``),
    from the same starting cache: (a) ``exact`` float32 and (b)
    ``pallas_bitexact`` bf16 (kernel 1, every SC call's K split over
    the model pair under ``local_rows`` rules).  See the module doc."""
    from repro_torch import sc
    from repro_torch.configs import get_config
    from repro_torch.sharding import sc_shard_rules, seq
    from repro_torch.train.step import make_constrain

    out = {}
    for tag, backend, dtype, rows, max_len, fills, steps in (
            ("a", "exact", torch.float32, FM_S_ROWS, FM_S_LEN, FM_S_FILLS,
             FM_S_STEPS),
            ("b", "pallas_bitexact", torch.bfloat16, FM_S_B_ROWS,
             FM_S_B_LEN, FM_S_B_FILLS, FM_S_B_STEPS)):
        cfg = get_config("qwen2-0.5b").replace(
            n_layers=layers, sc_backend=backend, sc_nbit=1024,
            param_dtype=dtype, act_dtype=dtype)
        params = _qwen_params(cfg, mesh.device)
        lengths, tokens, batch = _fm_s_inputs(cfg, mesh, rows, fills, steps,
                                              seed=7)
        whole_cst = make_constrain(mesh, seq_parallel=False,
                                   tensor_parallel=False)
        cst = make_constrain(mesh, tensor_parallel=False)
        blk = cst.lay_out_cache(batch, max_len)
        whole_cst.batch = cst.batch = rows
        scope = contextlib.nullcontext()
        if backend != "exact":
            scope = sc.use_mesh(mesh, dataclasses.replace(
                sc_shard_rules(mesh), local_rows=True))
        runs = {}
        with scope:
            for name, c, blocks in (
                    ("whole", whole_cst, range(mesh.shape["model"])),
                    ("block", cst, (blk.index,))):
                torch.cuda.empty_cache()
                cache = _fm_s_cache(cfg, mesh, rows, max_len, blocks,
                                    seed=11)
                cache_bytes = sum(t.numel() * t.element_size()
                                  for t in cache.values())
                runs[name] = _fm_s_decode(params, cfg, cache, lengths,
                                          tokens, c)
                runs[name]["cache_bytes"] = cache_bytes
                del cache
        gap, scale, same, bits = _logit_gap(runs["block"]["logits"],
                                            runs["whole"]["logits"])
        plan = seq.combine_plan(cfg, rows, blk)["all-gather"]
        out[tag] = dict(
            backend=backend, dtype=str(dtype).split(".")[-1], rows=rows,
            max_len=max_len, block=[blk.start, blk.stop], steps=steps,
            cache_bytes={k: r["cache_bytes"] for k, r in runs.items()},
            max_memory_allocated={k: r["max_memory_allocated"]
                                  for k, r in runs.items()},
            step_ms={k: r["ms"] for k, r in runs.items()},
            launches={k: r["launches"] for k, r in runs.items()},
            combine=runs["block"]["combine"],
            combine_whole=runs["whole"]["combine"],
            combine_plan={"count": plan["count"], "bytes": plan["bytes"]},
            max_abs_err=gap, max_abs_logit=scale, tokens_equal=same,
            logits_checksum=bits)
        del params, runs
        torch.cuda.empty_cache()
    return out


# Phase FM-t: decode under the in-layer layout on FM's data 2 x model 2
# mesh, against the same mesh with ``tensor_parallel=False``.  (a) FM-s
# (b)'s shape (``pallas_bitexact`` bf16, kernel 1, FM_S_B_ROWS rows a
# data rank, FM_S_B_STEPS steps) on a whole cache: the attention on the
# rank's heads block, the MLP hidden's block; logits bit-equal or within
# FM_T_TOL of max |logit|, tokens equal, kernel 1's launches the whole
# layout's.  (b) mamba2-370m at full width, FM_T_SSM_LAYERS deep
# (phase S's depth), ``exact`` float32, FM_T_ROWS rows a data rank: a
# prompt of FM_T_PROMPT tokens, then FM_T_STEPS teacher-forced decode
# steps on the rank's block of the SSM state (``lay_out_cache``: 16 of
# 32 heads, ``conv_x`` 1,024 of 2,048): logits within FM_T_SSM_TOL of
# max |logit|, tokens equal, the state half the whole's bytes.
FM_T_TOL = 1e-6
FM_T_SSM_LAYERS, FM_T_ROWS, FM_T_PROMPT, FM_T_STEPS = 4, 2, 16, 8
FM_T_SSM_TOL = 1e-5


def _fm_t_bitexact(mesh, layers: int) -> dict:
    from repro_torch import sc
    from repro_torch.configs import get_config
    from repro_torch.sharding import sc_shard_rules
    from repro_torch.train.step import make_constrain

    cfg = get_config("qwen2-0.5b").replace(
        n_layers=layers, sc_backend="pallas_bitexact", sc_nbit=1024,
        param_dtype=torch.bfloat16, act_dtype=torch.bfloat16)
    params = _qwen_params(cfg, mesh.device)
    rows, max_len = FM_S_B_ROWS, FM_S_B_LEN
    lengths, tokens, _ = _fm_s_inputs(cfg, mesh, rows, FM_S_B_FILLS,
                                      FM_S_B_STEPS, seed=7)
    runs = {}
    scope = sc.use_mesh(mesh, dataclasses.replace(sc_shard_rules(mesh),
                                                  local_rows=True))
    with scope:
        for name, on in (("whole", False), ("tp", True)):
            cst = make_constrain(mesh, tensor_parallel=on)
            cst.batch = rows
            cache = _fm_s_cache(cfg, mesh, rows, max_len,
                                range(mesh.shape["model"]), seed=11)
            runs[name] = _fm_s_decode(params, cfg, cache, lengths, tokens,
                                      cst)
            del cache
    gap, scale, same, bits = _logit_gap(runs["tp"]["logits"],
                                        runs["whole"]["logits"])
    bit_equal = all(torch.equal(a, b) for a, b in
                    zip(runs["tp"]["logits"], runs["whole"]["logits"]))
    del params
    torch.cuda.empty_cache()
    return dict(backend="pallas_bitexact", dtype="bfloat16", rows=rows,
                max_len=max_len, steps=FM_S_B_STEPS,
                launches={k: r["launches"] for k, r in runs.items()},
                step_ms={k: r["ms"] for k, r in runs.items()},
                max_memory_allocated={k: r["max_memory_allocated"]
                                      for k, r in runs.items()},
                max_abs_err=gap, max_abs_logit=scale, tokens_equal=same,
                bit_equal=bit_equal, logits_checksum=bits)


def _fm_t_ssm(mesh) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import lm
    from repro_torch.train.step import make_constrain

    cfg = get_config("mamba2-370m").replace(
        n_layers=FM_T_SSM_LAYERS, sc_backend="exact",
        param_dtype=torch.float32, act_dtype=torch.float32)
    params = _qwen_params(cfg, mesh.device)
    rng = np.random.default_rng(13)
    batch = FM_T_ROWS * mesh.shape["data"]
    d = mesh.coords["data"]
    mine = slice(d * FM_T_ROWS, (d + 1) * FM_T_ROWS)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (
        batch, FM_T_PROMPT))[mine]).to(mesh.device)
    forced = torch.from_numpy(rng.integers(0, cfg.vocab, (
        FM_T_STEPS, batch))[:, mine]).to(mesh.device)
    runs = {}
    for name, on in (("whole", False), ("tp", True)):
        cst = make_constrain(mesh, tensor_parallel=on)
        cst.lay_out_cache(batch, FM_T_PROMPT + FM_T_STEPS)
        cst.batch = FM_T_ROWS
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launches()
        logits, ms = [], []
        with torch.no_grad():
            (lg, cache, lengths), t = _synced_ms(lambda: lm.prefill(
                params, prompt, cfg, FM_T_PROMPT + FM_T_STEPS,
                constrain=cst))
            logits.append(lg.cpu())
            ms.append(t)
            state_bytes = {k: v.numel() * v.element_size()
                           for k, v in cache["ssm"].items()}
            for tok in forced:
                (lg, cache), t = _synced_ms(lambda: lm.decode_step(
                    params, cache, tok, lengths, cfg, constrain=cst))
                logits.append(lg.cpu())
                ms.append(t)
                lengths = lengths + 1
        runs[name] = dict(logits=logits, ms=ms, state_bytes=state_bytes,
                          launches=dict(cuda_lib.launches),
                          max_memory_allocated=torch.cuda
                          .max_memory_allocated())
        del cache
    gap, scale, same, bits = _logit_gap(runs["tp"]["logits"],
                                        runs["whole"]["logits"])
    del params
    torch.cuda.empty_cache()
    return dict(backend="exact", dtype="float32", rows=FM_T_ROWS,
                layers=FM_T_SSM_LAYERS, prompt=FM_T_PROMPT,
                steps=FM_T_STEPS,
                state_bytes={k: r["state_bytes"] for k, r in runs.items()},
                launches={k: r["launches"] for k, r in runs.items()},
                step_ms={k: r["ms"] for k, r in runs.items()},
                max_memory_allocated={k: r["max_memory_allocated"]
                                      for k, r in runs.items()},
                max_abs_err=gap, max_abs_logit=scale, tokens_equal=same,
                logits_checksum=bits)


def fm_tp(mesh, layers: int) -> dict:
    """Phase FM-t (on every rank): (a) and (b) above."""
    return {"a": _fm_t_bitexact(mesh, layers), "b": _fm_t_ssm(mesh)}


# Phase FM-e: the MoE FFN's expert-parallel layout (``sharding/ep.py``)
# in prefill and decode, at moonshot-v1-16b-a3b's full width (64 experts,
# top-6), FM_E_LAYERS of 48 layers.  (a) ``exact`` float32 on FM's data 2
# x model 2 (32 experts a rank): FM_E_ROWS rows a data rank, a prompt of
# FM_E_PROMPT tokens and FM_E_STEPS teacher-forced decode steps against
# the same mesh with ``tensor_parallel=False``: logits within FM_E_TOL of
# max |logit|, tokens equal, no kernel.  (b) ``pallas_bitexact`` bf16 on
# data 1 x model 4 (16 experts a rank): one row, a FM_E_B_PROMPT-token
# prefill with every one-key call whole on each rank (no SC scope), so
# the same prefill with the experts whole runs once, on rank 0 alone,
# without a mesh: kernel 1's launches a rank ``moe_kernel1_plan``'s at 16
# experts, the whole run's at 64, and every rank's logits bit-equal to
# that run's.
FM_E_LAYERS, FM_E_ROWS, FM_E_PROMPT, FM_E_STEPS = 1, 2, 16, 4
FM_E_TOL = 1e-5
FM_E_B_PROMPT = 4


def _fm_e_cfg(**kw):
    from repro_torch.configs import get_config

    return get_config("moonshot-v1-16b-a3b").replace(
        n_layers=FM_E_LAYERS, **kw)


def _fm_e_exact(mesh) -> dict:
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import lm
    from repro_torch.sharding import ep
    from repro_torch.train.step import make_constrain

    cfg = _fm_e_cfg(sc_backend="exact", param_dtype=torch.float32,
                    act_dtype=torch.float32)
    params = _moe_params(cfg, mesh.device, torch.float32)
    rng = np.random.default_rng(17)
    batch = FM_E_ROWS * mesh.shape["data"]
    d = mesh.coords["data"]
    mine = slice(d * FM_E_ROWS, (d + 1) * FM_E_ROWS)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (
        batch, FM_E_PROMPT))[mine]).to(mesh.device)
    forced = torch.from_numpy(rng.integers(0, cfg.vocab, (
        FM_E_STEPS, batch))[:, mine]).to(mesh.device)
    max_len = FM_E_PROMPT + FM_E_STEPS
    runs = {}
    for name, on in (("whole", False), ("ep", True)):
        cst = make_constrain(mesh, tensor_parallel=on)
        cst.batch = FM_E_ROWS
        blk = ep.expert_block(cst, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launches()
        logits, ms = [], []
        with torch.no_grad():
            (lg, cache, lengths), t = _synced_ms(lambda: lm.prefill(
                params, prompt, cfg, max_len, constrain=cst))
            logits.append(lg.cpu())
            ms.append(t)
            for tok in forced:
                (lg, cache), t = _synced_ms(lambda: lm.decode_step(
                    params, cache, tok, lengths, cfg, constrain=cst))
                logits.append(lg.cpu())
                ms.append(t)
                lengths = lengths + 1
        runs[name] = dict(
            logits=logits, ms=ms, launches=dict(cuda_lib.launches),
            experts=cfg.n_experts if blk is None else blk.size,
            max_memory_allocated=torch.cuda.max_memory_allocated())
        del cache
    gap, scale, same, bits = _logit_gap(runs["ep"]["logits"],
                                        runs["whole"]["logits"])
    del params
    torch.cuda.empty_cache()
    return dict(backend="exact", dtype="float32", rows=FM_E_ROWS,
                layers=FM_E_LAYERS, prompt=FM_E_PROMPT, steps=FM_E_STEPS,
                experts={k: r["experts"] for k, r in runs.items()},
                launches={k: r["launches"] for k, r in runs.items()},
                step_ms={k: r["ms"] for k, r in runs.items()},
                max_memory_allocated={k: r["max_memory_allocated"]
                                      for k, r in runs.items()},
                max_abs_err=gap, max_abs_logit=scale, tokens_equal=same,
                logits_checksum=bits)


def _fm_e_bitexact() -> dict:
    """FM-e (b) on every rank of a data 1 x model 4 mesh; rank 0 also
    runs the experts-whole prefill alone (the others wait)."""
    import torch.distributed as dist

    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.models import lm
    from repro_torch.sc import ctr_rng
    from repro_torch.sharding import ep
    from repro_torch.train.step import make_constrain

    mesh = DeviceMesh((1, 4), ("data", "model"))
    cfg = _fm_e_cfg(sc_backend="pallas_bitexact", sc_nbit=1024,
                    param_dtype=torch.bfloat16, act_dtype=torch.bfloat16)
    params = _moe_params(cfg, mesh.device, torch.bfloat16)
    prompt = torch.from_numpy(np.random.default_rng(19).integers(
        0, cfg.vocab, (1, FM_E_B_PROMPT))).to(mesh.device)
    key = ctr_rng.prng_key(23).to(mesh.device)  # a serving engine's
    cst = make_constrain(mesh)
    cst.batch = 1
    blk = ep.expert_block(cst, cfg)
    rec = {}
    dist.barrier()
    cuda_lib.reset_launches()
    with torch.no_grad():
        (lg, _, _), ms = _synced_ms(lambda: lm.prefill(
            params, prompt, cfg, FM_E_B_PROMPT, rng=key, constrain=cst))
    rec["ep"] = dict(launches=dict(cuda_lib.launches), ms=ms,
                     experts=blk.size, logits=lg.float().cpu())
    dist.barrier()
    if mesh.rank == 0:
        cuda_lib.reset_launches()
        with torch.no_grad():
            (lw, _, _), ms = _synced_ms(lambda: lm.prefill(
                params, prompt, cfg, FM_E_B_PROMPT, rng=key))
        rec["whole"] = dict(launches=dict(cuda_lib.launches), ms=ms,
                            experts=cfg.n_experts, logits=lw.float().cpu())
    dist.barrier()
    del params
    torch.cuda.empty_cache()
    out = dict(backend="pallas_bitexact", dtype="bfloat16", rows=1,
               layers=FM_E_LAYERS, prompt=FM_E_B_PROMPT, mesh=mesh.shape,
               coords=mesh.coords,
               plan=moe_kernel1_plan(cfg, 1, experts=blk.size)["launches"],
               whole_plan=moe_kernel1_plan(cfg, 1)["launches"])
    for name, r in rec.items():
        logits = r.pop("logits")
        r["logits_checksum"] = int(logits.view(torch.int32)
                                   .to(torch.int64).sum())
        out[name] = r
    return out


def fm_ep(mesh) -> dict:
    """Phase FM-e (on every rank): (a) and (b) above."""
    return {"a": _fm_e_exact(mesh), "b": _fm_e_bitexact()}


def fm_rank(outdir: str, layers: int) -> int:
    """One rank of phase FM, started by :func:`mesh_phase` under
    ``torchrun``: qwen2-0.5b at full width, depth ``layers``, bf16,
    ``pallas_bitexact`` at nbit 1024, on the data 2 x model 2 mesh with
    FM_SLOTS slots; then checks 4 and 3.  Writes
    ``fm_rank<r>.json`` in ``outdir``."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.mesh import make_local_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    with open(os.path.join(outdir, "fm_in.json")) as f:
        prompts = json.load(f)["prompts"]
    mesh = make_local_mesh(FM_MODEL_PARALLEL)
    cfg = get_config("qwen2-0.5b").replace(
        n_layers=layers, sc_backend="pallas_bitexact", sc_nbit=1024)
    params = _qwen_params(cfg, mesh.device)
    rec = dict(rank=mesh.rank, device=str(mesh.device), backend=mesh.backend,
               mesh=mesh.shape, coords=mesh.coords)
    eng = _fm_serve(params, cfg, mesh, prompts, FM_SLOTS, 64, FM_NEW)
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    with _CallTimer("prefill", "decode_step") as timer, \
            _GatherTimer() as gather:
        fin, ms = _synced_ms(eng.run_until_drained)
    rec.update(
        launches=dict(cuda_lib.launches),
        tokens={str(r.rid): r.generated for r in fin},
        wall_ms=ms,
        prefill_ms=timer.ms["prefill"],
        decode_ms=timer.ms["decode_step"],
        collective_ms=sum(gather.ms),
        collectives=len(gather.ms),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
    )
    rec["kernels"] = fm_sharded_kernels(params, mesh, prompts)
    rec["smoke"] = {dev: fm_smoke(dev) for dev in ("cuda", "cpu")}
    del eng, params
    torch.cuda.empty_cache()
    dist.barrier()
    rec["seq"] = fm_seq(mesh, layers)
    rec["tp"] = fm_tp(mesh, layers)
    rec["ep"] = fm_ep(mesh)
    with open(os.path.join(outdir, f"fm_rank{mesh.rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.barrier()
    return 0


def mesh_rank(outdir: str, layers: int) -> int:
    """One rank of phases FM and TM, started by :func:`mesh_ranks` under
    ``torchrun``: FM's serving (:func:`fm_rank`), then TM's training
    (:func:`tm_rank`), in one launch of the ranks."""
    import torch.distributed as dist

    fm_rank(outdir, layers)
    tm_rank(outdir, layers)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def mesh_ranks(prompts, layers: int) -> tuple:
    """Start the FM_RANKS ranks of phases FM and TM once (FM's requests:
    phase A's prompts twice) and read what each wrote.  Returns (FM's
    rank records, TM's rank records, the launch's seconds)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as outdir:
        with open(os.path.join(outdir, "fm_in.json"), "w") as f:
            json.dump({"prompts": prompts + prompts}, f)
        seconds = _run_ranks(outdir, layers)
        ranks = {}
        for tag in ("fm", "tm"):
            ranks[tag] = []
            for r in range(FM_RANKS):
                with open(os.path.join(outdir, f"{tag}_rank{r}.json")) as f:
                    ranks[tag].append(json.load(f))
    emit("mesh_ranks", ranks=FM_RANKS, seconds=seconds)
    return ranks["fm"], ranks["tm"], seconds


def mesh_world_one(params, cfg, prompts, tokens_f) -> dict:
    """Phase FM, check 2: ``--mesh`` in a world of one (no ``torchrun``)
    is the trivial 1 x 1 mesh, where every sharded call is ``sc_dot``:
    phase F's settings (2 slots, its prompts) give phase F's tokens."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(1)
    cuda_lib.reset_launches()
    eng = _fm_serve(params, cfg, mesh, prompts, 2, 64, FM_NEW)
    toks = {r.rid: list(r.generated) for r in eng.run_until_drained()}
    counts = dict(cuda_lib.launches)
    emit("serve_fm_world_one", mesh=mesh.shape, tokens=toks,
         launches=counts)
    if toks != tokens_f:
        raise AssertionError(f"serve_fm: the trivial mesh's tokens {toks} "
                             f"are not phase F's {tokens_f}")
    return counts


def _run_ranks(outdir: str, layers: int) -> float:
    """Start FM_RANKS ranks of this script under ``torchrun`` (each
    entering ``--mesh-rank``) and wait for them (seconds); on failure or
    timeout, end them all and raise with the end of their output."""
    what, timeout = "serve_fm / train_tm", MESH_TIMEOUT
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={FM_RANKS}", os.path.abspath(__file__),
           "--mesh-rank", outdir, "--layers", str(layers)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, _ = proc.communicate()
        raise AssertionError(f"{what}: ranks ran past {timeout} s:\n"
                             f"{out[-6000:]}") from None
    if proc.returncode != 0:
        raise AssertionError(f"{what}: ranks failed "
                             f"({proc.returncode}):\n{out[-6000:]}")
    return time.perf_counter() - t0


def mesh_phase(params, cfg, prompts, tokens_f, card: str, ranks: list,
               seconds: float) -> dict:
    """Phase FM: the fixed-slot engine on a data 2 x model 2 mesh of 4
    ranks sharing the card over gloo (``ranks``: what each wrote in
    :func:`mesh_ranks`' launch); see the module doc."""
    counts_one = mesh_world_one(params, cfg, prompts, tokens_f)
    fm_prompts = prompts + prompts  # phase A's two prompts, twice
    plan = mesh_kernel1_plan(cfg, len(fm_prompts), FM_NEW)
    for rec in ranks:
        emit("serve_fm_rank", **{k: rec[k] for k in (
            "rank", "device", "backend", "coords", "prefill_ms",
            "decode_ms", "wall_ms", "collective_ms", "collectives",
            "max_memory_allocated", "launches", "kernels")})
    first = ranks[0]
    summary = dict(
        mesh=first["mesh"],
        backend=first["backend"],
        ranks=FM_RANKS,
        card=card,
        seconds=seconds,
        tokens=first["tokens"],
        kernel1_plan=plan,
        collective_ms=[r["collective_ms"] for r in ranks],
        smoke=first["smoke"],
        world_one_launches=counts_one,
    )
    emit("serve_fm", **summary)
    for ok, what in (
        (all(r["tokens"] == first["tokens"] for r in ranks),
         "the ranks' tokens differ"),
        (all(len(t) == FM_NEW for t in first["tokens"].values())
         and len(first["tokens"]) == len(fm_prompts),
         "a request did not get its tokens"),
        (all(0 <= t < cfg.vocab for ts in first["tokens"].values()
             for t in ts), "token outside the vocabulary"),
        (all(r["smoke"]["cuda"] == r["smoke"]["cpu"] == first["smoke"]["cpu"]
             for r in ranks), "the SMOKE tokens differ between card and CPU"),
        (all(r["kernels"]["fused_equals_bitexact"] for r in ranks),
         "sharded pallas_fused differs from pallas_bitexact"),
        (all(r["kernels"]["moment_max_abs_err"] < FM_MOMENT_BOUND
             for r in ranks), "sharded pallas_moment past its bound"),
        (all(r["launches"].get("sc_fused", 0) == plan for r in ranks),
         f"kernel-1 launches {[r['launches'] for r in ranks]}, {plan} "
         "planned a rank"),
        (not any(r["launches"].get(k, 0) for r in ranks
                 for k in NOT_KERNEL_1), "a kernel other than sc_fused "
         "launched"),
    ):
        if not ok:
            raise AssertionError(f"serve_fm: {what}")
    seq_rec = fm_seq_phase(ranks, card)
    tp_rec = fm_tp_phase(ranks, card)
    ep_rec = fm_ep_phase(ranks, card)
    return dict(summary, launches=first["launches"], ranks_detail=ranks,
                counts_one=counts_one, seq=seq_rec, tp=tp_rec, ep=ep_rec)


def fm_tp_phase(ranks: list, card: str) -> dict:
    """Phase FM-t's checks (``ranks``: what each FM rank wrote, its
    ``tp`` record): (a) logits bit-equal to the whole layout's or within
    FM_T_TOL of max |logit|, tokens equal, kernel 1's launches the whole
    layout's and no other kernel; (b) logits within FM_T_SSM_TOL, tokens
    equal, the state half the whole's bytes (``conv_x`` too), no kernel;
    the ranks of a model group hold the same logits."""
    out = {}
    for tag, tol in (("a", FM_T_TOL), ("b", FM_T_SSM_TOL)):
        recs = []
        for r in ranks:
            rec = dict(r["tp"][tag], rank=r["rank"], coords=r["coords"])
            rec["median_step_ms"] = {k: float(np.median(v))
                                     for k, v in rec["step_ms"].items()}
            emit("serve_fm_tp_rank", case=tag, **{
                k: v for k, v in rec.items() if k != "step_ms"})
            launches = rec["launches"]
            checks = [
                (rec["max_abs_err"] <= tol * rec["max_abs_logit"],
                 f"logits {rec['max_abs_err']} from the whole layout's "
                 f"(max |logit| {rec['max_abs_logit']}, tolerance {tol})"),
                (rec["tokens_equal"], "greedy tokens differ from the whole "
                 "layout's"),
            ]
            if tag == "a":
                checks.append((
                    launches["tp"] == launches["whole"]
                    and launches["tp"].get("sc_fused", 0) > 0
                    and not any(launches["tp"].get(k, 0)
                                for k in NOT_KERNEL_1),
                    f"kernel launches {launches}: kernel 1's must equal the "
                    "whole layout's"))
            else:
                sb = rec["state_bytes"]
                checks += [
                    (all(2 * sb["tp"][k] == sb["whole"][k]
                         for k in ("state", "conv_x")),
                     f"state bytes {sb}: the block must hold half"),
                    (not any(launches["tp"].values()),
                     f"a kernel launched on exact: {launches}"),
                ]
            for ok, what in checks:
                if not ok:
                    raise AssertionError(f"serve_fm_tp ({tag}): rank "
                                         f"{rec['rank']}: {what}")
            recs.append(rec)
        groups: dict = {}
        for rec in recs:
            groups.setdefault(rec["coords"]["data"], set()).add(
                rec["logits_checksum"])
        if any(len(v) != 1 for v in groups.values()):
            raise AssertionError(f"serve_fm_tp ({tag}): the ranks of a "
                                 "model group hold different logits")
        first = recs[0]
        out[tag] = dict(
            card=card, backend=first["backend"], dtype=first["dtype"],
            rows=first["rows"], steps=first["steps"],
            max_abs_err=max(r["max_abs_err"] for r in recs),
            max_abs_logit=max(r["max_abs_logit"] for r in recs), tol=tol,
            tokens_equal=all(r["tokens_equal"] for r in recs),
            median_step_ms=[r["median_step_ms"] for r in recs],
            max_memory_allocated=[r["max_memory_allocated"] for r in recs],
            launches=first["launches"])
        if tag == "a":
            out[tag]["bit_equal"] = all(r["bit_equal"] for r in recs)
        else:
            out[tag]["state_bytes"] = first["state_bytes"]
    emit("serve_fm_tp", **out)
    return out


def fm_ep_phase(ranks: list, card: str) -> dict:
    """Phase FM-e's checks (``ranks``: what each FM rank wrote, its
    ``ep`` record): (a) logits within FM_E_TOL of max |logit| of the
    layout off's, tokens equal, a rank's half of the experts, no kernel,
    the ranks of a model group the same logits; (b) kernel 1's launches
    a rank ``moe_kernel1_plan``'s at the rank's 16 experts and no other
    kernel, the experts-whole run's (rank 0) at 64, and every rank's
    logits bits that run's."""
    a_recs = []
    for r in ranks:
        rec = dict(r["ep"]["a"], rank=r["rank"], coords=r["coords"])
        rec["median_step_ms"] = {k: float(np.median(v))
                                 for k, v in rec["step_ms"].items()}
        emit("serve_fm_e_rank", case="a", **{
            k: v for k, v in rec.items() if k != "step_ms"})
        for ok, what in (
            (rec["max_abs_err"] <= FM_E_TOL * rec["max_abs_logit"],
             f"logits {rec['max_abs_err']} from the layout off's (max "
             f"|logit| {rec['max_abs_logit']}, tolerance {FM_E_TOL})"),
            (rec["tokens_equal"], "greedy tokens differ from the layout "
             "off's"),
            (rec["experts"]["ep"] * FM_MODEL_PARALLEL
             == rec["experts"]["whole"], f"experts a rank "
             f"{rec['experts']}"),
            (not any(v for run in rec["launches"].values()
                     for v in run.values()),
             f"a kernel launched on exact: {rec['launches']}"),
        ):
            if not ok:
                raise AssertionError(f"serve_fm_e (a): rank {rec['rank']}: "
                                     f"{what}")
        a_recs.append(rec)
    groups: dict = {}
    for rec in a_recs:
        groups.setdefault(rec["coords"]["data"], set()).add(
            rec["logits_checksum"])
    if any(len(v) != 1 for v in groups.values()):
        raise AssertionError("serve_fm_e (a): the ranks of a model group "
                             "hold different logits")
    b_recs = [dict(r["ep"]["b"], rank=r["rank"]) for r in ranks]
    whole = b_recs[0]["whole"]
    for rec in b_recs:
        emit("serve_fm_e_rank", case="b", **rec)
        run = rec["ep"]
        for ok, what in (
            (run["launches"].get("sc_fused", 0) == rec["plan"]
             and not any(run["launches"].get(k, 0) for k in NOT_KERNEL_1),
             f"kernel launches {run['launches']}, {rec['plan']} kernel-1 "
             "launches planned"),
            (run["logits_checksum"] == whole["logits_checksum"],
             "logits differ from the experts-whole prefill's"),
        ):
            if not ok:
                raise AssertionError(f"serve_fm_e (b): rank {rec['rank']}: "
                                     f"{what}")
    if whole["launches"].get("sc_fused", 0) != b_recs[0]["whole_plan"]:
        raise AssertionError(f"serve_fm_e (b): the experts-whole prefill's "
                             f"launches {whole['launches']}, "
                             f"{b_recs[0]['whole_plan']} planned")
    first = a_recs[0]
    out = dict(
        card=card,
        a=dict(backend=first["backend"], dtype=first["dtype"],
               rows=first["rows"], layers=first["layers"],
               prompt=first["prompt"], steps=first["steps"],
               experts=first["experts"],
               max_abs_err=max(r["max_abs_err"] for r in a_recs),
               max_abs_logit=max(r["max_abs_logit"] for r in a_recs),
               tol=FM_E_TOL,
               tokens_equal=all(r["tokens_equal"] for r in a_recs),
               median_step_ms=[r["median_step_ms"] for r in a_recs],
               max_memory_allocated=[r["max_memory_allocated"]
                                     for r in a_recs]),
        b=dict(mesh=b_recs[0]["mesh"], prompt=b_recs[0]["prompt"],
               plan=b_recs[0]["plan"], whole_plan=b_recs[0]["whole_plan"],
               launches=[r["ep"]["launches"] for r in b_recs],
               ms=[r["ep"]["ms"] for r in b_recs],
               whole_launches=whole["launches"], whole_ms=whole["ms"],
               bit_equal=True))
    emit("serve_fm_e", **out)
    return out


def fm_seq_phase(ranks: list, card: str) -> dict:
    """Phase FM-s's checks (``ranks``: what each FM rank wrote, its
    ``seq`` record): per case and rank the cache bytes (the block half
    the whole), the peak against the unsharded step's, the logits
    against the unsharded step's (FM_S_TOL in (a), FM_S_B_TOL in (b))
    and the greedy tokens (a), the combine's gathers a step against
    ``sharding.seq.combine_plan``, kernel 1's launches (none in (a), the
    unsharded step's in (b)), and equal logits bits on the ranks of a
    model group."""
    out = {}
    for tag, tol in (("a", FM_S_TOL), ("b", FM_S_B_TOL)):
        recs = []
        for r in ranks:
            rec = dict(r["seq"][tag], rank=r["rank"], coords=r["coords"])
            peaks = rec["max_memory_allocated"]
            rec["peak_drop"] = peaks["whole"] - peaks["block"]
            rec["cache_drop"] = (rec["cache_bytes"]["whole"]
                                 - rec["cache_bytes"]["block"])
            rec["median_step_ms"] = {k: float(np.median(v))
                                     for k, v in rec["step_ms"].items()}
            emit("serve_fm_seq_rank", case=tag, **{
                k: v for k, v in rec.items() if k != "step_ms"})
            launches = rec["launches"]
            for ok, what in (
                (rec["cache_bytes"]["whole"] == 2 * rec["cache_bytes"][
                    "block"], f"cache bytes {rec['cache_bytes']}"),
                (rec["max_abs_err"] <= tol * rec["max_abs_logit"],
                 f"logits {rec['max_abs_err']} from the unsharded step's "
                 f"(max |logit| {rec['max_abs_logit']}, tolerance {tol})"),
                (tag != "a" or rec["tokens_equal"],
                 "greedy tokens differ from the unsharded step's"),
                (tag != "a" or rec["peak_drop"] >= 0.8 * rec["cache_drop"],
                 f"peak {rec['max_memory_allocated']}: a drop of "
                 f"{rec['peak_drop']} for a cache {rec['cache_drop']} "
                 "smaller"),
                (all(c == rec["combine_plan"] for c in rec["combine"])
                 and not any(c["count"] for c in rec["combine_whole"]),
                 f"combine gathers a step {rec['combine']}, planned "
                 f"{rec['combine_plan']}"),
                (tag == "b" or not any(launches["block"].values()),
                 f"a kernel launched on exact: {launches}"),
                (tag == "a" or (launches["block"] == launches["whole"]
                                and launches["block"].get("sc_fused", 0) > 0
                                and not any(launches["block"].get(k, 0)
                                            for k in NOT_KERNEL_1)),
                 f"kernel launches {launches}: kernel 1's must equal the "
                 "unsharded step's"),
            ):
                if not ok:
                    raise AssertionError(f"serve_fm_seq ({tag}): rank "
                                         f"{rec['rank']}: {what}")
            recs.append(rec)
        groups: dict = {}
        for rec in recs:
            groups.setdefault(rec["coords"]["data"], set()).add(
                rec["logits_checksum"])
        if any(len(v) != 1 for v in groups.values()):
            raise AssertionError(f"serve_fm_seq ({tag}): the ranks of a "
                                 f"model group hold different logits")
        first = recs[0]
        out[tag] = dict(
            card=card, backend=first["backend"], dtype=first["dtype"],
            rows=first["rows"], max_len=first["max_len"],
            steps=first["steps"], cache_bytes=first["cache_bytes"],
            max_memory_allocated=[r["max_memory_allocated"] for r in recs],
            peak_drop=[r["peak_drop"] for r in recs],
            median_step_ms=[r["median_step_ms"] for r in recs],
            max_abs_err=max(r["max_abs_err"] for r in recs),
            max_abs_logit=max(r["max_abs_logit"] for r in recs), tol=tol,
            tokens_equal=all(r["tokens_equal"] for r in recs),
            combine_plan=first["combine_plan"],
            launches=first["launches"])
    emit("serve_fm_seq", **out)
    return out


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


def by_class_ms(trace: dict) -> dict:
    """Device ms of a traced step by kernel class: the moment kernel
    (and its split-K pass), GEMMs (the straight-through backward and the
    attention / SSD einsums) and everything else."""
    classes = {"sc_mac": 0.0, "gemm": 0.0, "other": 0.0}
    for name, (ms, _) in trace["kernels"].items():
        low = name.lower()
        if "sc_mac" in low:
            cls = "sc_mac"
        elif "gemm" in low or "cutlass" in low or "matmul" in low:
            cls = "gemm"
        else:
            cls = "other"
        classes[cls] += ms
    return classes


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
    classes = by_class_ms(tr)
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


# ---------------------------------------------------------------------------
# Phases TS, TH and TA: training the SSM, hybrid and audio families
# ---------------------------------------------------------------------------

FAMILY_STEPS = 3  # steps a family phase trains


def kernel5_plan(cfg, batch: int, seq: int, model_parallel: int = 1,
                 experts=None) -> dict:
    """Kernel-5 and split-K launches of one ``pallas_moment`` training
    step, derived from the code before the run.  Each site of
    ``arch.dense_workload`` is one ``sc_dot`` or ``sc_dot_rows`` call,
    one kernel-5 launch whatever its rows (the SSM projections' per-token
    keys take the row-key route); under ``remat="full"`` the backward
    recomputes every backbone layer and shared invocation (twice), the
    frontend's projection runs once (outside the checkpoints), and each
    loss chunk twice (its checkpoint).  A call launches
    ``sc_mac_reduce`` once where ``sc_mac_plan`` splits its K.  On a
    mesh, ``batch`` is a rank's rows and a site's K is its block over
    ``model_parallel`` ranks wherever they divide it.  The MoE FFN
    (``models/moe.py``): per layer one row-key call per expert for wi
    and for wo over ``batch x capacity`` rows, K whole, twice under remat,
    for the ``experts`` a rank runs (the expert-parallel layout's block;
    default all); a shared expert's MLP as the MLP."""
    from repro_torch.arch import dense_workload
    from repro_torch.kernels import sc_mac as km
    from repro_torch.models import lm, moe

    tokens = batch * seq
    c = min(lm.LOSS_SEQ_CHUNK, seq)
    if seq % c:
        c = seq
    remat = 2 if cfg.remat == "full" else 1
    plan = {"sc_mac_fused": 0, "sc_mac_reduce": 0}
    sites = dense_workload(cfg, tokens)
    if cfg.family == "moe" and cfg.shared_expert:
        sites += [s for s in dense_workload(cfg.replace(family="dense"),
                                            tokens)
                  if s.label.startswith("mlp.")]
    for site in sites:
        k = site.k
        if site.label in ("moe.wi", "moe.wo"):
            e = cfg.n_experts if experts is None else experts
            calls = e * cfg.n_layers * remat
            m = batch * moe.capacity(cfg, seq)
        else:
            if k % model_parallel == 0:
                k //= model_parallel
            if site.label == "unembed":
                calls, m = 2 * (seq // c), batch * c
            elif site.label == "frontend.proj":
                calls, m = 1, tokens
            else:
                calls, m = site.count * remat, tokens
        k4 = max(4, -(-k // 4) * 4)
        plan["sc_mac_fused"] += calls
        if km.sc_mac_plan(m, site.n, k4)[0] > 1:
            plan["sc_mac_reduce"] += calls
    return plan


def _family_batch(cfg, batch: int, seq: int, step: int):
    from repro_torch.data import (
        SyntheticLMData,
        make_batch,
        make_embedding_batch,
    )

    data = SyntheticLMData(cfg.vocab, seq, batch)
    if cfg.frontend == "embeddings":
        return make_embedding_batch(data, cfg.d_model, step)
    return make_batch(data, step)


# the SMOKE trainers held card against CPU; the grid-on trajectory is held
# for paper-sc, printed for the families
CROSS_TRAIN_ARCHS = ("paper-sc", "mamba2-370m", "zamba2-7b", "musicgen-large")
GRID_TRAJECTORY_HELD = ("paper-sc",)


@contextlib.contextmanager
def operand_grid_off():
    """Every stochastic matmul with the 10-bit operand grid off on both
    devices: each call's ``ScConfig`` takes ``quantize=False``, so the
    plain versions skip ``quantize_grid`` and kernel 5 takes its general
    route (9 TF32 products a pair, not the grid's 5)."""
    from repro_torch.models import layers

    real = layers._sc_config
    layers._sc_config = lambda cfg: dataclasses.replace(
        real(cfg), quantize=False)
    try:
        yield
    finally:
        layers._sc_config = real


class _GradSpy:
    """Keeps the gradients each train step hands to ``adamw_update``
    while installed."""

    def __init__(self):
        from repro_torch.train import step as step_lib

        self.lib, self.grads = step_lib, []

    def __enter__(self):
        self._real = self.lib.adamw_update
        spy = self

        def update(grads, *args, **kw):
            spy.grads.append(grads)
            return spy._real(grads, *args, **kw)

        self.lib.adamw_update = update
        return self

    def __exit__(self, *exc):
        self.lib.adamw_update = self._real


def _leaf_gap(got, want) -> tuple:
    """(worst leaf, its max |got - want| over its max |want|) of two
    trees of one structure; a leaf that is zero in both has gap 0."""
    from repro_torch.models.params import _leaves

    worst = ("", 0.0)
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
        err = float((a.cpu() - b.cpu()).abs().max())
        scale = float(b.abs().max())
        gap = err / scale if scale else (0.0 if err == 0 else math.inf)
        if gap > worst[1]:
            worst = ("/".join(path), gap)
    return worst


def train_cross_device(arch: str, workdir: str) -> dict:
    """``arch``'s SMOKE trainer (float32, ``pallas_moment``, 2 AdamW steps
    of batch 2 x seq 16) on the card and on the CPU (plain versions).

    With the 10-bit operand grid off on both devices, each step is also
    taken on the CPU from the card's state before it: the loss and the
    grad norm within 1e-4 relative, every gradient leaf within 1e-4 of
    its max |value|, and the card's updated parameters within 1e-6 of
    each leaf's max |value| of AdamW applied on the CPU to the card's own
    gradients (Adam's first step is sign-like, so the update is held on
    the card's gradients: an element near zero whose sign differs between
    the devices moves by 2 lr); and the independent runs' losses within
    1e-4 at both steps.

    With the grid on (the configs' own), the independent runs go through
    ``launch/train.py`` (``--device cuda`` and ``cpu``): their losses are
    held within 1e-4 for ``GRID_TRAJECTORY_HELD`` and printed for the
    rest (``grid_max_rel``): on the grid an ulp between the devices can
    move an operand across a grid step, and Adam's first update carries
    that into the next step's loss."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.params import tree_map
    from repro_torch.optim import AdamWConfig, adamw_update
    from repro_torch.train import (
        TrainConfig,
        make_train_step,
        train_state_init,
    )

    def rel(a, b):
        return abs(float(a) - float(b)) / abs(float(b))

    args = [
        "--arch", arch, "--smoke", "--steps", "2", "--batch", "2",
        "--seq", "16", "--sc-backend", "pallas_moment",
    ]
    grid = {}
    for dev in ("cuda", "cpu"):
        _, hist = _train(args + ["--device", dev],
                         os.path.join(workdir, f"x_{arch}_{dev}"))
        grid[dev] = hist["loss"]
    grid_rel = max(rel(a, b) for a, b in zip(grid["cuda"], grid["cpu"]))

    cfg = get_smoke_config(arch).replace(
        param_dtype=torch.float32, act_dtype=torch.float32,
        sc_backend="pallas_moment",
    )
    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr=1e-3, total_steps=2, warmup_steps=1))
    step = make_train_step(cfg, tcfg)
    card = train_state_init(0, cfg, tcfg, device="cuda")
    host = train_state_init(0, cfg, tcfg, device="cpu")
    off = {"cuda": [], "cpu_same_state": [], "cpu": [], "grad_norm_rel": [],
           "grads": [], "update": []}
    with operand_grid_off(), _GradSpy() as spy:
        for i in range(2):
            batch = _family_batch(cfg, 2, 16, i)
            before = tree_map(lambda t: t.cpu(), card)
            _, m_same = step(before, batch)
            card, m = step(card, batch)
            g_cpu, g_card = spy.grads
            want, _, _ = adamw_update(tree_map(lambda t: t.cpu(), g_card),
                                      before["opt"], before["params"],
                                      tcfg.optimizer)
            host, m_host = step(host, batch)
            spy.grads.clear()
            off["cuda"].append(float(m["loss"]))
            off["cpu_same_state"].append(float(m_same["loss"]))
            off["cpu"].append(float(m_host["loss"]))
            off["grad_norm_rel"].append(rel(m["grad_norm"],
                                            m_same["grad_norm"]))
            off["grads"].append(_leaf_gap(g_card, g_cpu))
            off["update"].append(_leaf_gap(card["params"], want))
    same_rel = max(rel(a, b) for a, b in zip(off["cuda"],
                                             off["cpu_same_state"]))
    run_rel = max(rel(a, b) for a, b in zip(off["cuda"], off["cpu"]))
    rec = dict(arch=arch, grid=grid, grid_max_rel=grid_rel, grid_off=off,
               max_rel=same_rel, trajectory_max_rel=run_rel)
    emit("train_cross_device", **rec)
    faults = []
    if not same_rel <= 1e-4:
        faults.append(f"same-state loss {same_rel}")
    if not max(off["grad_norm_rel"]) <= 1e-4:
        faults.append(f"same-state grad norm {off['grad_norm_rel']}")
    if not max(g for _, g in off["grads"]) <= 1e-4:
        faults.append(f"gradient leaves {off['grads']}")
    if not max(g for _, g in off["update"]) <= 1e-6:
        faults.append(f"AdamW update {off['update']}")
    if not run_rel <= 1e-4:
        faults.append(f"independent runs, grid off, {run_rel}")
    if arch in GRID_TRAJECTORY_HELD and not grid_rel <= 1e-4:
        faults.append(f"independent runs, grid on, {grid_rel}")
    if faults:
        raise AssertionError(f"train_cross_device {arch}: card vs CPU: "
                             + "; ".join(faults))
    return rec


def family_train_phase(tag: str, arch: str, layers: int, batch: int,
                       seq: int, workdir: str) -> dict:
    """Train ``arch`` at its published width, ``layers`` deep, float32,
    ``pallas_moment`` at nbit 1024 with ``remat="full"``, random weights
    from seed 0, ``FAMILY_STEPS`` steps of batch x seq through
    ``launch/train.py`` on the card.  Kernel 5's and ``sc_mac_reduce``'s
    launches a step must be ``kernel5_plan``'s, and kernel 5's the same
    in one more step at half the batch and half the sequence; no other
    kernel may launch; the losses must be finite.  Then one step at the
    phase's shapes under ``torch.profiler``: device ms of kernel 5, the
    GEMMs (the straight-through backward, the SSD and attention
    einsums) and the rest, and the idle share against the untraced
    median."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, make_train_step

    cfg = get_config(arch).replace(
        n_layers=layers, sc_backend="pallas_moment",
        param_dtype=torch.float32, act_dtype=torch.float32,
    )
    if cfg.remat != "full" or cfg.sc_nbit != 1024:
        raise AssertionError(f"{tag}: remat {cfg.remat}, nbit {cfg.sc_nbit}")
    plan = kernel5_plan(cfg, batch, seq)
    args = [
        "--arch", arch, "--layers", str(layers), "--steps",
        str(FAMILY_STEPS), "--batch", str(batch), "--seq", str(seq),
        "--sc-backend", "pallas_moment", "--ckpt-every", "1000",
        "--seed", "0",
    ]
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    state, hist = _train(args, os.path.join(workdir, tag))
    wall = time.perf_counter() - t0
    counts = dict(cuda_lib.launches)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(v.numel() for v in tree_leaves(state["params"]))
    steps = hist["steps"]
    losses = [r["loss"] for r in steps]
    step_ms = [r["ms"] for r in steps]
    median = float(np.median(step_ms))
    per_step = {k: counts.get(k, 0) / FAMILY_STEPS for k in plan}

    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=1))
    step = make_train_step(cfg, tcfg)
    alt_b, alt_s = max(1, batch // 2), seq // 2
    alt_plan = kernel5_plan(cfg, alt_b, alt_s)
    cuda_lib.reset_launches()
    state, m = step(state, _family_batch(cfg, alt_b, alt_s, FAMILY_STEPS))
    alt = dict(cuda_lib.launches)
    alt_loss = float(m["loss"])
    full = _family_batch(cfg, batch, seq, FAMILY_STEPS + 1)

    def traced_step():
        new_state, mt = step(state, full)
        float(mt["loss"])
        return new_state

    _, tr = device_trace(traced_step)
    classes = by_class_ms(tr)
    rec = dict(
        arch=arch,
        layers=layers,
        batch=batch,
        seq=seq,
        params=n_params,
        losses=losses,
        step_ms=step_ms,
        median_step_ms=median,
        max_memory_allocated=peak,
        launches_per_step=per_step,
        launches_planned=plan,
        launches=counts,
        alt_shape=[alt_b, alt_s],
        alt_launches=alt,
        alt_planned=alt_plan,
        alt_loss=alt_loss,
        wall_s=wall,
        traced_wall_ms=tr["wall_ms"],
        device_ms=tr["device_ms"],
        by_class_ms=classes,
        idle_share=1 - tr["device_ms"] / median if tr["device_ms"] else None,
        top=_top(tr, 8),
    )
    emit(f"train_{tag}", **rec)
    del state, step
    torch.cuda.empty_cache()
    if set(counts) - set(plan) or per_step != plan:
        raise AssertionError(f"train_{tag}: launches {counts} over "
                             f"{FAMILY_STEPS} steps, planned {plan} a step")
    if alt != {k: v for k, v in alt_plan.items() if v}:
        raise AssertionError(f"train_{tag}: launches {alt} at {alt_b} x "
                             f"{alt_s}, planned {alt_plan}")
    if alt_plan["sc_mac_fused"] != plan["sc_mac_fused"]:
        raise AssertionError(f"train_{tag}: the kernel-5 plan depends on "
                             "batch x seq")
    if not all(math.isfinite(v) for v in losses + [alt_loss]):
        raise AssertionError(f"train_{tag}: a loss is not finite: {losses}")
    return rec


# ---------------------------------------------------------------------------
# Phase TM: training on a device mesh (4 ranks sharing the card)
# ---------------------------------------------------------------------------

TM_RANKS = 4
TM_MODEL_PARALLEL = 2  # a data 2 x model 2 mesh
TM_BATCH, TM_SEQ = 8, 64  # phase T's global batch
TM_STEPS = 3
TM_COMPRESS_STEPS = 2
TM_SMOKE_STEPS = 2
# phase T's optimizer (launch/train.py --steps 4): TM-d is held to T's
# losses
TM_ADAM = dict(lr=1e-3, total_steps=4, warmup_steps=1)


def _tm_cfg(layers: int):
    from repro_torch.configs import get_config

    cfg = get_config("qwen2-0.5b").replace(
        n_layers=layers, sc_backend="pallas_moment",
        param_dtype=torch.float32, act_dtype=torch.float32)
    if cfg.remat != "full" or cfg.sc_nbit != 1024:
        raise AssertionError(f"train_tm: remat {cfg.remat}, nbit "
                             f"{cfg.sc_nbit}")
    return cfg


def _tm_batch(cfg, step: int, batch: int = TM_BATCH, seq: int = TM_SEQ):
    from repro_torch.data import SyntheticLMData, make_batch

    return make_batch(SyntheticLMData(cfg.vocab, seq, batch, seed=0), step)


def state_checksums(state) -> list:
    """An exact checksum of every leaf of ``state`` (the sum of its bits
    as integers), in sorted-key order: equal lists mean equal bits but
    for a cancellation no float rounding can make."""
    from repro_torch.models.params import _leaves

    out = []
    for _, t in _leaves(state):
        t = t.detach().contiguous()
        if t.is_floating_point():
            t = t.view(torch.int32) if t.element_size() == 4 else \
                t.view(torch.int16)
        out.append(int(t.to(torch.int64).sum()))
    return out


def _span_totals(tracer, names) -> dict:
    """Seconds, bytes and count of the tracer's spans by name, then
    cleared."""
    out = {n: {"s": 0.0, "bytes": 0, "count": 0} for n in names}
    for sp in tracer.spans:
        if sp.name in out:
            out[sp.name]["s"] += sp.dur_ns / 1e9
            out[sp.name]["bytes"] += int(sp.attrs.get("bytes", 0))
            out[sp.name]["count"] += 1
    tracer.spans.clear()
    return out


# the collectives of a mesh step, each a span of the tracer
TM_SPANS = ("train.grad_allreduce", "sc.merge", "train.pod_exchange",
            "train.ef_exchange", "mesh.all_gather", "mesh.reduce_scatter",
            "fsdp.grad_allreduce", "fsdp.relayout", "seq.all_gather",
            "tp.gather", "tp.sum", "tp.vocab", "tp.lookup", "tp.relayout",
            "ep.gather", "ep.sum", "ep.grad")
TP_SPANS = ("tp.gather", "tp.sum", "tp.vocab", "tp.lookup", "tp.relayout")
EP_SPANS = ("ep.gather", "ep.sum", "ep.grad")


@contextlib.contextmanager
def step_layout(**kw):
    """``make_train_step`` builds its step with ``make_constrain(...,
    **kw)`` inside: ``seq_parallel=False`` keeps the residual sequence
    whole between layers (TM-f's layout), ``tensor_parallel=False``
    every in-layer tensor (the layout TM-a, TM-f and TM-s came with)."""
    import functools

    from repro_torch.train import step as step_mod

    orig = step_mod.make_constrain
    step_mod.make_constrain = functools.partial(orig, **kw)
    try:
        yield
    finally:
        step_mod.make_constrain = orig


def tm_steps(mesh, cfg, tcfg, steps: int, state=None, *,
             seq_parallel: bool = True, tensor_parallel: bool = False,
             keep_grads: bool = False) -> dict:
    """``steps`` mesh train steps from seed 0's weights (or ``state``):
    each step's loss, ms (the ranks start it together), the collective
    spans and every leaf's checksum after it.  ``seq_parallel=False``
    keeps the residual sequence whole between layers;
    ``tensor_parallel`` lays the in-layer tensors out over ``model``
    (the mesh step's default; off here unless asked, the layout the
    earlier phases came with);
    ``keep_grads`` takes step 1 in its two parts (``loss_and_grads``,
    ``apply``) and keeps its gradient (on the host) in
    ``rec["grads"]``."""
    import torch.distributed as dist

    from repro_torch.models.params import tree_map
    from repro_torch.obs.trace import Tracer, install_tracer, uninstall_tracer
    from repro_torch.train import make_train_step, train_state_init

    if state is None:
        state = train_state_init(0, cfg, tcfg, device=mesh.device,
                                 mesh=mesh)
    with step_layout(seq_parallel=seq_parallel,
                     tensor_parallel=tensor_parallel):
        step = make_train_step(cfg, tcfg, mesh)
    tracer = install_tracer(Tracer())
    rec = {"loss": [], "ms": [], "spans": [], "checksums": []}
    try:
        for i in range(steps):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grads = None
            if keep_grads and i == 0:
                loss, grads, ef = step.loss_and_grads(state, _tm_batch(cfg, i))
                # the forward and backward's peak, before the update's
                rec["grad_peak"] = torch.cuda.max_memory_allocated()
                state, _ = step.apply(state, grads, ef)
                loss = float(loss)
            else:
                state, m = step(state, _tm_batch(cfg, i))
                loss = float(m["loss"])
            torch.cuda.synchronize()
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["loss"].append(loss)
            rec["spans"].append(_span_totals(tracer, TM_SPANS))
            rec["checksums"].append(state_checksums(state))
            if grads is not None:
                rec["grads"] = tree_map(lambda g: g.detach().cpu(), grads)
                del grads
    finally:
        uninstall_tracer(tracer)
    rec["state"] = state
    return rec


def tm_smoke(mesh_cuda, mesh_cpu) -> dict:
    """Phase TM-b (in every rank): the SMOKE trainer on the 2 x 2 mesh,
    card against CPU with the operand grid off on both (the plain
    versions on the CPU, through the same world): each step's loss and
    every gradient leaf from the card's state on both devices (1e-4),
    and the independent runs' losses (1e-4)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.params import tree_map
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (
        TrainConfig,
        make_train_step,
        train_state_init,
    )

    cfg = get_smoke_config("qwen2-0.5b").replace(
        param_dtype=torch.float32, act_dtype=torch.float32,
        sc_backend="pallas_moment")
    tcfg = TrainConfig(optimizer=AdamWConfig(**TM_ADAM))
    step_card = make_train_step(cfg, tcfg, mesh_cuda)
    step_cpu = make_train_step(cfg, tcfg, mesh_cpu)
    card = train_state_init(0, cfg, tcfg, device=mesh_cuda.device)
    host = train_state_init(0, cfg, tcfg, device="cpu")
    rec = {"card": [], "cpu_same_state": [], "cpu": [], "grads": []}
    with operand_grid_off():
        for i in range(TM_SMOKE_STEPS):
            batch = _tm_batch(cfg, i, 8, 16)
            before = tree_map(lambda t: t.cpu(), card)
            l_same, g_same, _ = step_cpu.loss_and_grads(before, batch)
            _, g_card, _ = step_card.loss_and_grads(card, batch)
            card, m = step_card(card, batch)
            host, m_host = step_cpu(host, batch)
            rec["card"].append(float(m["loss"]))
            rec["cpu_same_state"].append(float(l_same))
            rec["cpu"].append(float(m_host["loss"]))
            rec["grads"].append(_leaf_gap(g_card, g_same))

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    rec["same_state_max_rel"] = rel(rec["card"], rec["cpu_same_state"])
    rec["trajectory_max_rel"] = rel(rec["card"], rec["cpu"])
    rec["ok"] = bool(rec["same_state_max_rel"] <= 1e-4
                     and rec["trajectory_max_rel"] <= 1e-4
                     and max(g for _, g in rec["grads"]) <= 1e-4)
    return rec


# TM-f's gathered parameters after TM_STEPS steps against TM-a's, in
# units of TM_ADAM's learning rate, as tests/test_torch_train_mesh.py
# holds its grid-on case: the values are TM-a's but for the gradient
# norm's sum order over the ranks (the clip a last place apart); with
# the 10-bit operand grid on, an operand a last place apart can cross a
# grid step, and where a gradient is noise Adam moves a parameter by up
# to 2 lr a step either way.  So every element within 2 lr a step, and
# at most TM_F_FLIP_SHARE of them past 0.2 lr.
TM_F_TOL_LR, TM_F_QUIET_LR, TM_F_FLIP_SHARE = 2.0 * TM_STEPS, 0.2, 1e-3


def tm_fsdp_plan(cfg, mesh) -> dict:
    """TM-f's plan, from the code before the run: the collectives of a
    step (``sharding.fsdp.collective_plan``) and a rank's persistent
    state bytes (parameters, ``m`` and ``v`` at their shard shapes from
    ``param_shardings``, and the int32 step)."""
    from repro_torch.launch.dryrun import _sharded_bytes
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.models import lm
    from repro_torch.models.params import abstract_params
    from repro_torch.sharding import fsdp, param_shardings

    specs = lm.lm_param_specs(cfg)
    whole = abstract_params(specs, cfg.param_dtype)
    return dict(
        # TM-f and TM-s run with the in-layer layout off: every leaf
        # gathers whole
        collectives=fsdp.collective_plan(cfg, mesh,
                                         reduce_axes=batch_axes(mesh),
                                         tensor_parallel=False),
        state_bytes=3 * _sharded_bytes(whole, param_shardings(specs, mesh))
        + 4)


def tm_fsdp(mesh, cfg, tm_a_params) -> dict:
    """Phase TM-f (in every rank): TM-a's model, batch, optimizer and data
    on the same mesh with ``TrainConfig(fsdp=True)``, TM_STEPS steps:
    the rank's persistent state bytes, its peak memory, the collectives
    of each step (tracer spans: count, bytes, seconds, host copies),
    kernel 5's launches, and the gathered parameters after the steps
    against TM-a's (``tm_a_params``, on the host)."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import lm
    from repro_torch.models.params import _leaves, tree_leaves
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding import param_shardings
    from repro_torch.train import TrainConfig, train_state_init

    plan = tm_fsdp_plan(cfg, mesh)
    tcfg = TrainConfig(optimizer=AdamWConfig(**TM_ADAM), fsdp=True)
    torch.cuda.empty_cache()
    state = train_state_init(0, cfg, tcfg, device=mesh.device, mesh=mesh)
    torch.cuda.synchronize()
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(state))
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    run = tm_steps(mesh, cfg, tcfg, TM_STEPS, state, seq_parallel=False)
    peak = torch.cuda.max_memory_allocated()
    launches = dict(cuda_lib.launches)
    del state
    placements = dict(_leaves(param_shardings(lm.lm_param_specs(cfg),
                                              mesh)))
    want = dict(_leaves(tm_a_params))
    lr = TM_ADAM["lr"]
    gap, worst, past, total = 0.0, None, 0, 0
    for path, shard in _leaves(run["state"]["params"]):
        d = (placements[path].gather(shard).cpu() - want[path]).abs()
        if worst is None or float(d.max()) > gap:
            gap, worst = float(d.max()), "/".join(path)
        past += int((d > TM_F_QUIET_LR * lr).sum())
        total += d.numel()
    del run["state"]
    torch.cuda.empty_cache()
    return dict(plan=plan, state_bytes=state_bytes,
                max_memory_allocated=peak, launches=launches,
                loss=run["loss"], step_ms=run["ms"], spans=run["spans"],
                checksums=run["checksums"],
                param_gap=gap, param_gap_leaf=worst,
                param_tol=TM_F_TOL_LR * lr, params_past_quiet=past,
                params=total, quiet_tol=TM_F_QUIET_LR * lr)


TM_S_STEPS = 2  # TM-s: TM-f's first steps with the sequence layout


def tm_seq(mesh, cfg) -> dict:
    """Phase TM-s (in every rank): TM-f's model, batch, optimizer, data
    and FSDP ∘ TP layout with the residual sequence over ``model``
    between layers (the mesh step's default), TM_S_STEPS steps: each
    step's loss and leaf checksums (to be TM-f's), kernel 5's launches,
    the sequence's gathers and the FSDP collectives a step (tracer
    spans), the step ms and the peak."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding import seq
    from repro_torch.train import TrainConfig, train_state_init

    tcfg = TrainConfig(optimizer=AdamWConfig(**TM_ADAM), fsdp=True)
    torch.cuda.empty_cache()
    state = train_state_init(0, cfg, tcfg, device=mesh.device, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    run = tm_steps(mesh, cfg, tcfg, TM_S_STEPS, state, keep_grads=True)
    peak = torch.cuda.max_memory_allocated()
    launches = dict(cuda_lib.launches)
    del state, run["state"]
    torch.cuda.empty_cache()
    plan = seq.seq_collective_plan(cfg, mesh, TM_BATCH, TM_SEQ)
    return dict(plan=plan["all-gather"], loss=run["loss"],
                checksums=run["checksums"], step_ms=run["ms"],
                spans=run["spans"], max_memory_allocated=peak,
                grad_peak=run["grad_peak"], launches=launches,
                grads=run["grads"])


# Phases TM-t and TM-cp: the in-layer layout (``sharding/tp.py``).  TM-t
# is TM-s (data 2 x model 2, FSDP ∘ TP, the sequence layout) with
# ``tensor_parallel=True``: 14 heads and 2 kv heads over model 2 (the
# heads branch), the MLP hidden and the loss's vocabulary blocks.  TM-cp
# is the same on data 1 x model 4, where 14 heads do not divide (the
# context-parallel branch: a rank's query block of 16 positions, k / v
# whole), against the same mesh with ``tensor_parallel=False``.  Each is
# held to its whole layout: the step-1 loss within TP_LOSS_TOL
# (relative) and every step-1 gradient leaf (the rank's shard) within
# TP_GRAD_TOL of its max |g|; the step-2 loss within TP_LOSS2_TOL, the
# grid-on tolerance of tests/test_torch_train_mesh.py: Adam's first
# update moves a parameter by about lr·sign(g), so where a gradient is
# within its float noise of zero the two layouts move it apart, and
# with the 10-bit operand grid on that reaches the SC operands.
TP_STEPS = 2
TP_LOSS_TOL = 1e-6
TP_LOSS2_TOL = 1e-4
TP_GRAD_TOL = 1e-5


def _tp_run(mesh, cfg, tcfg, tensor_parallel: bool) -> dict:
    """TP_STEPS steps of the FSDP ∘ TP layout from seed 0's weights with
    the in-layer layout on or off: losses, step ms, spans, step-1
    gradient (host), kernel 5's launches, the peak, and the shape of
    every leaf the gathers handed the layer code."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.sharding import fsdp
    from repro_torch.train import train_state_init

    torch.cuda.empty_cache()
    state = train_state_init(0, cfg, tcfg, device=mesh.device, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    with fsdp.record_gathers() as gathered:
        run = tm_steps(mesh, cfg, tcfg, TP_STEPS, state,
                       tensor_parallel=tensor_parallel, keep_grads=True)
    run["gathered"] = [[p, list(sh)] for p, sh in sorted(
        {("/".join(p), sh) for p, sh in gathered})]
    run["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    run["launches"] = dict(cuda_lib.launches)
    del state, run["state"]
    torch.cuda.empty_cache()
    return run


def gathered_want(cfg, mesh, tensor_parallel: bool = True) -> list:
    """``[path, shape]`` of every leaf an FSDP step's gathers hand the
    layer code, from the placements alone (``fsdp.keep_blocks``): each
    kept dimension at its block's size, every other whole."""
    from repro_torch.models import lm
    from repro_torch.models.params import _leaves
    from repro_torch.sharding import fsdp, param_shardings

    specs = lm.lm_param_specs(cfg)
    placements = param_shardings(specs, mesh)
    if tensor_parallel:
        placements = fsdp.keep_blocks(placements, cfg)
    out = []
    for (path, pl), (_, spec) in zip(_leaves(placements), _leaves(specs)):
        shape = list(spec.shape)
        for i, axes in enumerate(pl.dim_axes(len(shape))):
            for a in axes:
                if a in pl.keep:
                    shape[i] //= mesh.shape[a]
        if path[0] == "blocks":
            shape = shape[1:]
        out.append(["/".join(path), shape])
    return sorted(out)


def _tp_record(mesh, cfg, run, whole) -> dict:
    """TM-t's / TM-cp's record from its run and the whole layout's
    (``whole``: losses, step-1 gradient, peaks, step ms)."""
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.sharding import fsdp
    from repro_torch.sharding.tp import tp_collective_plan

    leaf, gap = _leaf_gap(run["grads"], whole["grads"])
    rows = TM_BATCH // mesh.shape["data"]
    return dict(
        mesh=mesh.shape, coords=mesh.coords, loss=run["loss"],
        whole_loss=whole["loss"][:TP_STEPS],
        loss_rel=[abs(a - b) / abs(b) for a, b in
                  zip(run["loss"], whole["loss"])],
        grad_gap=gap, grad_gap_leaf=leaf, step_ms=run["ms"],
        whole_step_ms=whole["ms"][:TP_STEPS],
        max_memory_allocated=run["max_memory_allocated"],
        whole_max_memory_allocated=whole["max_memory_allocated"],
        grad_peak=run["grad_peak"], whole_grad_peak=whole["grad_peak"],
        launches=run["launches"],
        whole_launches=whole["launches"],
        kernel5_plan=kernel5_plan(cfg, rows, TM_SEQ,
                                  model_parallel=mesh.shape["model"]),
        tp_spans=[{n: sp[n] for n in TP_SPANS} for sp in run["spans"]],
        tp_plan=tp_collective_plan(cfg, mesh, TM_BATCH, TM_SEQ, fsdp=True),
        fsdp_spans=[{kind: {k: sp[n][k] for k in ("count", "bytes", "s")}
                     for kind, n in FSDP_COLLECTIVES.items()
                     if sp[n]["count"]} for sp in run["spans"]],
        fsdp_plan=fsdp.collective_plan(cfg, mesh,
                                       reduce_axes=batch_axes(mesh)),
        gathered=run["gathered"], gathered_want=gathered_want(cfg, mesh),
        gathered_whole=gathered_want(cfg, mesh, tensor_parallel=False))


def tm_tp(mesh, cfg, tm_s) -> dict:
    """Phase TM-t (in every rank): TM-s's model, batch, optimizer, data,
    FSDP ∘ TP layout and sequence layout with the in-layer layout on,
    TP_STEPS steps, against TM-s (``tm_s``, this rank's record)."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig

    tcfg = TrainConfig(optimizer=AdamWConfig(**TM_ADAM), fsdp=True)
    run = _tp_run(mesh, cfg, tcfg, True)
    whole = dict(loss=tm_s["loss"], grads=tm_s["grads"], ms=tm_s["step_ms"],
                 max_memory_allocated=tm_s["max_memory_allocated"],
                 grad_peak=tm_s["grad_peak"], launches=tm_s["launches"])
    return _tp_record(mesh, cfg, run, whole)


def tm_cp(cfg) -> dict:
    """Phase TM-cp (in every rank): TM-t on data 1 x model 4 (the
    context-parallel branch), against the same mesh with the in-layer
    layout off."""
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig

    mesh = DeviceMesh((1, 4), ("data", "model"))
    tcfg = TrainConfig(optimizer=AdamWConfig(**TM_ADAM), fsdp=True)
    whole = _tp_run(mesh, cfg, tcfg, False)
    run = _tp_run(mesh, cfg, tcfg, True)
    return _tp_record(mesh, cfg, run, whole)


# Phase TM-e: the MoE FFN's expert-parallel layout (``sharding/ep.py``) in
# the mesh train step.  T's recipe (float32, ``pallas_moment`` nbit 1024,
# remat, global batch 8 x 64) at moonshot-v1-16b-a3b's full width
# (64 experts, top-6), TM_E_LAYERS of 48 layers, on TM's data 2 x model 2
# mesh with ``TrainConfig(fsdp=True)``, against the same mesh with
# ``tensor_parallel=False``, TP_STEPS steps each, held to TM-t's
# tolerances: with the layout on a rank runs 32 of the 64 experts and
# gathers its experts' block of wi / wo over ``data`` only.  The ``ep.*``
# and ``tp.*`` spans a step equal ``tp_collective_plan``, the FSDP
# collectives ``sharding.fsdp.collective_plan`` (each layout's), and
# kernel 5's launches ``kernel5_plan`` at a rank's experts.
TM_E_LAYERS = 1


def _tm_e_cfg():
    from repro_torch.configs import get_config

    cfg = get_config("moonshot-v1-16b-a3b").replace(
        n_layers=TM_E_LAYERS, sc_backend="pallas_moment",
        param_dtype=torch.float32, act_dtype=torch.float32, remat="full")
    if cfg.sc_nbit != 1024:
        raise AssertionError(f"train_tm_e: nbit {cfg.sc_nbit}")
    return cfg


def tm_ep(mesh) -> dict:
    """Phase TM-e (in every rank): the layout off, then on; each run's
    losses, step-1 gradient (host), spans, launches, peak and step ms,
    and the plans of both from the code."""
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding import ep, fsdp
    from repro_torch.sharding.tp import tp_collective_plan
    from repro_torch.train import TrainConfig
    from repro_torch.train.step import make_constrain

    cfg = _tm_e_cfg()
    tcfg = TrainConfig(optimizer=AdamWConfig(**TM_ADAM), fsdp=True)
    whole = _tp_run(mesh, cfg, tcfg, False)
    run = _tp_run(mesh, cfg, tcfg, True)
    rows = TM_BATCH // mesh.shape["data"]
    mp = mesh.shape["model"]
    local = ep.expert_block(make_constrain(mesh), cfg).size
    leaf, gap = _leaf_gap(run["grads"], whole["grads"])
    out = dict(
        mesh=mesh.shape, coords=mesh.coords, layers=TM_E_LAYERS,
        experts={"ep": local, "whole": cfg.n_experts},
        loss_rel=[abs(a - b) / abs(b) for a, b in
                  zip(run["loss"], whole["loss"])],
        grad_gap=gap, grad_gap_leaf=leaf,
        tp_plan=tp_collective_plan(cfg, mesh, TM_BATCH, TM_SEQ, fsdp=True),
        kernel5_plan={
            "ep": kernel5_plan(cfg, rows, TM_SEQ, model_parallel=mp,
                               experts=local),
            "whole": kernel5_plan(cfg, rows, TM_SEQ, model_parallel=mp)},
        fsdp_plan={name: fsdp.collective_plan(
            cfg, mesh, reduce_axes=batch_axes(mesh), tensor_parallel=on)
            for name, on in (("ep", True), ("whole", False))})
    for name, r in (("ep", run), ("whole", whole)):
        out[name] = dict(
            loss=r["loss"], step_ms=r["ms"], launches=r["launches"],
            max_memory_allocated=r["max_memory_allocated"],
            grad_peak=r["grad_peak"],
            spans=[{n: {"count": sp[n]["count"], "bytes": sp[n]["bytes"],
                        "s": sp[n]["s"]} for n in TM_SPANS if sp[n]["count"]}
                   for sp in r["spans"]])
    return out


def all_to_all_probe(mesh) -> dict:
    """``launch/mesh.py:all_to_all`` (gloo's ``all_to_all_single`` on
    CUDA tensors, what the relayouts run) over the ``model`` group:
    float32 pieces of uneven sizes, each received piece against what
    its sender filled it with."""
    from repro_torch.launch.mesh import all_to_all

    m, me = mesh.shape["model"], mesh.coords["model"]
    pieces = [torch.full((c + 1 + me,), 100.0 * me + c, device=mesh.device)
              for c in range(m)]
    got = all_to_all(pieces, mesh, "model",
                     [(me + 1 + j,) for j in range(m)])
    ok = all(torch.equal(g.cpu(), torch.full((me + 1 + j,), 100.0 * j + me))
             for j, g in enumerate(got))
    return dict(backend=mesh.backend, device=str(mesh.device), ranks=m,
                dtype="float32", uneven=True, ok=ok)


def tm_rank(outdir: str, layers: int) -> int:
    """One rank of phase TM, started by :func:`train_mesh_phase` under
    ``torchrun``: TM-a (qwen2-0.5b at full width, depth ``layers``, on
    the data 2 x model 2 mesh, TM_STEPS steps), TM-b (the SMOKE trainer
    on the same mesh, card against CPU) and TM-c (pod 2 x data 1 x
    model 2 with the cross-pod compression), then TM-f (TM-a on the FSDP
    ∘ TP layout, :func:`tm_fsdp`).  Writes ``tm_rank<r>.json``
    in ``outdir``."""
    import torch.distributed as dist

    from repro_torch.distributed import init_error_feedback
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.mesh import DeviceMesh, make_local_mesh
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, train_state_init

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _tm_cfg(layers)
    tcfg = TrainConfig(optimizer=AdamWConfig(**TM_ADAM))
    mesh = make_local_mesh(TM_MODEL_PARALLEL)
    rec = dict(rank=mesh.rank, device=str(mesh.device), backend=mesh.backend,
               mesh=mesh.shape, coords=mesh.coords,
               all_to_all=all_to_all_probe(mesh))
    t_init = time.perf_counter()
    state = train_state_init(0, cfg, tcfg, device=mesh.device)
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t_init
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    run = tm_steps(mesh, cfg, tcfg, TM_STEPS, state)
    launches = dict(cuda_lib.launches)
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    tm_a_params = tree_map(lambda t: t.detach().cpu(),
                           run["state"]["params"])
    del state, run["state"]
    torch.cuda.empty_cache()
    rec.update(launches=launches, loss=run["loss"], step_ms=run["ms"],
               spans=run["spans"], checksums=run["checksums"])
    rec["fsdp"] = tm_fsdp(mesh, cfg, tm_a_params)
    del tm_a_params
    rec["seq"] = tm_seq(mesh, cfg)
    rec["tp"] = tm_tp(mesh, cfg, rec["seq"])
    del rec["seq"]["grads"]
    rec["cp"] = tm_cp(cfg)
    rec["ep"] = tm_ep(mesh)

    rec["smoke"] = tm_smoke(mesh, make_local_mesh(TM_MODEL_PARALLEL,
                                                  device="cpu"))

    pod = DeviceMesh((2, 1, 2), ("pod", "data", "model"))
    ctcfg = TrainConfig(optimizer=AdamWConfig(**TM_ADAM),
                        cross_pod_compress=True)
    cstate = train_state_init(0, cfg, ctcfg, device=pod.device)
    cstate["ef"] = init_error_feedback(cstate["params"], 2)
    crun = tm_steps(pod, cfg, ctcfg, TM_COMPRESS_STEPS, cstate)
    ef = crun["state"]["ef"]
    rec["compress"] = dict(
        coords=pod.coords, loss=crun["loss"], step_ms=crun["ms"],
        spans=crun["spans"],
        ef_checksums=state_checksums(ef),
        ef_max_abs=max(float(t.abs().max()) for t in tree_leaves(ef)),
        ef_lead=sorted({t.shape[0] for t in tree_leaves(ef)}),
    )
    del crun, cstate, ef
    torch.cuda.empty_cache()
    with open(os.path.join(outdir, f"tm_rank{mesh.rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.barrier()
    return 0


def tm_world_one(layers: int, t_losses: dict) -> dict:
    """Phase TM-d: in this process (a world of one), the mesh step on
    ``make_local_mesh()`` against the single-device step, 2 steps of
    phase T's run from the same seed: losses and every leaf bit for
    bit, and the losses phase T's."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (
        TrainConfig,
        make_train_step,
        train_state_init,
    )

    cfg = _tm_cfg(layers)
    tcfg = TrainConfig(optimizer=AdamWConfig(**TM_ADAM))
    out = {}
    for name, mesh in (("single", None), ("mesh", make_local_mesh())):
        state = train_state_init(0, cfg, tcfg)
        step = make_train_step(cfg, tcfg, mesh)
        losses = []
        for i in range(2):
            state, m = step(state, _tm_batch(cfg, i))
            losses.append(float(m["loss"]))
        out[name] = dict(loss=losses, checksums=state_checksums(state))
        del state, step
        torch.cuda.empty_cache()
    rec = dict(mesh_losses=out["mesh"]["loss"],
               single_losses=out["single"]["loss"],
               t_losses=[t_losses[1], t_losses[2]],
               bit_equal=out["mesh"] == out["single"])
    emit("train_tm_world_one", **rec)
    if not rec["bit_equal"]:
        raise AssertionError("train_tm: the trivial mesh's step differs "
                             "from the single-device step")
    if rec["mesh_losses"] != rec["t_losses"]:
        raise AssertionError(f"train_tm: the trivial mesh's losses "
                             f"{rec['mesh_losses']} are not phase T's "
                             f"{rec['t_losses']}")
    return rec


def train_mesh_phase(layers: int, card: str, t_losses: dict, ranks: list,
                     seconds: float) -> dict:
    """Phase TM: training on a device mesh (``ranks``: what each rank
    wrote in :func:`mesh_ranks`' launch); see the module doc."""
    probe = [r["all_to_all"] for r in ranks]
    emit("mesh_all_to_all_probe", card=card, ranks=probe)
    if not all(p["ok"] for p in probe):
        raise AssertionError(f"all_to_all over gloo on the card: {probe}")
    world_one = tm_world_one(layers, t_losses)
    cfg = _tm_cfg(layers)
    plan = kernel5_plan(cfg, TM_BATCH // (TM_RANKS // TM_MODEL_PARALLEL),
                        TM_SEQ, model_parallel=TM_MODEL_PARALLEL)
    for rec in ranks:
        spans = rec["spans"]
        step_s = [ms / 1e3 for ms in rec["step_ms"]]
        ar = [s["train.grad_allreduce"]["s"] for s in spans]
        merge = [s["sc.merge"]["s"] for s in spans]
        rec["median_step_ms"] = float(np.median(rec["step_ms"]))
        rec["allreduce_share"] = float(np.median(
            [a / s for a, s in zip(ar, step_s)]))
        rec["merge_share"] = float(np.median(
            [a / s for a, s in zip(merge, step_s)]))
        rec["allreduce_bytes_per_step"] = spans[0]["train.grad_allreduce"][
            "bytes"]
        rec["merges_per_step"] = spans[0]["sc.merge"]["count"]
        rec["launches_per_step"] = {
            k: rec["launches"].get(k, 0) / TM_STEPS for k in plan}
        emit("train_tm_rank", **{k: rec[k] for k in (
            "rank", "device", "backend", "coords", "init_s", "loss",
            "step_ms", "median_step_ms", "allreduce_share", "merge_share",
            "allreduce_bytes_per_step", "merges_per_step",
            "max_memory_allocated", "launches_per_step", "smoke",
            "compress")})
    first = ranks[0]
    summary = dict(
        mesh=first["mesh"], backend=first["backend"], ranks=TM_RANKS,
        card=card, seconds=seconds, loss=first["loss"],
        median_step_ms=[r["median_step_ms"] for r in ranks],
        allreduce_share=[r["allreduce_share"] for r in ranks],
        merge_share=[r["merge_share"] for r in ranks],
        allreduce_bytes_per_step=first["allreduce_bytes_per_step"],
        max_memory_allocated=[r["max_memory_allocated"] for r in ranks],
        kernel5_plan=plan,
        launches_per_step=first["launches_per_step"],
        compress_loss=first["compress"]["loss"],
        compress_ef_max_abs=first["compress"]["ef_max_abs"],
        world_one=world_one,
    )
    emit("train_tm", **summary)
    comp = [r["compress"] for r in ranks]
    for ok, what in (
        (all(r["checksums"] == first["checksums"] for r in ranks),
         "the ranks' parameters or optimizer states differ"),
        (all(r["loss"] == first["loss"] for r in ranks),
         "the ranks' losses differ"),
        (all(math.isfinite(v) for v in first["loss"]), "a loss is not "
         "finite"),
        (all(r["launches_per_step"] == plan for r in ranks),
         f"kernel-5 launches a step {[r['launches_per_step'] for r in ranks]}"
         f", planned {plan}"),
        (all(set(r["launches"]) <= set(plan) for r in ranks),
         "a kernel other than kernel 5 launched"),
        (all(r["smoke"]["ok"] for r in ranks),
         f"the SMOKE trainer differs between card and CPU: "
         f"{[r['smoke'] for r in ranks]}"),
        (all(c["ef_checksums"] == comp[0]["ef_checksums"] for c in comp),
         "the ranks' error-feedback residuals differ"),
        (all(c["loss"] == comp[0]["loss"] for c in comp)
         and all(math.isfinite(v) for v in comp[0]["loss"]),
         "the compressed losses differ or are not finite"),
        (comp[0]["ef_max_abs"] > 0 and comp[0]["ef_lead"] == [2],
         f"the residual is {comp[0]['ef_max_abs']}, leading dims "
         f"{comp[0]['ef_lead']}"),
    ):
        if not ok:
            raise AssertionError(f"train_tm: {what}")
    fsdp = train_fsdp_phase(ranks, plan, card)
    seq_rec = train_seq_phase(ranks, plan, card)
    tp_rec = {tag: train_tp_phase(ranks, tag, card) for tag in ("tp", "cp")}
    ep_rec = train_ep_phase(ranks, card)
    launches = {k: first["launches"].get(k, 0)
                + sum(first[t]["launches"].get(k, 0) for t in ("tp", "cp"))
                + first["ep"]["ep"]["launches"].get(k, 0)
                for k in plan}
    return dict(summary, launches=launches, ranks_detail=ranks,
                fsdp=fsdp, seq=seq_rec, tp=tp_rec, ep=ep_rec)


def train_tp_phase(ranks: list, tag: str, card: str) -> dict:
    """Phase TM-t's (``tag`` "tp") or TM-cp's ("cp") checks (``ranks``:
    what each TM rank wrote): per rank the step-1 loss within
    TP_LOSS_TOL of the whole layout's and the step-2 loss within
    TP_LOSS2_TOL, every step-1 gradient leaf within TP_GRAD_TOL of its
    max |g|, kernel 5's launches a step ``kernel5_plan``'s (and
    the whole layout's), the in-layer collectives a step (spans
    ``tp.gather`` / ``tp.sum`` / ``tp.vocab`` / ``tp.lookup`` /
    ``tp.relayout``: count and bytes) equal to
    ``sharding.tp.tp_collective_plan(..., fsdp=True)``, the FSDP
    collectives a step (``mesh.all_gather``, ``mesh.reduce_scatter``,
    ``fsdp.grad_allreduce``, ``fsdp.relayout``) equal to
    ``sharding.fsdp.collective_plan``, and every leaf the gathers handed
    the layer code at the shape the placements keep (``fsdp.keep_blocks``:
    a kept leaf is its ``model`` block); the step ms and the peaks (the
    step's, and step 1's forward and backward, ``grad_peak``) beside the
    whole layout's."""
    name = {"tp": "train_tm_t", "cp": "train_tm_cp"}[tag]
    out = []
    for rec in ranks:
        t = rec[tag]
        plan = t["kernel5_plan"]
        per_step = {k: t["launches"].get(k, 0) / TP_STEPS for k in plan}
        spans = [{n: {"count": sp[n]["count"], "bytes": sp[n]["bytes"]}
                  for n in TP_SPANS if sp[n]["count"]} for sp in t["tp_spans"]]
        fsdp_steps = [{k: {"count": v["count"], "bytes": v["bytes"]}
                       for k, v in sp.items()} for sp in t["fsdp_spans"]]
        fsdp_want = {k: t["fsdp_plan"][k] for k in FSDP_COLLECTIVES
                     if k in t["fsdp_plan"]}
        kept = [p for (p, sh), (_, whole) in zip(
            t["gathered_want"], t["gathered_whole"]) if sh != whole]
        step_s = [ms / 1e3 for ms in t["step_ms"]]
        tp_s = [sum(sp[n]["s"] for n in TP_SPANS) for sp in t["tp_spans"]]
        r = dict(
            rank=rec["rank"], mesh=t["mesh"], coords=t["coords"],
            loss=t["loss"], whole_loss=t["whole_loss"],
            loss_rel=t["loss_rel"], grad_gap=t["grad_gap"],
            grad_gap_leaf=t["grad_gap_leaf"], tp_per_step=spans[0],
            tp_plan=t["tp_plan"], fsdp_per_step=fsdp_steps[0],
            fsdp_plan=fsdp_want, kept_leaves=len(kept),
            gathered_as_planned=t["gathered"] == t["gathered_want"],
            launches_per_step=per_step,
            kernel5_plan=plan, step_ms=t["step_ms"],
            whole_step_ms=t["whole_step_ms"],
            median_step_ms=float(np.median(t["step_ms"])),
            whole_median_step_ms=float(np.median(t["whole_step_ms"])),
            tp_share=float(np.median([a / b for a, b in zip(tp_s,
                                                            step_s)])),
            max_memory_allocated=t["max_memory_allocated"],
            whole_max_memory_allocated=t["whole_max_memory_allocated"],
            grad_peak=t["grad_peak"], whole_grad_peak=t["whole_grad_peak"],
            peak_drop=t["whole_grad_peak"] - t["grad_peak"],
            fsdp_s=[sum(v["s"] for v in sp.values())
                    for sp in t["fsdp_spans"]])
        emit(f"{name}_rank", **r)
        for ok, what in (
            (all(math.isfinite(v) for v in t["loss"]), "a loss is not "
             "finite"),
            (t["loss_rel"][0] <= TP_LOSS_TOL
             and max(t["loss_rel"]) <= TP_LOSS2_TOL,
             f"losses {t['loss']}, the whole layout's {t['whole_loss']}"),
            (t["grad_gap"] <= TP_GRAD_TOL, f"step-1 gradient "
             f"{t['grad_gap_leaf']} {t['grad_gap']} of its max |g| from the "
             "whole layout's"),
            (all(sp == t["tp_plan"] for sp in spans),
             f"in-layer collectives a step {spans}, planned {t['tp_plan']}"),
            (all(sp == fsdp_want for sp in fsdp_steps),
             f"FSDP collectives a step {fsdp_steps}, planned {fsdp_want}"),
            (r["gathered_as_planned"] and kept,
             f"gathered leaves {t['gathered']}, planned "
             f"{t['gathered_want']}"),
            (per_step == plan and set(t["launches"]) <= set(plan)
             and t["launches"] == t["whole_launches"],
             f"kernel-5 launches a step {per_step}, planned {plan}, the "
             f"whole layout's {t['whole_launches']}"),
        ):
            if not ok:
                raise AssertionError(f"{name}: rank {r['rank']}: {what}")
        out.append(r)
    if any(r["loss"] != out[0]["loss"] for r in out):
        raise AssertionError(f"{name}: the ranks' losses differ")
    summary = dict(
        card=card, mesh=out[0]["mesh"], ranks=len(out), steps=TP_STEPS,
        loss=out[0]["loss"], whole_loss=out[0]["whole_loss"],
        loss_rel=[max(r["loss_rel"][i] for r in out)
                  for i in range(TP_STEPS)],
        grad_gap=max(r["grad_gap"] for r in out),
        tp_per_step=out[0]["tp_per_step"],
        fsdp_per_step=out[0]["fsdp_per_step"],
        kept_leaves=out[0]["kept_leaves"],
        launches_per_step=out[0]["launches_per_step"],
        median_step_ms=[r["median_step_ms"] for r in out],
        whole_median_step_ms=[r["whole_median_step_ms"] for r in out],
        tp_share=[r["tp_share"] for r in out],
        max_memory_allocated=[r["max_memory_allocated"] for r in out],
        whole_max_memory_allocated=[r["whole_max_memory_allocated"]
                                    for r in out],
        grad_peak=[r["grad_peak"] for r in out],
        whole_grad_peak=[r["whole_grad_peak"] for r in out],
        peak_drop=[r["peak_drop"] for r in out])
    emit(name, **summary)
    return summary


def train_ep_phase(ranks: list, card: str) -> dict:
    """Phase TM-e's checks (``ranks``: what each TM rank wrote, its
    ``ep`` record): per rank the step-1 loss within TP_LOSS_TOL of the
    layout off's and the step-2 loss within TP_LOSS2_TOL, every step-1
    gradient leaf within TP_GRAD_TOL of its max |g|, the ``ep.*`` and
    ``tp.*`` spans a step equal to ``tp_collective_plan``, each layout's
    FSDP collectives a step equal to its ``collective_plan``, kernel 5's
    launches a step ``kernel5_plan``'s at the rank's experts (and the
    layout off's at all 64), the peak below the layout off's; the step
    ms beside it.  The peak compared is step 1's forward and backward
    (``grad_peak``), where the expert leaves live: the step's own peak
    is the AdamW update's (its new parameters, ``m`` and ``v`` beside the
    old ones), the same in both layouts, and is printed beside it."""
    out = []
    for rec in ranks:
        t = rec["ep"]
        per_step, coll, launches = {}, {}, {}
        for name in ("ep", "whole"):
            run = t[name]
            per_step[name] = [{n: {k: sp[n][k] for k in ("count", "bytes")}
                               for n in TP_SPANS + EP_SPANS if n in sp}
                              for sp in run["spans"]]
            coll[name] = [{kind: {k: sp[n][k] for k in ("count", "bytes")}
                           for kind, n in FSDP_COLLECTIVES.items()
                           if n in sp} for sp in run["spans"]]
            launches[name] = {k: run["launches"].get(k, 0) / TP_STEPS
                              for k in t["kernel5_plan"][name]}
        fsdp_want = {name: {kind: p[kind] for kind in FSDP_COLLECTIVES
                            if kind in p}
                     for name, p in t["fsdp_plan"].items()}
        step_s = [ms / 1e3 for ms in t["ep"]["step_ms"]]
        ep_s = [sum(sp[n]["s"] for n in EP_SPANS if n in sp)
                for sp in t["ep"]["spans"]]
        r = dict(
            rank=rec["rank"], mesh=t["mesh"], coords=t["coords"],
            experts=t["experts"], loss=t["ep"]["loss"],
            whole_loss=t["whole"]["loss"], loss_rel=t["loss_rel"],
            grad_gap=t["grad_gap"], grad_gap_leaf=t["grad_gap_leaf"],
            in_layer_per_step=per_step["ep"][0], tp_plan=t["tp_plan"],
            fsdp_per_step={k: v[0] for k, v in coll.items()},
            fsdp_plan=fsdp_want, launches_per_step=launches,
            kernel5_plan=t["kernel5_plan"],
            step_ms=t["ep"]["step_ms"], whole_step_ms=t["whole"]["step_ms"],
            median_step_ms=float(np.median(t["ep"]["step_ms"])),
            whole_median_step_ms=float(np.median(t["whole"]["step_ms"])),
            ep_share=float(np.median([a / b for a, b in zip(ep_s,
                                                            step_s)])),
            max_memory_allocated=t["ep"]["max_memory_allocated"],
            whole_max_memory_allocated=t["whole"]["max_memory_allocated"],
            grad_peak=t["ep"]["grad_peak"],
            whole_grad_peak=t["whole"]["grad_peak"])
        r["peak_drop"] = r["whole_grad_peak"] - r["grad_peak"]
        emit("train_tm_e_rank", **r)
        for ok, what in (
            (all(math.isfinite(v) for v in r["loss"]), "a loss is not "
             "finite"),
            (r["loss_rel"][0] <= TP_LOSS_TOL
             and max(r["loss_rel"]) <= TP_LOSS2_TOL,
             f"losses {r['loss']}, the layout off's {r['whole_loss']}"),
            (r["grad_gap"] <= TP_GRAD_TOL, f"step-1 gradient "
             f"{r['grad_gap_leaf']} {r['grad_gap']} of its max |g| from "
             "the layout off's"),
            (all(sp == t["tp_plan"] for sp in per_step["ep"]),
             f"in-layer collectives a step {per_step['ep']}, planned "
             f"{t['tp_plan']}"),
            (all(s == fsdp_want[name] for name in coll for s in coll[name]),
             f"FSDP collectives a step {coll}, planned {fsdp_want}"),
            (all(launches[name] == t["kernel5_plan"][name]
                 and set(t[name]["launches"]) <= set(t["kernel5_plan"][name])
                 for name in launches),
             f"kernel-5 launches a step {launches}, planned "
             f"{t['kernel5_plan']}"),
            (r["peak_drop"] > 0, f"step-1 forward and backward peak "
             f"{r['grad_peak']} not below the layout off's "
             f"{r['whole_grad_peak']}"),
        ):
            if not ok:
                raise AssertionError(f"train_tm_e: rank {r['rank']}: {what}")
        out.append(r)
    if any(r["loss"] != out[0]["loss"] for r in out):
        raise AssertionError("train_tm_e: the ranks' losses differ")
    summary = dict(
        card=card, mesh=out[0]["mesh"], ranks=len(out), steps=TP_STEPS,
        experts=out[0]["experts"], loss=out[0]["loss"],
        whole_loss=out[0]["whole_loss"],
        loss_rel=[max(r["loss_rel"][i] for r in out)
                  for i in range(TP_STEPS)],
        grad_gap=max(r["grad_gap"] for r in out),
        in_layer_per_step=out[0]["in_layer_per_step"],
        fsdp_per_step=out[0]["fsdp_per_step"],
        launches_per_step=out[0]["launches_per_step"],
        median_step_ms=[r["median_step_ms"] for r in out],
        whole_median_step_ms=[r["whole_median_step_ms"] for r in out],
        ep_share=[r["ep_share"] for r in out],
        max_memory_allocated=[r["max_memory_allocated"] for r in out],
        whole_max_memory_allocated=[r["whole_max_memory_allocated"]
                                    for r in out],
        grad_peak=[r["grad_peak"] for r in out],
        whole_grad_peak=[r["whole_grad_peak"] for r in out],
        peak_drop=[r["peak_drop"] for r in out])
    emit("train_tm_e", **summary)
    return summary


def train_seq_phase(ranks: list, plan: dict, card: str) -> dict:
    """Phase TM-s's checks (``ranks``: what each TM rank wrote, TM-f's
    ``fsdp`` record beside TM-s's ``seq``): per rank each step's loss
    and leaf checksums equal to TM-f's, kernel 5's launches a step
    ``kernel5_plan``'s, the sequence's gathers a step (span
    ``seq.all_gather``) equal in count and bytes to
    ``sharding.seq.seq_collective_plan``, the FSDP collectives a step
    TM-f's plan's; the step ms and the peak beside TM-f's."""
    out = []
    for rec in ranks:
        f, t = rec["fsdp"], rec["seq"]
        n = TM_S_STEPS
        gathers = [{"count": sp["seq.all_gather"]["count"],
                    "bytes": sp["seq.all_gather"]["bytes"]}
                   for sp in t["spans"]]
        coll = f["plan"]["collectives"]
        fsdp_steps = [{kind: {"count": sp[name]["count"],
                              "bytes": sp[name]["bytes"]}
                       for kind, name in FSDP_COLLECTIVES.items()
                       if kind in coll} for sp in t["spans"]]
        want_fsdp = {kind: coll[kind] for kind in FSDP_COLLECTIVES
                     if kind in coll}
        step_s = [ms / 1e3 for ms in t["step_ms"]]
        seq_s = [sp["seq.all_gather"]["s"] for sp in t["spans"]]
        r = dict(
            rank=rec["rank"], coords=rec["coords"], loss=t["loss"],
            tm_f_loss=f["loss"][:n], seq_gathers_per_step=gathers[0],
            seq_gathers_plan=t["plan"],
            launches_per_step={k: t["launches"].get(k, 0) / n
                               for k in plan}, kernel5_plan=plan,
            step_ms=t["step_ms"], tm_f_step_ms=f["step_ms"][:n],
            median_step_ms=float(np.median(t["step_ms"])),
            tm_f_median_step_ms=float(np.median(f["step_ms"][:n])),
            seq_share=float(np.median([a / b for a, b in zip(seq_s,
                                                             step_s)])),
            max_memory_allocated=t["max_memory_allocated"],
            tm_f_max_memory_allocated=f["max_memory_allocated"])
        emit("train_tm_seq_rank", **r)
        for ok, what in (
            (t["loss"] == f["loss"][:n], f"losses {t['loss']}, TM-f's "
             f"{f['loss'][:n]}"),
            (t["checksums"] == f["checksums"][:n],
             "a leaf's bits differ from TM-f's"),
            (all(g == t["plan"] for g in gathers),
             f"sequence gathers a step {gathers}, planned {t['plan']}"),
            (all(s == want_fsdp for s in fsdp_steps),
             f"FSDP collectives a step {fsdp_steps}, planned {want_fsdp}"),
            (r["launches_per_step"] == plan
             and set(t["launches"]) <= set(plan),
             f"kernel-5 launches a step {r['launches_per_step']}, planned "
             f"{plan}"),
        ):
            if not ok:
                raise AssertionError(f"train_tm_seq: rank {r['rank']}: "
                                     f"{what}")
        out.append(r)
    summary = dict(
        card=card, mesh=ranks[0]["mesh"], ranks=len(out), steps=TM_S_STEPS,
        loss=out[0]["loss"], bit_equal_tm_f=True,
        seq_gathers_per_step=out[0]["seq_gathers_per_step"],
        launches_per_step=out[0]["launches_per_step"], kernel5_plan=plan,
        median_step_ms=[r["median_step_ms"] for r in out],
        tm_f_median_step_ms=[r["tm_f_median_step_ms"] for r in out],
        seq_share=[r["seq_share"] for r in out],
        max_memory_allocated=[r["max_memory_allocated"] for r in out],
        tm_f_max_memory_allocated=[r["tm_f_max_memory_allocated"]
                                   for r in out])
    emit("train_tm_seq", **summary)
    return summary


FSDP_COLLECTIVES = {"all-gather": "mesh.all_gather",
                    "reduce-scatter": "mesh.reduce_scatter",
                    "all-reduce": "fsdp.grad_allreduce",
                    "all-to-all": "fsdp.relayout"}


def train_fsdp_phase(ranks: list, plan: dict, card: str) -> dict:
    """Phase TM-f's checks (``ranks``: what each TM rank wrote, TM-a
    beside TM-f's ``fsdp`` record): per rank the persistent state bytes
    against the shard plan, the peak against TM-a's, each step's
    all-gathers, reduce-scatters and gradient all-reduces (count and
    bytes) against the collective plan, kernel 5's launches a step
    against ``kernel5_plan``, the step ms and the collectives' share,
    and the gathered parameters against TM-a's."""
    out = []
    for rec in ranks:
        f = rec["fsdp"]
        coll = f["plan"]["collectives"]
        per_step = [{kind: {"count": sp[name]["count"],
                            "bytes": sp[name]["bytes"]}
                     for kind, name in FSDP_COLLECTIVES.items()
                     if kind in coll} for sp in f["spans"]]
        want = {kind: coll[kind] for kind in FSDP_COLLECTIVES if kind in coll}
        step_s = [ms / 1e3 for ms in f["step_ms"]]
        coll_s = [sum(sp[n]["s"] for n in TM_SPANS) for sp in f["spans"]]
        r = dict(
            rank=rec["rank"], coords=rec["coords"],
            state_bytes=f["state_bytes"],
            state_bytes_plan=f["plan"]["state_bytes"],
            max_memory_allocated=f["max_memory_allocated"],
            tm_a_max_memory_allocated=rec["max_memory_allocated"],
            collectives_per_step=per_step[0], collectives_plan=want,
            launches_per_step={k: f["launches"].get(k, 0) / TM_STEPS
                               for k in plan},
            kernel5_plan=plan, loss=f["loss"], tm_a_loss=rec["loss"],
            step_ms=f["step_ms"], tm_a_step_ms=rec["step_ms"],
            median_step_ms=float(np.median(f["step_ms"])),
            collective_share=float(np.median(
                [c / s for c, s in zip(coll_s, step_s)])),
            param_gap=f["param_gap"], param_gap_leaf=f["param_gap_leaf"],
            param_tol=f["param_tol"], quiet_tol=f["quiet_tol"],
            params_past_quiet=f["params_past_quiet"], params=f["params"])
        emit("train_tm_fsdp_rank", **r)
        for ok, what in (
            (r["state_bytes"] == r["state_bytes_plan"],
             f"state bytes {r['state_bytes']}, planned "
             f"{r['state_bytes_plan']}"),
            (r["max_memory_allocated"] < r["tm_a_max_memory_allocated"],
             f"peak {r['max_memory_allocated']} not below TM-a's "
             f"{r['tm_a_max_memory_allocated']}"),
            (all(s == want for s in per_step),
             f"collectives a step {per_step}, planned {want}"),
            (r["launches_per_step"] == plan
             and set(f["launches"]) <= set(plan),
             f"kernel-5 launches a step {r['launches_per_step']}, planned "
             f"{plan}"),
            (all(math.isfinite(v) for v in r["loss"]),
             f"a loss is not finite: {r['loss']}"),
            (r["param_gap"] <= r["param_tol"]
             and r["params_past_quiet"] <= TM_F_FLIP_SHARE * r["params"],
             f"gathered parameters {r['param_gap']} from TM-a's "
             f"({r['param_gap_leaf']}), tolerance {r['param_tol']}; "
             f"{r['params_past_quiet']} of {r['params']} past "
             f"{r['quiet_tol']}"),
        ):
            if not ok:
                raise AssertionError(f"train_tm_fsdp: rank {r['rank']}: "
                                     f"{what}")
        out.append(r)
    if any(r["loss"] != out[0]["loss"] for r in out):
        raise AssertionError("train_tm_fsdp: the ranks' losses differ")
    summary = dict(
        card=card, mesh=ranks[0]["mesh"], ranks=len(out),
        state_bytes=[r["state_bytes"] for r in out],
        state_bytes_plan=out[0]["state_bytes_plan"],
        max_memory_allocated=[r["max_memory_allocated"] for r in out],
        tm_a_max_memory_allocated=[r["tm_a_max_memory_allocated"]
                                   for r in out],
        collectives_per_step=out[0]["collectives_per_step"],
        launches_per_step=out[0]["launches_per_step"], kernel5_plan=plan,
        median_step_ms=[r["median_step_ms"] for r in out],
        collective_share=[r["collective_share"] for r in out],
        loss=out[0]["loss"], tm_a_loss=out[0]["tm_a_loss"],
        param_gap=max(r["param_gap"] for r in out),
        param_tol=out[0]["param_tol"],
        params_past_quiet=[r["params_past_quiet"] for r in out],
        params=out[0]["params"], quiet_tol=out[0]["quiet_tol"])
    emit("train_tm_fsdp", **summary)
    return summary


# ---------------------------------------------------------------------------
# Phase R: the dry-run's cost account, and two cells measured against it
# ---------------------------------------------------------------------------

# R-a: cells traced on ``meta`` for rank 0 of the 16 x 16 production mesh
R_DRYRUN = (("qwen2-0.5b", "train_4k"), ("qwen2-0.5b", "prefill_32k"),
            ("qwen2-0.5b", "decode_32k"), ("moonshot-v1-16b-a3b",
                                           "decode_32k"))
# R-b: (shape, global batch, sequence) of qwen2-0.5b cut to --layers
R_MEASURE = (("train_4k", 8, 4096), ("decode_32k", 128, 32768))
R_FLOOR = 0.95  # measured device time >= this x the largest roofline term


def cost_phase(layers: int, card: str) -> None:
    """Phase R: R-a traces the production cells of ``R_DRYRUN`` on
    ``meta`` (``launch/dryrun.py:lower_cell``, nothing allocated) and
    prints each one's per-rank GB, bound and terms; R-b runs the cells
    of ``R_MEASURE`` on the card (``launch/profile_cell.py:measure``):
    the matmul FLOPs ``FlopCounterMode`` counts on the card must equal
    the meta trace's for the same cut cell, and the device time must be
    at least R_FLOOR of the roofline's largest term; measured and
    predicted peak memory are printed beside each other."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import dryrun, profile_cell
    from repro_torch.launch.mesh import make_production_mesh

    for arch, shape in R_DRYRUN:
        t0 = time.perf_counter()
        r = dryrun.lower_cell(arch, shape, make_production_mesh())
        rec = dict(
            arch=arch, shape=shape, mesh=r["mesh"],
            trace_s=time.perf_counter() - t0,
            per_rank_gb=r["memory"]["total_per_device_gb"],
            reference_layout_gb=r["memory"]["reference_layout_gb"],
            **{k: r["roofline"][k] for k in ("bound", "compute_s",
                                              "memory_s", "collective_s")},
            off_meta=r["cost"]["off_meta"])
        emit("cost_r_dryrun", **rec)
        if rec["off_meta"]:
            raise AssertionError(f"cost_r: {arch} x {shape}'s trace "
                                 "allocated off meta")
    cuda_lib.reset_launches()
    for shape, batch, seq in R_MEASURE:
        m = profile_cell.measure("qwen2-0.5b", shape, layers=layers,
                                 batch=batch, seq=seq)
        torch.cuda.empty_cache()
        pred = m["predicted"]
        largest = max(pred["compute_ms"], pred["memory_ms"])
        rec = dict(m, card=card, largest_term_ms=largest,
                   device_over_largest=(m["device_ms"] or 0) / largest)
        emit("cost_r_measure", **rec)
        if m["flops"] != pred["flops"]:
            raise AssertionError(
                f"cost_r: {shape}: the card's matmul FLOPs {m['flops']} "
                f"are not the meta trace's {pred['flops']}")
        if m["device_ms"] is None or m["device_ms"] < R_FLOOR * largest:
            raise AssertionError(
                f"cost_r: {shape}: device {m['device_ms']} ms under "
                f"{R_FLOOR} x the largest roofline term {largest} ms")
    if any(cuda_lib.launches.values()):
        raise AssertionError(f"cost_r: a kernel launched "
                             f"{dict(cuda_lib.launches)} (exact path)")


# ---------------------------------------------------------------------------
# Phase C: the paper's cell model (conversion, engine, variance) on the card
# ---------------------------------------------------------------------------

C_MULS = 1000  # MULs a statistic is taken over (the reference's 300-1,000)
C_BIG_MULS = 65_536  # one sc_multiply at nbit 1024: a 67 M-cell state
C_CROSS_MULS = 4096  # MULs held card against CPU


def _sigma(p) -> float:
    return float(torch.std(p, correction=0))


def cell_model_phase() -> dict:
    """Phase C: the bounds of the reference's Fig. 7 / Fig. 8 tests at
    their sizes or larger, one ``sc_multiply`` of 65,536 MULs at nbit
    1024 (ms, peak memory, its error against the deterministic product),
    and 4,096 MULs on the card and on the CPU under one key: states equal
    except at cells whose uniform lies between the two devices'
    survival probabilities (float32 ``exp`` may round differently).  No
    kernel of the port may launch."""
    import warnings

    from repro_torch.core import conversion, engine, physics, variance
    from repro_torch.kernels import cuda_lib
    from repro_torch.sc import ctr_rng

    dev = "cuda"
    cuda_lib.reset_launches()
    key = ctr_rng.prng_key(0)
    t0 = time.perf_counter()

    def p_states(tau_y, nbit, k, tau_x=0.3):
        cfg = engine.EngineConfig(nbit=nbit)
        tx = torch.full((C_MULS,), tau_x, device=dev)
        ty = torch.full((C_MULS,), tau_y, device=dev)
        st = engine.sc_multiply_states(k, tx, ty, cfg, device=dev)
        return engine.readout(st)

    p7a = p_states(0.4, 1000, key)
    fig7a = dict(sigma=_sigma(p7a), mean=float(p7a.mean()),
                 p_true=math.exp(-0.7))
    s_nbit = {n: _sigma(p_states(0.4, n, ctr_rng.fold_in(key, n)))
              for n in (256, 1024, 4096)}
    s_tau = {ty: _sigma(p_states(ty, 1024, ctr_rng.fold_in(key, int(ty * 10))))
             for ty in (0.2, 0.4, 0.6)}
    cfg = engine.EngineConfig(nbit=1024)
    x = torch.full((C_MULS,), 400, device=dev)
    y = torch.full((C_MULS,), 700, device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        s_ic = {s: _sigma(variance.sc_mul_with_ic_variance(
            ctr_rng.fold_in(key, int(s * 100)), x, y, cfg, s, device=dev))
            for s in (0.0, 0.05, 0.10)}
    s_sc = {s: _sigma(variance.sc_mul_with_circuit_variance(
        ctr_rng.fold_in(key, int(s * 1000)), x, y, cfg, s, device=dev))
        for s in (0.04, 0.10)}
    s_log = {s: _sigma(variance.log_multiplier(
        ctr_rng.fold_in(key, 7000 + int(s * 1000)), x, y, cfg.conv, s,
        device=dev)) for s in (0.04, 0.10)}
    stats_s = time.perf_counter() - t0

    rng = np.random.default_rng(0)
    xs = torch.tensor(rng.integers(0, 1024, C_BIG_MULS), device=dev)
    ys = torch.tensor(rng.integers(0, 1024, C_BIG_MULS), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    big = {}

    def mul():
        big["out"] = engine.sc_multiply(key, xs, ys, cfg, device=dev)

    big_ms = time_ms(mul, 3)
    big_peak = torch.cuda.max_memory_allocated()
    err = big["out"][0] - conversion.quantized_product_probability(
        xs, ys, cfg.conv)
    # card against CPU: one key, the same operands
    xc, yc = xs[:C_CROSS_MULS].cpu(), ys[:C_CROSS_MULS].cpu()
    taus = [conversion.operand_to_tau(v, cfg.conv) for v in (xc, yc)]
    taus_card = [conversion.operand_to_tau(v.to(dev), cfg.conv)
                 for v in (xc, yc)]
    tau_equal = all(torch.equal(a, b.cpu()) for a, b in zip(taus, taus_card))
    states = {d: engine.sc_multiply_states(key, *taus, cfg, device=d).cpu()
              for d in (dev, "cpu")}
    shape = (C_CROSS_MULS, cfg.nbit)
    band = torch.zeros(shape, dtype=torch.bool)
    ulp_pulses = 0
    for k, tau in zip(ctr_rng.split(key), taus):
        u = ctr_rng.uniform(k, shape)
        p_cpu = physics.p_unswitched(tau, physics.I_C_UA)
        p_card = physics.p_unswitched(tau.to(dev), physics.I_C_UA).cpu()
        ulp_pulses += int((p_cpu != p_card).sum())
        lo = torch.minimum(p_cpu, p_card)[:, None]
        hi = torch.maximum(p_cpu, p_card)[:, None]
        band |= (u >= lo) & (u < hi)
    diff = states[dev] != states["cpu"]
    counts = dict(cuda_lib.launches)
    rec = dict(
        fig7a=fig7a,
        fig7b_sigma_by_nbit=s_nbit,
        fig7b_ratio_per_4x_nbit=[s_nbit[256] / s_nbit[1024],
                                 s_nbit[1024] / s_nbit[4096]],
        fig7b_sigma_by_tau_y=s_tau,
        fig8a_sigma_by_sigma_ic=s_ic,
        fig8b_sc_sigma=s_sc,
        fig8b_log_sigma=s_log,
        statistics_s=stats_s,
        big_muls=C_BIG_MULS,
        big_cells=C_BIG_MULS * cfg.nbit,
        big_ms=big_ms,
        big_max_memory_allocated=big_peak,
        big_mean_err=float(err.mean()),
        big_err_sigma=_sigma(err),
        cross_muls=C_CROSS_MULS,
        cross_tau_bit_equal=tau_equal,
        cross_ulp_pulses=ulp_pulses,
        cross_band_cells=int(band.sum()),
        cross_differing_cells=int(diff.sum()),
        launches=counts,
        wall_s=time.perf_counter() - t0,
    )
    emit("cell_model_c", **rec)
    r1, r2 = rec["fig7b_ratio_per_4x_nbit"]
    checks = [
        (0.013 < fig7a["sigma"] < 0.019, "Fig. 7a sigma"),
        (abs(fig7a["mean"] - fig7a["p_true"]) < 0.002, "Fig. 7a mean"),
        (1.6 < r1 < 2.5 and 1.6 < r2 < 2.5, "Fig. 7b sigma vs nbit"),
        (max(s_tau.values()) / min(s_tau.values()) < 1.6,
         "Fig. 7b sigma vs tau_Y"),
        (s_ic[0.10] < 1.5 * s_ic[0.0] and s_ic[0.05] < 1.5 * s_ic[0.0],
         "Fig. 8a sigma vs sigma(I_c)"),
        (s_sc[0.10] < 2.0 * s_sc[0.04], "Fig. 8b SC sigma"),
        (s_log[0.10] > 2.0 * s_log[0.04], "Fig. 8b log-multiplier sigma"),
        (s_log[0.10] > 3.0 * s_sc[0.10], "Fig. 8b log-multiplier vs SC"),
        # 65,536 MULs: unbiased, and the error's sigma under the
        # binomial bound of one MUL (sqrt(1/4 / 1024))
        (abs(rec["big_mean_err"]) < 3 * 0.5 / math.sqrt(1024 * C_BIG_MULS),
         "65,536 MULs biased"),
        (0 < rec["big_err_sigma"] < 0.5 / math.sqrt(1024), "65,536 MULs"),
        (tau_equal, "operand_to_tau differs between card and CPU"),
        (not bool((diff & ~band).any()),
         "card and CPU states differ outside the ulp bands"),
        (not any(counts.values()), f"a kernel launched: {counts}"),
    ]
    for ok, what in checks:
        if not ok:
            raise AssertionError(f"cell_model_c: {what}")
    return rec


# ---------------------------------------------------------------------------
# Phase M: the MoE family at moonshot-v1-16b-a3b's full width
# ---------------------------------------------------------------------------

M_PROMPT = 8  # one prefill chunk
M_NEW = 2  # a prefill tick, then one decode tick (traced)
M_TRACED_TICK = 1


def _moe_params(cfg, device, dtype):
    from repro_torch.models import lm, params

    gen = torch.Generator(device=device).manual_seed(0)
    return params.init_params(lm.lm_param_specs(cfg), gen, device, dtype)


def moe_kernel1_plan(cfg, slots: int, experts=None) -> dict:
    """Kernel 1's launches and SC MULs in one decode tick of the paged
    engine at width 1: per layer wq / wk / wv / wo, the router, and one
    launch per expert for wi and for wo over ``slots x capacity`` rows
    (every capacity slot, empty or not, as the reference runs them); the
    unembed once.  Live expert rows: ``slots x top_k`` (capacity 8 holds
    every token of a width-1 tick).  The launch count is also a
    prefill's; with ``experts`` (the block a rank runs under the
    expert-parallel layout) it is that rank's (the MULs stay the whole
    layout's)."""
    from repro_torch.models import moe

    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    ran = e if experts is None else experts
    hd, h, kvh = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    rows = slots * moe.capacity(cfg, 1)
    per_row = d * 2 * f + f * d
    attn = slots * (d * h * hd + 2 * d * kvh * hd + h * hd * d)
    expert = e * rows * per_row
    live = slots * cfg.top_k * per_row
    layer = attn + slots * d * e + expert
    total = cfg.n_layers * layer + slots * d * cfg.vocab
    return dict(
        launches=cfg.n_layers * (4 + 1 + 2 * ran) + 1,
        sc_muls=total,
        expert_muls=cfg.n_layers * expert,
        empty_slot_muls=cfg.n_layers * (expert - live),
        empty_slot_share=cfg.n_layers * (expert - live) / total,
    )


def moe_phase(layers: int) -> dict:
    """Phase M: moonshot-v1-16b-a3b at its published width, depth cut to
    ``layers``, random bf16 weights from seed 0.  The bit-exact half
    (``pallas_bitexact`` -> kernel 1 in row-key mode, ``fused_sc``
    attention -> kernel 3, the paged engine, 1 slot, one greedy request
    of 8 prompt tokens and 2 new) traces its decode tick: kernel 1's
    launches must be the plan's and kernel 3's per call the attention
    plan's.  The exact half (float32, ``fused`` attention -> kernel 2,
    2 slots): the paged engine's greedy tokens equal the fixed-slot
    engine's for prompts of 12 and 8 tokens, 4 new each.  Then both MoE
    SMOKE configs on ``pallas_bitexact`` on the card and on the CPU:
    equal tokens."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.params import tree_leaves
    from repro_torch.serve import Request, ServeOptions, build_engine

    base = get_config("moonshot-v1-16b-a3b").replace(n_layers=layers)
    cfg = base.replace(sc_backend="pallas_bitexact", sc_nbit=1024,
                       paged_attn="fused_sc")
    t0 = time.perf_counter()
    params = _moe_params(cfg, "cuda", cfg.param_dtype)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(v.numel() for v in tree_leaves(params))
    rng = np.random.default_rng(0)
    prompt = rng.integers(3, cfg.vocab, M_PROMPT).tolist()
    opts = ServeOptions(paged=True, slots=1, block_size=16,
                        prefill_chunk=M_PROMPT, max_len=32)
    counts, tick_ms, _, trace = serve_phase(
        "serve_m", cfg, opts, [prompt], M_NEW, params,
        ("sc_fused", "paged_attention_fused_sc"), traced_tick=M_TRACED_TICK,
    )
    plan = moe_kernel1_plan(cfg, opts.slots)
    k1_ms, k1_n = kernel_ms(trace, "sc_fused_kernel")
    att_ms, att_n = kernel_ms(trace, "paged_attn_")
    aplan = pa.paged_attention_plan(
        opts.slots, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, 1,
        cfg.resolved_head_dim, -(-opts.max_len // opts.block_size),
        opts.block_size, cfg.sc_nbit,
    )
    bitexact = dict(
        params=n_params,
        init_s=init_s,
        tick_ms=tick_ms,
        traced_tick=M_TRACED_TICK,
        host_ms=trace["wall_ms"],
        device_ms=trace["device_ms"],
        kernel1_ms=k1_ms,
        kernel1_launches=k1_n,
        kernel1_plan=plan,
        kernel1_ns_per_mul=k1_ms * 1e6 / plan["sc_muls"],
        attention_ms=att_ms,
        attention_launches=att_n,
        attention_launches_per_call=att_n / cfg.n_layers,
        attention_plan_launches=aplan.launches,
        top=_top(trace),
        launches=counts,
    )
    emit("serve_m_trace", **bitexact)
    if k1_n != plan["launches"]:
        raise AssertionError(f"serve_m: {k1_n} kernel-1 launches in the "
                             f"traced tick, {plan['launches']} planned")
    if att_n != aplan.launches * cfg.n_layers:
        raise AssertionError(f"serve_m: {att_n} attention launches")
    del params
    torch.cuda.empty_cache()

    # the exact half: paged == fixed-slot tokens (the reference's
    # invariant, tests/test_serve_zoo.py), kernel 2 on the paged side
    cfg32 = base.replace(param_dtype=torch.float32, act_dtype=torch.float32,
                         sc_backend="exact", paged_attn="fused")
    params = _moe_params(cfg32, "cuda", torch.float32)
    prompts = [rng.integers(3, cfg.vocab, n).tolist() for n in (12, 8)]
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    paged_opts = ServeOptions(paged=True, slots=2, block_size=16,
                              prefill_chunk=8, max_len=32)
    _, paged_tok, paged_ms, _ = serve(params, cfg32, paged_opts, prompts, 4,
                                      "cuda")
    exact_counts = dict(cuda_lib.launches)
    eng = build_engine(params, cfg32, ServeOptions(slots=2, max_len=32),
                       device="cuda")
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=4))
    t1 = time.perf_counter()
    fixed_tok = {r.rid: list(r.generated) for r in eng.run_until_drained()}
    torch.cuda.synchronize()
    exact = dict(
        paged_tokens=paged_tok,
        fixed_tokens=fixed_tok,
        paged_tick_ms=paged_ms,
        fixed_s=time.perf_counter() - t1,
        launches=exact_counts,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
    )
    emit("serve_m_exact", **exact)
    del params, eng
    torch.cuda.empty_cache()
    if paged_tok != fixed_tok:
        raise AssertionError("serve_m: paged tokens != fixed-slot tokens")
    if exact_counts.get("paged_attention_fused", 0) <= 0:
        raise AssertionError("serve_m: kernel paged_attention_fused never "
                             "launched")
    cross = moe_cross_device()
    return dict(bitexact=bitexact, exact=exact, cross=cross,
                counts_bitexact=counts, counts_exact=exact_counts)


M_CROSS_LAYERS = 1  # of the SMOKE configs' 2: cut to make room for TM-e


def moe_cross_device() -> dict:
    """Both MoE SMOKE configs (narrowed as the CPU parity tests run
    them, M_CROSS_LAYERS deep) on ``pallas_bitexact`` with ``fused_sc``
    attention through the paged engine, on the card and on the CPU:
    equal tokens."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.serve import ServeOptions

    out = {}
    for arch in ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b"):
        cfg = get_smoke_config(arch).replace(
            n_layers=M_CROSS_LAYERS,
            d_model=32, d_ff=48, vocab=128, param_dtype=torch.float32,
            act_dtype=torch.float32, sc_backend="pallas_bitexact",
            sc_nbit=32, paged_attn="fused_sc",
        )
        rng = np.random.default_rng(0)
        prompts = [rng.integers(3, cfg.vocab, n).tolist() for n in (6, 9)]
        opts = ServeOptions(paged=True, slots=2, max_len=24, block_size=4,
                            prefill_chunk=4)
        toks = {}
        for device in ("cuda", "cpu"):
            params = _qwen_params(cfg, device)
            _, toks[device], _, _ = serve(params, cfg, opts, prompts, 3,
                                          device)
        out[arch] = toks
        emit("serve_m_cross_device", arch=arch, cuda=toks["cuda"],
             cpu=toks["cpu"])
        if toks["cuda"] != toks["cpu"]:
            raise AssertionError(f"{arch}: tokens differ between card and "
                                 "CPU")
    return out


# ---------------------------------------------------------------------------
# Phases S and H: the SSM family at mamba2-370m's full width and the
# hybrid family at zamba2-7b's
# ---------------------------------------------------------------------------

S_PROMPTS = (12, 8)  # phase A's prompt lengths, 4 new tokens each
S_NEW = 4
S_TRACED_TICK = 3  # both rows decoding (ticks 0 and 1 prefill)
H_PROMPT = 8  # one prefill chunk
H_NEW = 2  # a prefill tick, then one decode tick (traced)
H_TRACED_TICK = 1


def ssm_layer_muls(cfg) -> int:
    """SC MULs of one Mamba2 layer for one token: wz, wx (d -> d_inner),
    wB, wC (d -> state), wdt (d -> heads) and out (d_inner -> d)."""
    d, di = cfg.d_model, cfg.d_inner
    return d * 2 * di + 2 * d * cfg.ssm_state + d * cfg.ssm_heads + di * d


def zoo_kernel1_plan(cfg, slots: int) -> dict:
    """Kernel 1's launches and SC MULs in one width-1 decode tick of the
    paged engine over ``slots`` rows: six projections an SSM layer (the
    recurrent feed runs one token a step) and, for the hybrid, wq / wk /
    wv / wo and the MLP's wi / wo a shared invocation; the unembed
    once."""
    from repro_torch.models import lm

    d = cfg.d_model
    layers_ = lm.n_backbone_layers(cfg)
    inv = lm.n_shared_invocations(cfg)
    hd, h, kvh = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    shared = (d * h * hd + 2 * d * kvh * hd + h * hd * d
              + d * 2 * cfg.d_ff + cfg.d_ff * d)
    per_row = layers_ * ssm_layer_muls(cfg) + inv * shared + d * cfg.vocab
    return dict(launches=6 * layers_ + 6 * inv + 1,
                sc_muls=slots * per_row,
                ssm_layer_muls=ssm_layer_muls(cfg),
                shared_muls=shared if inv else 0,
                unembed_muls=d * cfg.vocab)


def traced_launches(trace: dict, name: str, want: int, what: str) -> int:
    """The wrappers' count of ``name`` in a traced tick, which must be
    ``want``: the count decides, so a kernel the trace missed cannot
    fail the run, nor one it shows but the path never launched pass."""
    got = trace["counted"].get(name, 0)
    if got != want:
        raise AssertionError(f"{what}: {got} {name} launches in the traced "
                             f"tick, {want} planned")
    return got


def zoo_bitexact(name, cfg, opts, prompts, max_new, traced_tick, expect):
    """Serve ``prompts`` on ``pallas_bitexact`` (kernel 1 for every
    projection and the unembed) with random bf16 weights from seed 0,
    trace one decode tick and hold kernel 1's launches in it to the
    plan.  Returns (record, tokens, phase counts, trace, params)."""
    from repro_torch.models.params import tree_leaves

    t0 = time.perf_counter()
    params = _moe_params(cfg, "cuda", cfg.param_dtype)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(v.numel() for v in tree_leaves(params))
    counts, tick_ms, eng, trace = serve_phase(
        name, cfg, opts, prompts, max_new, params, expect,
        traced_tick=traced_tick,
    )
    plan = zoo_kernel1_plan(cfg, opts.slots)
    k1_ms, k1_n = kernel_ms(trace, "sc_fused_kernel")
    k1 = traced_launches(trace, "sc_fused", plan["launches"], name)
    rec = dict(
        params=n_params,
        init_s=init_s,
        tick_ms=tick_ms,
        traced_tick=traced_tick,
        host_ms=trace["wall_ms"],
        device_ms=trace["device_ms"],
        kernel1_launches=k1,
        kernel1_trace_launches=k1_n,
        kernel1_ms=k1_ms if k1_n == k1 else None,
        kernel1_plan=plan,
        kernel1_ns_per_mul=(k1_ms * 1e6 / plan["sc_muls"]
                            if k1_n == k1 else None),
        counted=trace["counted"],
        top=_top(trace),
    )
    toks = {r.rid: list(r.generated) for r in eng.finished}
    return rec, toks, counts, trace, params


def zoo_exact(name, base, prompts, max_new, paged_attn) -> dict:
    """The exact half (float32, ``exact``): the paged engine's greedy
    tokens must equal the fixed-slot engine's (the reference's
    invariant, tests/test_serve_zoo.py)."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.serve import Request, ServeOptions, build_engine

    cfg32 = base.replace(param_dtype=torch.float32, act_dtype=torch.float32,
                         sc_backend="exact", paged_attn=paged_attn)
    params = _moe_params(cfg32, "cuda", torch.float32)
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    paged_opts = ServeOptions(paged=True, slots=2, block_size=16,
                              prefill_chunk=8, max_len=32)
    _, paged_tok, paged_ms, _ = serve(params, cfg32, paged_opts, prompts,
                                      max_new, "cuda")
    counts = dict(cuda_lib.launches)
    eng = build_engine(params, cfg32, ServeOptions(slots=2, max_len=32),
                       device="cuda")
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=max_new))
    t1 = time.perf_counter()
    fixed_tok = {r.rid: list(r.generated) for r in eng.run_until_drained()}
    torch.cuda.synchronize()
    rec = dict(
        paged_tokens=paged_tok,
        fixed_tokens=fixed_tok,
        paged_tick_ms=paged_ms,
        fixed_s=time.perf_counter() - t1,
        launches=counts,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
    )
    emit(name, **rec)
    del params, eng
    torch.cuda.empty_cache()
    if paged_tok != fixed_tok:
        raise AssertionError(f"{name}: paged tokens != fixed-slot tokens")
    return rec


def zoo_cross_device(arch: str) -> dict:
    """The SMOKE config (narrowed as the CPU parity tests run it) on
    ``pallas_bitexact`` through the paged engine, on the card and on
    the CPU: equal tokens (the hybrid with ``fused_sc`` attention)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.serve import ServeOptions

    attn = "fused_sc" if arch == "zamba2-7b" else "unfused"
    cfg = get_smoke_config(arch).replace(
        d_model=32, vocab=128, param_dtype=torch.float32,
        act_dtype=torch.float32, sc_backend="pallas_bitexact", sc_nbit=64,
        paged_attn=attn,
    )
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab, n).tolist() for n in (6, 9)]
    opts = ServeOptions(paged=True, slots=2, max_len=24, block_size=4,
                        prefill_chunk=4)
    toks = {}
    for device in ("cuda", "cpu"):
        params = _qwen_params(cfg, device)
        _, toks[device], _, _ = serve(params, cfg, opts, prompts, 3, device)
    emit("zoo_cross_device", arch=arch, cuda=toks["cuda"], cpu=toks["cpu"])
    if toks["cuda"] != toks["cpu"]:
        raise AssertionError(f"{arch}: tokens differ between card and CPU")
    return toks


def ssm_phase(layers: int) -> dict:
    """Phase S: mamba2-370m at its published width (d_model 1024, 32
    SSM heads of 64, state 128, vocab 50,280, tied), depth cut to
    ``layers``, random bf16 weights from seed 0.  The bit-exact half
    (``pallas_bitexact`` at nbit 1024, paged, 2 slots, block 16, chunk
    8, phase A's prompt lengths): decode tick 3 traced, kernel 1's
    launches the plan's (6 a layer and the unembed), no attention
    kernel; the same prompts at chunk 4 give the same tokens.  The exact
    half: paged tokens equal fixed-slot tokens.  Then the SMOKE config
    on the card and on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.serve import ServeOptions

    base = get_config("mamba2-370m").replace(n_layers=layers)
    cfg = base.replace(sc_backend="pallas_bitexact", sc_nbit=1024)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab, n).tolist() for n in S_PROMPTS]
    opts = ServeOptions(paged=True, slots=2, block_size=16, prefill_chunk=8,
                        max_len=64)
    rec, toks, counts, trace, params = zoo_bitexact(
        "serve_s", cfg, opts, prompts, S_NEW, S_TRACED_TICK, ("sc_fused",))
    attn = {k: v for k, v in counts.items() if k.startswith("paged_")}
    rec["attention_launches"] = attn
    emit("serve_s_trace", **rec)
    if attn or kernel_ms(trace, "paged_attn_")[1]:
        raise AssertionError(f"serve_s: attention kernels launched: {attn}")
    _, toks4, ticks4, _ = serve(params, cfg, opts.replace(prefill_chunk=4),
                                prompts, S_NEW, "cuda")
    emit("serve_s_chunk4", tokens=toks4, tick_ms=ticks4)
    if toks4 != toks:
        raise AssertionError("serve_s: tokens at chunk 4 != chunk 8")
    del params
    torch.cuda.empty_cache()
    exact = zoo_exact("serve_s_exact", base, prompts, S_NEW, "unfused")
    cross = zoo_cross_device("mamba2-370m")
    return dict(bitexact=rec, exact=exact, cross=cross, counts=counts,
                counts_exact=exact["launches"])


def hybrid_phase(groups: int) -> dict:
    """Phase H: zamba2-7b at its published width (d_model 3584, 112 SSM
    heads of 64, state 64, 32 heads of 112 (MHA), d_ff 14,336 SwiGLU,
    vocab 32,000, untied), ``groups`` groups of 2 SSM layers and one
    shared invocation, random bf16 weights from seed 0.  The bit-exact
    half (``pallas_bitexact`` + ``fused_sc``, paged, 1 slot, one greedy
    request of 8 prompt tokens and 2 new): the decode tick traced,
    kernel 1's launches the plan's (18 a group and the unembed) and
    kernel 3 one call an invocation, its device launches the attention
    plan's.  The exact half (``fused`` -> kernel 2): paged tokens equal
    fixed-slot tokens.  Then the SMOKE config on the card and on the
    CPU."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve import ServeOptions

    base = get_config("zamba2-7b").replace(n_layers=3 * groups)
    cfg = base.replace(sc_backend="pallas_bitexact", sc_nbit=1024,
                       paged_attn="fused_sc")
    rng = np.random.default_rng(0)
    prompt = rng.integers(3, cfg.vocab, H_PROMPT).tolist()
    opts = ServeOptions(paged=True, slots=1, block_size=16,
                        prefill_chunk=H_PROMPT, max_len=32)
    rec, _, counts, trace, params = zoo_bitexact(
        "serve_h", cfg, opts, [prompt], H_NEW, H_TRACED_TICK,
        ("sc_fused", "paged_attention_fused_sc"))
    del params
    torch.cuda.empty_cache()
    aplan = pa.paged_attention_plan(
        opts.slots, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, 1,
        cfg.resolved_head_dim, -(-opts.max_len // opts.block_size),
        opts.block_size, cfg.sc_nbit,
    )
    calls = traced_launches(trace, "paged_attention_fused_sc", groups,
                            "serve_h")
    att_ms, att_n = kernel_ms(trace, "paged_attn_")
    rec.update(
        attention_calls=calls,
        attention_plan_launches=aplan.launches,
        attention_trace_launches=att_n,
        attention_ms=att_ms if att_n == aplan.launches * calls else None,
        attention_trace_gap=att_n != aplan.launches * calls,
    )
    emit("serve_h_trace", **rec)
    prompts = [rng.integers(3, cfg.vocab, n).tolist() for n in S_PROMPTS]
    exact = zoo_exact("serve_h_exact", base, prompts, S_NEW, "fused")
    if exact["launches"].get("paged_attention_fused", 0) <= 0:
        raise AssertionError("serve_h: kernel paged_attention_fused never "
                             "launched")
    cross = zoo_cross_device("zamba2-7b")
    return dict(bitexact=rec, exact=exact, cross=cross, counts=counts,
                counts_exact=exact["launches"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2, help="depth (<= 24)")
    ap.add_argument("--moe-layers", type=int, default=1,
                    help="phase M's depth (<= 48)")
    ap.add_argument("--ssm-layers", type=int, default=4,
                    help="phase S's depth (<= 48)")
    ap.add_argument("--hybrid-groups", type=int, default=1,
                    help="phases H's and TH's groups of 2 SSM layers and "
                    "one shared invocation (<= 27)")
    ap.add_argument("--audio-layers", type=int, default=2,
                    help="phase TA's depth (<= 48)")
    # one rank of phases FM and TM (the script starts its ranks itself)
    ap.add_argument("--mesh-rank", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if args.mesh_rank:
        return mesh_rank(args.mesh_rank, args.layers)
    if not 1 <= args.layers <= 24:
        raise SystemExit("--layers must be in 1..24")
    if not 1 <= args.moe_layers <= 48:
        raise SystemExit("--moe-layers must be in 1..48")
    if not 1 <= args.ssm_layers <= 48:
        raise SystemExit("--ssm-layers must be in 1..48")
    if not 1 <= args.hybrid_groups <= 27:
        raise SystemExit("--hybrid-groups must be in 1..27")
    if not 1 <= args.audio_layers <= 48:
        raise SystemExit("--audio-layers must be in 1..48")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card, rates = environment()
    fused = check_sc_fused(rates)
    attn = check_attention(rates)
    mac = check_sc_mac(rates)
    mac_train = check_sc_mac_train(rates)
    muls = check_sc_mul(rates)
    tiles = autotune_phase()

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
        lookups=True,
    )
    attention_trace(trace_a, cfg, opts, "serve_a_trace")
    at_hits = tick_lookups(trace_a["autotune"])
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
    serve_f = fixed_slot_phase(params, cfg, prompts, 4)
    serve_ft = fleet_phase(params, cfg, opts, prompts, tokens_a, 4)
    fm_ranks, tm_ranks, mesh_seconds = mesh_ranks(prompts, args.layers)
    serve_fm = mesh_phase(params, cfg, prompts, serve_f["tokens"], card,
                          fm_ranks, mesh_seconds)
    val = validation_phase(params, cfg)
    faulty = faulty_serve_phase(
        params, cfg.replace(sc_backend="exact", paged_attn="unfused"),
        prompts,
    )
    del params
    torch.cuda.empty_cache()
    cross_device()
    faulty_cross_device()
    cell_model_phase()
    serve_m = moe_phase(args.moe_layers)
    serve_s = ssm_phase(args.ssm_layers)
    serve_h = hybrid_phase(args.hybrid_groups)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        train = train_phase(args.layers, workdir)
        torch.cuda.empty_cache()
        train_tm = train_mesh_phase(
            args.layers, card, {r["step"]: r["loss"] for r in train["steps"]},
            tm_ranks, mesh_seconds)
        families = {
            "ts": family_train_phase("ts", "mamba2-370m", args.ssm_layers,
                                     4, 512, workdir),
            "th": family_train_phase("th", "zamba2-7b",
                                     3 * args.hybrid_groups, 2, 512,
                                     workdir),
            "ta": family_train_phase("ta", "musicgen-large",
                                     args.audio_layers, 8, 64, workdir),
        }
        for arch in CROSS_TRAIN_ARCHS:
            train_cross_device(arch, workdir)
    cost_phase(args.layers, card)
    torch.cuda.empty_cache()
    examples_phase()

    serving = (
        counts_a,
        counts_b,
        serve_p["launches"],
        serve_f["launches"],
        serve_ft["launches"],
        serve_fm["launches"],
        serve_fm["tp"]["a"]["launches"]["tp"],
        serve_fm["ep"]["b"]["launches"][0],
        serve_fm["counts_one"],
        faulty["counts"],
        serve_m["counts_bitexact"],
        serve_m["counts_exact"],
        serve_s["counts"],
        serve_s["counts_exact"],
        serve_h["counts"],
        serve_h["counts_exact"],
    )
    launches = {
        k: sum(c.get(k, 0) for c in serving)
        for k in set().union(*serving)
    }
    mlp = fused["mlp_wi"]
    per_call = fused["wk_prefill_per_call"]
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
            shape="rows mode M=2 K=896 N=9728 nbit=1024 (mlp_wi); "
            "launches from phases A, B, P, F (one key a call), FT, FM "
            "(rank 0 of the mesh and the world of one), FM-t (a) (rank "
            "0, the in-layer layout), FM-e (b) (rank 0, the "
            "expert-parallel prefill), M, S and H; "
            "mesh: a rank's block on phase FM's 2 x 2 mesh, one key a "
            "call",
            mesh={
                case: {k: fused[case][k] for k in
                       ("shape", "n_orig", "ms", "plain_ms", "plain_cols",
                        "bound_ms")}
                for case in ("fm_mlp_wi", "fm_mlp_wo", "fm_prefill_wq",
                             "fm_unembed_window")
            },
            moe_expert={
                k: fused["moe_wi"][k]
                for k in ("shape", "ms", "plain_ms", "plain_cols", "bound_ms")
            },
            per_call={
                k: per_call[k] for k in ("shape", "ms", "plain_ms", "bound_ms")
            },
            per_call_case="wk_prefill_per_call: M=12 K=896 N=128, one key "
            "a call (phase F's prefill of A's first prompt at wk)",
            ssm={
                case: {k: fused[case][k] for k in
                       ("shape", "ms", "plain_ms", "plain_cols", "bound_ms")}
                | {"ns_per_mul": fused[case]["ms"] * 1e6
                   / fused[case]["sc_muls"]}
                for case in ("ssm_wz", "ssm_wdt", "ssm_out", "hyb_wz",
                             "hyb_out")
            },
            autotune={
                case: {k: tiles[case][k] for k in
                       ("shape", "candidates", "heuristic", "heuristic_ms",
                        "best", "best_ms", "shipped", "shipped_ms")}
                for case, *_ in AT_FUSED_SHAPES
            },
            autotune_hits_a_tick=at_hits,
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
            "V's launches; launches from phase V; mesh_shard: a rank's "
            "block of phase FM's sharded wq call, whole",
            mesh_shard={k: muls["fm_wq_shard"][k] for k in
                        ("shape", "ms", "plain_ms", "bound_ms", "bound_by")},
        ),
        dict(
            name="sc_mac_fused",
            route="cuda",
            source="src/repro_torch/csrc/sc_mac.cu",
            replaces="src/repro/kernels/sc_mac.py:101",
            launches=train["counts"].get("sc_mac_fused", 0)
            + train_tm["launches"].get("sc_mac_fused", 0)
            + sum(f["launches"].get("sc_mac_fused", 0)
                  for f in families.values()),
            max_abs_err=mac["unembed"]["max_abs_err"],
            ms=mac["unembed"]["ms"],
            plain_ms=mac["unembed"]["plain_ms"],
            bound_ms=mac["unembed"]["bound_ms"],
            bound_by=mac["unembed"]["bound_by"],
            bound_fp32_ms=mac["unembed"]["bound_fp32_ms"],
            library_ms=mac["unembed"]["library_ms"],
            shape="M=512 K=896 N=151936 f32 on the operand grid, w the "
            "K-major view table.T (tied unembed); max_abs_err relative to "
            "max |out|; bound 3xTF32, 5 products a pair on the grid; "
            "launches from phases T, TM (rank 0: TM-a, TM-t and TM-cp's "
            "in-layer run, TM-e's expert-parallel run), TS, TH and TA; "
            "train_shapes: the family phases' shapes (ts_ / th_ / ta_) and "
            "a rank's blocks of phase TM (tm_), each within 1e-5 of its "
            "plain version; mesh_steps: phase TM's steps a rank",
            train_shapes={
                case: {k: r[k] for k in ("shape", "max_abs_err", "ms",
                                         "plain_ms", "bound_ms",
                                         "library_ms")}
                for case, r in mac_train.items()
            },
            family_steps={
                tag: {k: f[k] for k in ("median_step_ms", "launches_per_step",
                                        "idle_share")}
                for tag, f in families.items()
            },
            mesh_steps={k: train_tm[k] for k in (
                "median_step_ms", "launches_per_step", "kernel5_plan",
                "allreduce_share", "merge_share")},
        ),
        dict(
            name="sc_mac_reduce",
            route="cuda",
            source="src/repro_torch/csrc/sc_mac.cu",
            replaces="src/repro/kernels/sc_mac.py:101",
            launches=train["counts"].get("sc_mac_reduce", 0)
            + train_tm["launches"].get("sc_mac_reduce", 0)
            + sum(f["launches"].get("sc_mac_reduce", 0)
                  for f in families.values()),
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
            library_ms=mac["prng"]["library_ms"],
            shape="M=512 K=896 N=151936 f32 on the operand grid, taken on "
            "the general route (bound 9 products a pair); no path of the "
            "package runs it; max_abs_err relative to max |out|; "
            "library_ms three float32 torch.matmul + the epilogue with "
            "torch.randn's noise, timed in turns with the kernel",
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
