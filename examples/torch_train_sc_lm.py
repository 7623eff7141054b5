"""End-to-end driver on the PyTorch/CUDA port: train an LM whose every
matmul runs through the paper's SC engine (moment-matched substrate),
under the fault-tolerance supervisor with checkpointing.

Default is a ~12M-param model for 200 steps (the reference example's
defaults).  The ~100M configuration of the reference's EXPERIMENTS.md run:

    PYTHONPATH=src python examples/torch_train_sc_lm.py --d-model 512 \\
        --layers 8 --d-ff 2048 --vocab 32768 --steps 300 --batch 8 \\
        --seq 256
    PYTHONPATH=src python examples/torch_train_sc_lm.py --device cpu \\
        --steps 20                                 # plain versions, CPU

Compares the SC substrate against the exact baseline over the same data
(the paper's claim: SC noise does not break the MAC consumer; here the
strongest consumer test we can pose is "the LM still trains").
Checkpoints go to ``--ckpt-dir``, by default a temporary directory that
is removed at exit.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.data import SyntheticLMData, make_batch
from repro_torch.ft import Supervisor
from repro_torch.models.params import tree_leaves
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, make_train_step, train_state_init


def build_cfg(args, sc_backend: str) -> ModelConfig:
    return ModelConfig(
        name=f"sc-lm-{sc_backend}", family="dense", n_layers=args.layers,
        d_model=args.d_model, n_heads=args.d_model // 64 or 2,
        n_kv_heads=max((args.d_model // 64 or 2) // 2, 1),
        d_ff=args.d_ff, vocab=args.vocab, sc_backend=sc_backend,
        sc_nbit=args.nbit, attn_impl="full", remat="none",
        param_dtype=torch.float32, act_dtype=torch.float32)


def run(cfg: ModelConfig, args, tag: str, device, ckpt_dir: str):
    tcfg = TrainConfig(optimizer=AdamWConfig(
        lr=args.lr, warmup_steps=args.steps // 10,
        total_steps=args.steps))
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=args.seq,
                           global_batch=args.batch, seed=0)
    state = train_state_init(0, cfg, tcfg, device=device)
    n_params = sum(v.numel() for v in tree_leaves(state["params"]))
    print(f"[{tag}] {n_params / 1e6:.1f}M params, "
          f"sc_backend={cfg.sc_backend}, on {device}")
    step = make_train_step(cfg, tcfg)
    sup = Supervisor(ckpt_dir=f"{ckpt_dir}/{tag}",
                     ckpt_every=max(args.steps // 4, 1))
    t0 = time.time()
    losses = []

    def logged(state, batch):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))  # waits for the device
        i = len(losses)
        if i % 20 == 0 or i == 1:
            print(f"[{tag}] step {i:4d} loss {losses[-1]:.4f} "
                  f"({(time.time() - t0) / i:.2f}s/step)", flush=True)
        return state, m

    state, hist = sup.run(state, logged, args.steps,
                          make_batch=lambda i: make_batch(data, i))
    first = sum(hist["loss"][:10]) / min(10, len(hist["loss"]))
    last = sum(hist["loss"][-10:]) / min(10, len(hist["loss"]))
    print(f"[{tag}] loss {first:.4f} -> {last:.4f} "
          f"({time.time() - t0:.0f}s total)")
    return first, last


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-ff", type=int, default=1024)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--nbit", type=int, default=1024)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint root (default: a temporary directory)")
    ap.add_argument("--skip-baseline", action="store_true")
    ap.add_argument("--sc-backend", default="moment",
                    help="any backend registered in repro_torch.sc")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions of the kernels)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    with tempfile.TemporaryDirectory(prefix="sc_lm_ckpt_") as tmp:
        ckpt_dir = args.ckpt_dir or tmp
        f_sc, l_sc = run(build_cfg(args, args.sc_backend), args, "sc",
                         device, ckpt_dir)
        if not args.skip_baseline:
            f_ex, l_ex = run(build_cfg(args, "exact"), args, "exact",
                             device, ckpt_dir)
            print(f"\nSC substrate:   {f_sc:.4f} -> {l_sc:.4f}")
            print(f"exact baseline: {f_ex:.4f} -> {l_ex:.4f}")
            print(f"SC loss penalty at end: {l_sc - l_ex:+.4f} "
                  "(paper: SC error is zero-centered; training tolerates "
                  "it)")


if __name__ == "__main__":
    main()
