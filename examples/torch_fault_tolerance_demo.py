"""Fault-tolerance demo on the PyTorch/CUDA port: train with an injected
worker crash, recover from the latest checkpoint, and verify the run
converges to the exact same state as an uninterrupted run (deterministic
data pipeline + checkpoint replay).

    PYTHONPATH=src python examples/torch_fault_tolerance_demo.py  # card
    PYTHONPATH=src python examples/torch_fault_tolerance_demo.py \\
        --device cpu

Both runs checkpoint into a temporary directory that is removed at exit.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticLMData, make_batch
from repro_torch.ft import FaultInjector, Supervisor
from repro_torch.models.params import tree_leaves
from repro_torch.train import TrainConfig, make_train_step, train_state_init

STEPS, CKPT_EVERY, FAIL_AT = 20, 5, 13


def train(tag: str, ckpt_dir: str, device, injector=None):
    cfg = get_smoke_config("qwen2-0.5b").replace(
        param_dtype=torch.float32, act_dtype=torch.float32)
    tcfg = TrainConfig()
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=32, global_batch=4)
    state = train_state_init(0, cfg, tcfg, device=device)
    step = make_train_step(cfg, tcfg)
    sup = Supervisor(ckpt_dir=ckpt_dir, ckpt_every=CKPT_EVERY,
                     injector=injector)
    state, hist = sup.run(state, step, STEPS,
                          make_batch=lambda i: make_batch(data, i))
    print(f"[{tag}] final loss {hist['loss'][-1]:.4f}, "
          f"recoveries: {hist['recoveries']}")
    return state, hist


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions of the kernels)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    with tempfile.TemporaryDirectory(prefix="ft_demo_") as tmp:
        print(f"run A: {STEPS} uninterrupted steps on {device}")
        clean, _ = train("clean", os.path.join(tmp, "clean"), device)

        print(f"\nrun B: crash injected at step {FAIL_AT} "
              f"(checkpoint every {CKPT_EVERY})")
        crashed, hist = train("crash", os.path.join(tmp, "crash"), device,
                              FaultInjector(fail_at_steps=(FAIL_AT,)))
    if len(hist["recoveries"]) != 1:
        raise AssertionError(f"recoveries: {hist['recoveries']}")

    worst = max(float((a - b).abs().max()) for a, b in
                zip(tree_leaves(clean["params"]),
                    tree_leaves(crashed["params"])))
    print(f"\nmax |param(clean) - param(crashed)| = {worst:.2e}")
    if worst != 0.0:
        raise AssertionError("recovery must replay to the identical state")
    print("recovered run is BIT-IDENTICAL to the uninterrupted run — "
          "checkpoint/restart + deterministic data = exact recovery")


if __name__ == "__main__":
    main()
