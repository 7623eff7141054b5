"""Training launcher.

Port of ``repro.launch.train`` on one device: real training of a model
config, every matmul on the configured SC substrate, under the
fault-tolerance supervisor with checkpointing and deterministic data.
Parameters and activations are float32, as in the reference launcher.
Runs on the card unless ``--device cpu`` asks for the plain versions on
the CPU.

    PYTHONPATH=src python -m repro_torch.launch.train --arch paper-sc \\
        --smoke --steps 2 --device cpu

``--layers`` cuts the depth of the chosen config (its widths stay);
``main`` returns ``(state, history)``, where ``history["steps"]`` lists
each step that ran (replays included) with its loss, grad norm, lr and
wall time in ms.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import checkpoint, resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import SyntheticLMData, make_batch
from repro_torch.ft import FaultInjector, Supervisor
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, make_train_step, train_state_init


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument(
        "--smoke", action="store_true", help="use the reduced smoke config"
    )
    ap.add_argument(
        "--layers", type=int, default=None, help="cut the depth to N layers"
    )
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument(
        "--ckpt-dir",
        default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"),
    )
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument(
        "--sc-backend",
        default=None,
        help="SC substrate backend (a name registered in repro_torch.sc: "
        "exact | moment | pallas_moment | pallas_bitexact | pallas_fused)",
    )
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--device",
        default=None,
        help="torch device (default: the card; 'cpu' runs the plain "
        "versions of the kernels)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(param_dtype=torch.float32, act_dtype=torch.float32)
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)
    if args.sc_backend:
        cfg = cfg.replace(sc_backend=args.sc_backend)

    tcfg = TrainConfig(
        optimizer=AdamWConfig(
            lr=args.lr,
            total_steps=args.steps,
            warmup_steps=max(args.steps // 10, 1),
        ),
        microbatches=args.microbatches,
        seed=args.seed,
    )
    data = SyntheticLMData(
        vocab=cfg.vocab,
        seq_len=args.seq,
        global_batch=args.batch,
        seed=args.seed,
    )
    state = train_state_init(args.seed, cfg, tcfg, device=device)
    step_fn = make_train_step(cfg, tcfg)

    start_step = 0
    if args.resume and checkpoint.latest_step(args.ckpt_dir) is not None:
        state, extra, _ = checkpoint.restore(args.ckpt_dir, state)
        start_step = extra["data_step"]
        print(f"resumed from step {start_step}")

    injector = None
    if args.inject_failure_at is not None:
        injector = FaultInjector(fail_at_steps=(args.inject_failure_at,))
    sup = Supervisor(
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, injector=injector
    )

    t0 = time.time()
    steps = []

    def logged_step(state, batch):
        t_step = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])  # waits for the device
        ms = (time.perf_counter() - t_step) * 1e3
        step = int(state["opt"]["step"])
        rec = dict(
            step=step,
            loss=loss,
            grad_norm=float(metrics["grad_norm"]),
            lr=float(metrics["lr"]),
            ms=ms,
        )
        steps.append(rec)
        if step % 5 == 0 or step == 1:
            print(
                f"step {step:5d} loss {loss:.4f} "
                f"gnorm {rec['grad_norm']:.3f} lr {rec['lr']:.2e} "
                f"({(time.time() - t0) / len(steps):.2f}s/step)",
                flush=True,
            )
        return state, metrics

    state, history = sup.run(
        state,
        logged_step,
        args.steps,
        make_batch=lambda step: make_batch(data, step),
        start_step=start_step,
    )
    history["steps"] = steps
    print(
        f"done: first loss {history['loss'][0]:.4f} -> "
        f"last {history['loss'][-1]:.4f}; "
        f"recoveries={len(history['recoveries'])}"
    )
    return state, history


if __name__ == "__main__":
    main()
