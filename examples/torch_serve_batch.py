"""Serve a small model with batched requests through the port's
continuous-batching engine: the inference-side end-to-end driver of the
PyTorch/CUDA port (the paper's target workload is NN inference MACs;
--sc routes every prefill/decode matmul through the SC substrate
registry, any backend).

    PYTHONPATH=src python examples/torch_serve_batch.py --requests 12 \\
        --slots 4                                           # on the card
    PYTHONPATH=src python examples/torch_serve_batch.py --sc   # SC decode
    PYTHONPATH=src python examples/torch_serve_batch.py --sc \\
        --sc-backend pallas_moment                   # fused moment kernel
    PYTHONPATH=src python examples/torch_serve_batch.py --paged \\
        --block-size 8 --max-blocks 48      # paged KV + chunked prefill
    PYTHONPATH=src python examples/torch_serve_batch.py --device cpu

The prompts are the reference example's (``ctr_rng`` is bit-equal to
``jax.random``); the weights are the port's own, from a seeded
``torch.Generator``.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm, params as params_lib
from repro_torch.sc import ctr_rng
from repro_torch.serve import Request, ServeOptions, build_engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--sc", action="store_true",
                    help="route decode matmuls through the SC substrate")
    ap.add_argument("--sc-backend", default=None,
                    help="any backend registered in repro_torch.sc "
                         "(implies --sc; default: moment)")
    ap.add_argument("--paged", action="store_true",
                    help="serve through the paged continuous-batching "
                         "engine (block-pool KV + chunked prefill)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block (--paged)")
    ap.add_argument("--max-blocks", type=int, default=0,
                    help="KV pool size in blocks (--paged; 0 = sized for "
                         "slots x max_len; shrink it to watch evictions)")
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="prompt tokens fed per row per tick (--paged)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions of the kernels)")
    args = ap.parse_args(argv)
    if args.sc_backend:
        args.sc = True
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch).replace(
        param_dtype=torch.float32, act_dtype=torch.float32,
        # a slightly larger smoke config so serving is non-trivial
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, d_ff=512)
    if args.sc:
        cfg = cfg.replace(sc_backend=args.sc_backend or "moment",
                          sc_nbit=1024)

    gen = torch.Generator().manual_seed(0)
    params = params_lib.init_params(lm.lm_param_specs(cfg), gen, device,
                                    cfg.param_dtype)
    engine = build_engine(params, cfg, ServeOptions(
        paged=args.paged, slots=args.slots, max_len=args.max_len,
        block_size=args.block_size, num_blocks=args.max_blocks,
        prefill_chunk=args.prefill_chunk), device=device)

    rng = ctr_rng.prng_key(1)
    for rid in range(args.requests):
        rng, k = ctr_rng.split(rng)
        plen = int(ctr_rng.randint(k, (), 4, 24))
        prompt = ctr_rng.randint(k, (plen,), 3, cfg.vocab).tolist()
        engine.submit(Request(rid=rid, prompt=prompt,
                              max_new_tokens=args.max_new,
                              temperature=args.temperature))

    mode = "paged" if args.paged else "fixed-slot"
    print(f"serving {args.requests} requests on {args.slots} slots "
          f"({mode} continuous batching) on {device}, "
          f"sc={'on' if args.sc else 'off'}")
    t0 = time.time()
    ticks = 0
    while engine.queue or any(engine.active):
        engine.step()
        ticks += 1
        active = sum(r is not None for r in engine.active)
        if ticks % 10 == 0:
            print(f"  tick {ticks:4d}: active={active} "
                  f"queued={len(engine.queue)} done={len(engine.finished)}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    total = sum(len(r.generated) for r in engine.finished)
    print(f"\nserved {len(engine.finished)} requests / {total} tokens in "
          f"{dt:.1f}s = {total / dt:.1f} tok/s "
          f"({ticks} engine ticks, batched decode)")
    if args.paged:
        print(f"  {engine.evictions} evictions; "
              f"{engine.kv.pool.free_blocks} blocks free at drain")
    for r in engine.finished[:3]:
        print(f"  req {r.rid}: {len(r.prompt)}-token prompt -> "
              f"{r.generated[:10]}{'...' if len(r.generated) > 10 else ''}")


if __name__ == "__main__":
    main()
