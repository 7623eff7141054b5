"""Serving launcher: a serving engine over synthetic requests.

Port of ``repro.launch.serve``.  Runs on the card unless ``--device
cpu`` asks for the plain versions of the kernels on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke \\
        --requests 8 --slots 4 --device cpu      # fixed-slot engine
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --paged \\
        --block-size 8 --max-blocks 64 --device cpu   # paged KV
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --chaos \\
        --device cpu                    # 2-shard fleet, drain/resume
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --paged \\
        --metrics-out metrics.prom --trace-out trace.jsonl --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke \\
        --arch mamba2-370m --device cpu     # SSM (zamba2-7b: hybrid)
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
        --smoke --arch paper-sc --mesh --model-parallel 2 --device cpu

Engine flags are derived from ``serve.ServeOptions`` field metadata
(``serve.add_cli_args``); the launcher adds its workload knobs
(``--arch``, ``--smoke``, ``--requests``, ``--max-new``,
``--temperature``, ``--shared-prefix``), ``--device`` and the output
paths.  Embeddings-frontend archs (musicgen-large) are refused, as the
reference launcher refuses them.  ``--chaos`` serves a 2-shard paged
fleet under ``ft.FleetSupervisor`` with shard 1 degraded at fleet tick
2 (``ChaosMonkey``) and prints the drain / resume ledger.
``--metrics-out`` / ``--trace-out`` turn observability on (the global
``repro_torch.obs`` registry and an installed tracer) and write the
Prometheus exposition (or, for a ``.json`` path, the JSON snapshot) and
the span JSONL after the drain.

``--mesh`` serves the fixed-slot engine on a device mesh of the world's
ranks, ``(data = world / --model-parallel, model = --model-parallel)``
(``launch.mesh.make_local_mesh``): one process per rank, started by
``torchrun``, each holding the whole model and cache and running the
same requests, with every SC call split over the mesh
(``sc.sc_dot_sharded``).  Each rank prints its device and the
process-group backend (NCCL when every rank owns a card, gloo on the
CPU or when ranks share one); only rank 0 prints the rest and writes
the outputs.  Without ``torchrun`` the mesh is the trivial 1 x 1 one.

The prompts come from ``ctr_rng.split`` / ``randint``, bit-equal to
``jax.random``, so the prompt list equals the reference launcher's for
the same seed.  The weights come from this package's ``init_params``
(a ``torch.Generator`` seeded with ``--seed``), not from the
reference's ``jax.random.normal`` draws, so the generated tokens are
not the reference launcher's.  ``main`` returns the finished requests.
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch import obs, resolve_device, serve
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import lm
from repro_torch.models import params as params_lib
from repro_torch.sc import ctr_rng
from repro_torch.serve import Request
from repro_torch.sharding import sc_shard_rules


def synthetic_prompts(seed: int, n: int, vocab: int, shared_prefix: int = 0):
    """The reference launcher's prompts: ``shared_prefix`` tokens common
    to all (0 = none), then 4..16 random tokens in [3, vocab) each."""
    rng = ctr_rng.prng_key(seed + 1)
    shared = []
    if shared_prefix:
        rng, k = ctr_rng.split(rng)
        shared = ctr_rng.randint(k, (shared_prefix,), 3, vocab).tolist()
    prompts = []
    for _ in range(n):
        rng, k = ctr_rng.split(rng)
        plen = int(ctr_rng.randint(k, (), 4, 17))
        prompts.append(shared + ctr_rng.randint(k, (plen,), 3, vocab).tolist())
    return prompts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument(
        "--shared-prefix",
        type=int,
        default=0,
        metavar="N",
        help="prepend the same N-token system prompt to every request "
        "(exercises the prefix cache; 0 = fully random prompts)",
    )
    ap.add_argument(
        "--metrics-out",
        default=None,
        metavar="PATH",
        help="write the run's metrics after drain: Prometheus text "
        "exposition, or the JSON snapshot when PATH ends in .json",
    )
    ap.add_argument(
        "--trace-out",
        default=None,
        metavar="PATH",
        help="write per-request trace spans as JSONL after drain",
    )
    ap.add_argument(
        "--device",
        default=None,
        help="torch device (default: the card; 'cpu' runs the plain "
        "versions of the kernels)",
    )
    serve.add_cli_args(ap)  # every CLI field of ServeOptions as a flag
    args = ap.parse_args(argv)
    options = serve.from_cli_args(args)
    if options.chaos and not options.paged:
        options = options.replace(paged=True)  # chaos implies --paged
    try:
        options.validate()
    except ValueError as e:
        raise SystemExit(f"bad flag combination: {e}") from None
    joined = dist.is_initialized()
    try:
        return _serve(args, options)
    finally:
        if dist.is_initialized() and not joined:
            dist.destroy_process_group()


def _serve(args, options):
    device = resolve_device(args.device)
    mesh = rules = None
    if options.mesh:
        mesh = make_local_mesh(options.model_parallel, device=args.device)
        device, rules = mesh.device, sc_shard_rules(mesh)
        print(f"rank {mesh.rank}: device {device}, backend {mesh.backend}")
    # on a mesh every rank serves the same requests; rank 0 reports
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    if mesh is not None:
        say(f"serving on mesh {dict(mesh.shape)}")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(param_dtype=torch.float32, act_dtype=torch.float32)
    if cfg.frontend == "embeddings":
        raise SystemExit("serve demo uses token-frontend archs")
    gen = torch.Generator().manual_seed(options.seed)
    params = params_lib.init_params(
        lm.lm_param_specs(cfg), gen, device, cfg.param_dtype
    )
    # Observability: one registry holds the serve-layer AND substrate
    # series, and the installed tracer collects spans for the run.
    metrics = tracer = None
    if args.metrics_out or args.trace_out:
        metrics = obs.enable()
        tracer = obs.install_tracer(obs.Tracer())
    if options.fault_profile:
        p = options.resolve_profile()
        say(
            f"device profile '{options.fault_profile}': "
            f"sigma_delta={p.sigma_delta} sigma_ic={p.sigma_ic} "
            f"ber={p.ber_stuck0}/{p.ber_stuck1}/{p.ber_retention}"
        )

    fleet = engine = None
    if options.chaos:
        fleet = _build_fleet(params, cfg, options, device, metrics, tracer)
    else:
        engine = serve.build_engine(
            params, cfg, options, device=device, metrics=metrics,
            tracer=tracer, mesh=mesh, shard_rules=rules,
        )
        if options.paged:
            say(
                f"paged engine: block_size={options.block_size} "
                f"pool={engine.kv.cfg.num_blocks} blocks "
                f"(chunked prefill {options.prefill_chunk}"
                + (", prefix cache" if options.prefix_cache else "")
                + (f", speculative k={options.spec_k}"
                   if options.speculative else "")
                + ")"
            )

    target = fleet if fleet is not None else engine
    prompts = synthetic_prompts(
        options.seed, args.requests, cfg.vocab, args.shared_prefix
    )
    for rid, prompt in enumerate(prompts):
        target.submit(
            Request(
                rid=rid,
                prompt=prompt,
                max_new_tokens=args.max_new,
                temperature=args.temperature,
            )
        )

    t0 = time.time()
    finished = target.run_until_drained()
    dt = time.time() - t0
    total_tokens = sum(len(r.generated) for r in finished)
    say(
        f"served {len(finished)} requests, {total_tokens} tokens "
        f"in {dt:.1f}s ({total_tokens / max(dt, 1e-9):.1f} tok/s)"
    )
    if fleet is not None:
        say(
            f"  fleet: {fleet.shards} shards, {fleet.drains} drained, "
            f"{fleet.resumed} requests resumed, "
            f"{fleet.readmissions} readmitted"
        )
    elif options.paged:
        _print_paged(engine, options)
    for r in sorted(finished, key=lambda r: r.rid)[:4]:
        say(
            f"  req {r.rid}: prompt[:6]={r.prompt[:6]} "
            f"generated={r.generated}"
        )
    if args.metrics_out and lead:
        with open(args.metrics_out, "w") as f:
            if args.metrics_out.endswith(".json"):
                f.write(metrics.snapshot_json())
            else:
                f.write(metrics.exposition())
        say(f"  metrics -> {args.metrics_out}")
    if args.trace_out and lead:
        tracer.write_jsonl(args.trace_out)
        say(f"  trace   -> {args.trace_out} ({len(tracer.spans)} spans)")
    if tracer is not None:
        obs.uninstall_tracer(tracer)
        obs.disable()
    return finished


def _print_paged(engine, options) -> None:
    print(
        f"  {engine.ticks} ticks, {engine.evictions} evictions, "
        f"{engine.kv.pool.free_blocks} blocks free at drain"
    )
    lat = engine.decode_latency_ms()
    if lat:
        print(
            f"  decode p50={lat['decode_p50_ms']:.2f} "
            f"p95={lat['decode_p95_ms']:.2f} ms/token"
        )
    if options.prefix_cache:
        hit = engine.metrics.value("serve_prefix_cache_hit_tokens_total") or 0
        pre = engine.metrics.value("serve_prefill_tokens_total") or 0
        rate = hit / max(hit + pre, 1)
        print(
            f"  prefix cache: {int(hit)} tokens adopted "
            f"(hit rate {rate:.2f})"
        )
    if options.speculative:
        drafted = engine.metrics.value("serve_spec_drafted_tokens_total") or 0
        acc = engine.metrics.value("serve_spec_accepted_tokens_total") or 0
        print(
            f"  speculative: {int(acc)}/{int(drafted)} drafted tokens "
            "accepted"
        )


def _build_fleet(params, cfg, options, device, metrics, tracer):
    """2-shard paged fleet under the FT supervisor with a deterministic
    chaos schedule: shard 1 degrades at fleet tick 2, its requests drain
    onto shard 0 and finish there."""
    from repro_torch.ft import supervisor as ftsup

    shard_opts = options.replace(chaos=False)
    fleet = ftsup.FleetSupervisor(
        lambda shard: serve.build_engine(
            params, cfg, shard_opts, device=device, tracer=tracer
        ),
        shards=2,
        metrics=metrics,
        chaos=ftsup.ChaosMonkey(at_tick=2, shard=1),
    )
    print("chaos fleet: 2 shards, degradation scheduled at tick 2 on shard 1")
    return fleet


if __name__ == "__main__":
    main()
