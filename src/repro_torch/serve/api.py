"""Serve-engine construction: one options dataclass, one builder.

Port of ``repro.serve.api``.

* :class:`ServeOptions` — every serve knob of the reference, under its
  name, as one frozen dataclass.  Field metadata carries the CLI flag
  and help, so :func:`add_cli_args` derives the launcher's argparse
  surface from the dataclass and :func:`from_cli_args` reads it back.
* :func:`build_engine` — ``(params, cfg, options) -> engine`` on a
  device.  ``options.paged`` picks ``PagedServingEngine`` over the
  fixed-slot ``ServingEngine`` (the default); ``fused_attention`` sets
  ``cfg.paged_attn="fused"``; a non-ideal ``fault_profile`` moves an
  exact model onto the ``array`` backend (the only one that realizes
  faults) for either engine, and the engine enters
  ``sc.use_device_profile`` around each tick.  It is the supported
  construction path: building an engine directly warns.

``validate`` rejects the reference's invalid combinations with
``ValueError``.  ``chaos`` validates: ``launch/serve.py`` acts on it
with a 2-shard fleet.  ``mesh`` validates too: the launcher builds the
device mesh (``launch.mesh.make_local_mesh(model_parallel)``) and
passes it with its SC rules to ``build_engine(..., mesh=,
shard_rules=)``, which shards every SC call of the fixed-slot engine
over it.

    from repro_torch.serve import ServeOptions, build_engine
    engine = build_engine(params, cfg, ServeOptions(paged=True),
                          device="cpu")
"""

from __future__ import annotations

import dataclasses

from repro_torch import resolve_device
from repro_torch.core import physics


def _opt(default, help="", flag=None, metavar=None, cli=True):  # noqa: A002
    """Field with CLI metadata (the flag defaults to ``--field-name``)."""
    meta = {"help": help, "flag": flag, "metavar": metavar, "cli": cli}
    return dataclasses.field(default=default, metadata=meta)


@dataclasses.dataclass(frozen=True)
class ServeOptions:
    """Every serve-engine knob in one frozen dataclass.

    Fields the selected engine does not use are ignored; ``validate``
    rejects the combinations that would silently serve something other
    than what was asked (e.g. ``prefix_cache`` without ``paged``).
    """

    paged: bool = _opt(
        False,
        "serve through the paged continuous-batching engine (block-pool "
        "KV cache + chunked prefill + eviction-on-OOM)",
    )
    slots: int = _opt(4, "concurrent batch rows")
    max_len: int = _opt(128, "max context tokens per request")
    seed: int = _opt(0, "engine base PRNG seed (per-request keys fold off it)")
    eos_id: int = _opt(2, "end-of-sequence token id", cli=False)
    block_size: int = _opt(16, "tokens per KV block (--paged)")
    num_blocks: int = _opt(
        0,
        "pool size in blocks incl. the null block (--paged; 0 = size for "
        "slots x max_len)",
        flag="--max-blocks",
    )
    prefill_chunk: int = _opt(
        8, "prompt tokens fed per row per tick (--paged)"
    )
    rng_mode: str = _opt(
        "request",
        "per-token sampling-key derivation: 'request' (rid-keyed) or "
        "'content' (token-content chain; what --prefix-cache switches to)",
        cli=False,
    )
    fused_attention: bool = _opt(
        False,
        "run the fused paged-attention CUDA kernel instead of gather + "
        "chunk_decode_attention (--paged)",
    )
    prefix_cache: bool = _opt(
        False,
        "block-level prefix caching: requests sharing a prompt prefix "
        "adopt cached KV blocks instead of re-prefilling (--paged; forces "
        "content-chain rng)",
    )
    speculative: bool = _opt(
        False,
        "draft/verify speculative decoding on greedy rows: draft with the "
        "paired cheap backend, verify in one multi-token pass (--paged)",
    )
    spec_k: int = _opt(4, "draft tokens per speculative step (--speculative)")
    draft_backend: str = _opt(
        "",
        "draft backend name (--speculative; default: the registry pairing "
        "for the arch's sc_backend)",
    )
    mesh: bool = _opt(
        False,
        "shard the SC substrate over a device mesh of the torchrun "
        "world's ranks (slots map to data shards; needs a stochastic "
        "--arch sc_backend; fixed-slot engine only)",
    )
    model_parallel: int = _opt(
        1, "model axis size of the mesh (--mesh)"
    )
    fault_profile: str = _opt(
        "",
        "serve on a non-ideal device: named core/physics.py:DeviceProfile "
        "(ideal|tiny|calibrated|harsh) realized by the array backend",
        metavar="NAME",
    )
    chaos: bool = _opt(
        False,
        "chaos-test fault tolerance: serve a 2-shard paged fleet under "
        "ft.FleetSupervisor, inject a deterministic mid-run shard "
        "degradation, and drain/resume its requests on the healthy shard "
        "(implies --paged)",
    )

    def replace(self, **kw) -> "ServeOptions":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        """Raise ``ValueError`` on knob combinations that cannot serve."""
        if self.paged and self.mesh:
            raise ValueError(
                "paged and mesh are mutually exclusive (the paged engine "
                "is single-mesh-slice)"
            )
        if self.fused_attention and not self.paged:
            raise ValueError(
                "fused_attention needs paged=True (it is the paged decode "
                "path's kernel)"
            )
        if (self.prefix_cache or self.speculative) and not self.paged:
            raise ValueError(
                "prefix_cache/speculative need paged=True (they are "
                "paged-engine features)"
            )
        if self.chaos and self.mesh:
            raise ValueError("chaos runs a paged fleet; drop mesh=True")
        if self.rng_mode not in ("request", "content"):
            raise ValueError(
                f"rng_mode must be 'request' or 'content', got "
                f"{self.rng_mode!r}"
            )
        self.resolve_profile()  # raises ValueError on unknown names

    def resolve_profile(self) -> physics.DeviceProfile | None:
        """``fault_profile`` as a DeviceProfile (None when unset; an
        explicit 'ideal' still threads through, so the bit-identity
        contract is exercised end to end)."""
        if not self.fault_profile:
            return None
        try:
            return physics.resolve_profile(self.fault_profile)
        except KeyError as e:
            raise ValueError(str(e)) from None


def add_cli_args(ap, skip: tuple = ()) -> None:
    """Add a flag for every CLI field of :class:`ServeOptions`: booleans
    become ``store_true`` switches, everything else keeps its field's
    type and default."""
    for f in dataclasses.fields(ServeOptions):
        meta = f.metadata
        if not meta.get("cli", True) or f.name in skip:
            continue
        flag = meta.get("flag") or "--" + f.name.replace("_", "-")
        if isinstance(f.default, bool):
            ap.add_argument(
                flag, action="store_true", dest=f.name, help=meta["help"]
            )
        else:
            kw = {"metavar": meta["metavar"]} if meta.get("metavar") else {}
            ap.add_argument(
                flag,
                type=type(f.default),
                default=f.default,
                dest=f.name,
                help=meta["help"],
                **kw,
            )


def from_cli_args(args, **overrides) -> ServeOptions:
    """Collect parsed :func:`add_cli_args` flags back into options."""
    kw = {
        f.name: getattr(args, f.name)
        for f in dataclasses.fields(ServeOptions)
        if f.metadata.get("cli", True) and hasattr(args, f.name)
    }
    kw.update(overrides)
    return ServeOptions(**kw)


def build_engine(
    params,
    cfg,
    options: ServeOptions | None = None,
    *,
    collect_arch_trace: bool = False,
    device=None,
    metrics=None,
    tracer=None,
    mesh=None,
    shard_rules=None,
):
    """THE serve-engine constructor: options -> the right engine.

    ``device`` (default: the card; raises when none is present unless
    ``device="cpu"``) holds the caches and runs every step; the
    parameters must already lie there.  ``collect_arch_trace`` installs
    an arch trace collector when the model runs on ``array``
    (``engine.arch_report()``).  ``mesh`` / ``shard_rules`` ride along
    to the fixed-slot engine, which shards every SC call over the mesh.
    """
    from repro_torch.serve import engine as engine_mod

    options = options or ServeOptions()
    options.validate()
    device = resolve_device(device)
    table = params["embed"]["table"]
    if table.device.type != device.type:
        raise ValueError(
            f"params lie on {table.device}, the engine runs on {device}"
        )
    if options.fused_attention:
        cfg = cfg.replace(paged_attn="fused")
    profile = options.resolve_profile()
    if (
        profile is not None
        and not profile.is_ideal
        and cfg.sc_backend in ("", "exact")
    ):
        # non-ideal devices exist only on the array backend
        cfg = cfg.replace(sc_backend="array")
    build = dict(
        device=device,
        collect_arch_trace=collect_arch_trace,
        metrics=metrics,
        tracer=tracer,
    )
    with engine_mod._api_construction():
        if options.paged:
            scfg = engine_mod.PagedServeConfig(
                slots=options.slots,
                max_len=options.max_len,
                eos_id=options.eos_id,
                seed=options.seed,
                block_size=options.block_size,
                num_blocks=options.num_blocks,
                prefill_chunk=options.prefill_chunk,
                prefix_cache=options.prefix_cache,
                rng_mode=options.rng_mode,
                speculative=options.speculative,
                spec_k=options.spec_k,
                draft_backend=options.draft_backend,
            )
            engine = engine_mod.PagedServingEngine(params, cfg, scfg, **build)
        else:
            scfg = engine_mod.ServeConfig(
                slots=options.slots,
                max_len=options.max_len,
                eos_id=options.eos_id,
                seed=options.seed,
            )
            engine = engine_mod.ServingEngine(
                params, cfg, scfg, mesh=mesh, shard_rules=shard_rules,
                **build
            )
    engine.device_profile = profile
    return engine
