"""Serve-engine construction: one options dataclass, one builder.

Port of ``repro.serve.api``.  :class:`ServeOptions` keeps every knob of
the reference under its name; :func:`build_engine` validates them and
builds the paged engine on a device.  Knobs whose features this slice
does not port raise ``NotImplementedError`` naming the ROADMAP item
that brings them, rather than serving something else.
"""

from __future__ import annotations

import dataclasses

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class ServeOptions:
    """Every serve-engine knob in one frozen dataclass (see
    ``repro.serve.api.ServeOptions`` for each knob's meaning)."""

    paged: bool = False
    slots: int = 4
    max_len: int = 128
    seed: int = 0
    eos_id: int = 2
    block_size: int = 16
    num_blocks: int = 0
    prefill_chunk: int = 8
    rng_mode: str = "request"
    fused_attention: bool = False
    prefix_cache: bool = False
    speculative: bool = False
    spec_k: int = 4
    draft_backend: str = ""
    mesh: bool = False
    model_parallel: int = 1
    fault_profile: str = ""
    chaos: bool = False

    def replace(self, **kw) -> "ServeOptions":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        """Raise on knob combinations that cannot serve here."""
        if self.rng_mode not in ("request", "content"):
            raise ValueError(
                f"rng_mode must be 'request' or 'content', got "
                f"{self.rng_mode!r}"
            )
        unported = [
            ("paged=False (the fixed-slot engine)", not self.paged, 9),
            ("prefix_cache", self.prefix_cache, 5),
            ("speculative", self.speculative, 5),
            ("rng_mode='content'", self.rng_mode == "content", 5),
            ("fault_profile", bool(self.fault_profile), 8),
            ("mesh", self.mesh, 10),
            ("chaos", self.chaos, 9),
        ]
        for name, asked, item in unported:
            if asked:
                raise NotImplementedError(
                    f"ServeOptions {name} is not ported yet (ROADMAP "
                    f"queue 1 item {item})"
                )


def build_engine(
    params,
    cfg,
    options: ServeOptions | None = None,
    *,
    device=None,
    metrics=None,
    tracer=None,
):
    """THE serve-engine constructor: options -> the paged engine.

    ``device`` (default: the card; raises when none is present unless
    ``device="cpu"``) holds the page pools and runs every step; the
    parameters must already lie there.  ``options.fused_attention``
    applies ``cfg.paged_attn="fused"``, as in the reference.
    """
    from repro_torch.serve import engine as engine_mod

    options = options or ServeOptions()
    options.validate()
    device = resolve_device(device)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family={cfg.family!r} is not ported yet (ROADMAP queue 1 "
            "item 7)"
        )
    table = params["embed"]["table"]
    if table.device.type != device.type:
        raise ValueError(
            f"params lie on {table.device}, the engine runs on {device}"
        )
    if options.fused_attention:
        cfg = cfg.replace(paged_attn="fused")
    scfg = engine_mod.PagedServeConfig(
        slots=options.slots,
        max_len=options.max_len,
        eos_id=options.eos_id,
        seed=options.seed,
        block_size=options.block_size,
        num_blocks=options.num_blocks,
        prefill_chunk=options.prefill_chunk,
    )
    return engine_mod.PagedServingEngine(
        params, cfg, scfg, device=device, metrics=metrics, tracer=tracer
    )
