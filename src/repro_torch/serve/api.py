"""Serve-engine construction: one options dataclass, one builder.

Port of ``repro.serve.api``.  :class:`ServeOptions` keeps every knob of
the reference under its name; :func:`build_engine` validates them and
builds the paged engine on a device.  A ``fault_profile`` serves on a
non-ideal device: the profile is resolved, an exact model moves onto
the ``array`` backend (the only one that realizes faults), and the
engine enters ``sc.use_device_profile`` around each tick.
``prefix_cache``, ``rng_mode`` and ``speculative`` / ``spec_k`` /
``draft_backend`` pass through to the paged engine.  Knobs whose
features the port does not have yet (the fixed-slot engine, ``mesh``,
``chaos``) raise ``NotImplementedError`` naming the ROADMAP item that
brings them, rather than serving something else.
"""

from __future__ import annotations

import dataclasses

from repro_torch import resolve_device
from repro_torch.core import physics


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
            ("mesh", self.mesh, 10),
            ("chaos", self.chaos, 9),
        ]
        for name, asked, item in unported:
            if asked:
                raise NotImplementedError(
                    f"ServeOptions {name} is not ported yet (ROADMAP "
                    f"queue 1 item {item})"
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


def build_engine(
    params,
    cfg,
    options: ServeOptions | None = None,
    *,
    collect_arch_trace: bool = False,
    device=None,
    metrics=None,
    tracer=None,
):
    """THE serve-engine constructor: options -> the paged engine.

    ``device`` (default: the card; raises when none is present unless
    ``device="cpu"``) holds the page pools and runs every step; the
    parameters must already lie there.  ``options.fused_attention``
    applies ``cfg.paged_attn="fused"``, as in the reference; a non-ideal
    ``options.fault_profile`` moves an exact model onto ``array``.
    ``collect_arch_trace`` installs an arch trace collector when the
    model runs on ``array`` (``engine.arch_report()``).
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
    profile = options.resolve_profile()
    if (
        profile is not None
        and not profile.is_ideal
        and cfg.sc_backend in ("", "exact")
    ):
        # non-ideal devices exist only on the array backend
        cfg = cfg.replace(sc_backend="array")
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
    engine = engine_mod.PagedServingEngine(
        params,
        cfg,
        scfg,
        device=device,
        collect_arch_trace=collect_arch_trace,
        metrics=metrics,
        tracer=tracer,
    )
    engine.device_profile = profile
    return engine
