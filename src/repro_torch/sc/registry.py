"""Backend registry + the dispatch entry points ``sc_dot`` /
``sc_dot_rows``.

Port of ``repro.sc.registry``: every backend registers under a name and
``sc_dot(key, x, w, cfg)`` runs ``cfg.backend``.  The straight-through
gradient of the reference's ``custom_vjp`` lives at THIS boundary, as
one ``torch.autograd.Function`` per entry point: the forward runs the
backend without recording a graph, the backward is the exact-product
jacobian (``gx = g @ wᵀ``, ``gw = x₂ᵀ @ g₂`` in float32, cast to the
operands' dtypes), and the key gets no gradient.  So every backend,
the CUDA kernels included, is trainable.

The ``array`` backend (the architecture simulator,
``repro_torch.arch.backend``) registers on first use, as in the
reference, so ``repro_torch.sc`` imports nothing of ``arch``.
"""

from __future__ import annotations

import contextlib
import importlib

import torch

from repro_torch import obs
from repro_torch.sc.config import ScConfig

_BACKENDS: dict = {}

# Optional batched per-row-key implementations: name -> fn(keys, x2d, w,
# cfg) with keys (M, 2).  Backends without one fall back to a loop of
# single-row calls in ``sc_dot_rows``.
_ROW_BACKENDS: dict = {}

# name -> bit-identical faster backend (``fast_backend``).
_FAST_ALIASES: dict = {"pallas_bitexact": "pallas_fused"}

# Backends living outside repro_torch.sc register on first use: name ->
# module whose import performs the @register_backend call.
_LAZY_BACKENDS: dict = {"array": "repro_torch.arch.backend"}

# verify backend -> cheap DRAFT backend for speculative decoding.  The
# draft only guesses tokens (the verifier re-derives every emitted token
# under its own backend), so stochastic backends draft with ``moment``
# (the closed-form mean of the SC estimator) and ``exact`` drafts as
# itself.
_DRAFT_PAIRS: dict = {"exact": "exact"}
_DEFAULT_DRAFT = "moment"


def register_backend(name: str):
    """Decorator: register ``fn(key, x2d, w, cfg) -> y2d`` under ``name``
    (x2d (M, K), w (K, N) float32 -> (M, N) float32)."""

    def deco(fn):
        _BACKENDS[name] = fn
        return fn

    return deco


def register_rows_backend(name: str):
    """Decorator: register a batched per-row-key path
    ``fn(keys, x2d, w, cfg)`` for backend ``name``; row i must depend on
    ``keys[i]`` / ``x[i]`` only."""

    def deco(fn):
        _ROW_BACKENDS[name] = fn
        return fn

    return deco


def get_backend(name: str):
    """Resolve a backend name to its function (importing lazy entries)."""
    if name not in _BACKENDS and name in _LAZY_BACKENDS:
        importlib.import_module(_LAZY_BACKENDS[name])
    fn = _BACKENDS.get(name)
    if fn is not None:
        return fn
    raise ValueError(
        f"unknown SC backend {name!r}; registered: "
        f"{sorted(set(_BACKENDS) | set(_LAZY_BACKENDS))}"
    )


def available_backends() -> tuple:
    """Sorted names of every selectable backend (lazy ones included)."""
    return tuple(sorted(set(_BACKENDS) | set(_LAZY_BACKENDS)))


def fast_backend(name: str, nbit: int | None = None) -> str:
    """Resolve ``name`` to its bit-identical fast path, if one exists:
    ``pallas_bitexact`` -> ``pallas_fused`` when ``nbit`` packs whole
    32-bit words; every other name returns unchanged."""
    fast = _FAST_ALIASES.get(name)
    if fast is None:
        return name
    if nbit is not None and nbit % 32 != 0:
        return name
    return fast


def register_draft_pair(verify: str, draft: str) -> None:
    """Pair ``verify`` with the backend speculative decoding drafts with
    (``draft`` must resolve; accepted tokens are always the verifier's)."""
    get_backend(draft)  # fail fast on unknown names
    _DRAFT_PAIRS[verify] = draft


def draft_backend(name: str) -> str:
    """Draft backend paired with verify backend ``name``: unpaired names
    draft with ``moment``.  ``fast_backend`` upgrades do not change the
    pairing (``pallas_bitexact`` and ``pallas_fused`` draft alike)."""
    return _DRAFT_PAIRS.get(name, _DEFAULT_DRAFT)


def _dispatch_scope(entry: str, backend: str, m: int, k: int, n: int):
    """Telemetry for one dispatch: a counter on the default registry and
    a span on the installed tracer, both off by default."""
    reg = obs.default_registry()
    if reg.enabled:
        c = reg.counter("sc_dispatch_total", "sc_dot/sc_dot_rows dispatches")
        c.inc(backend=backend, entry=entry)
    tr = obs.current_tracer()
    if tr is None or not tr.enabled:
        return contextlib.nullcontext()
    return tr.span("sc.dispatch", entry=entry, backend=backend, m=m, k=k, n=n)


class _StraightThrough(torch.autograd.Function):
    """Forward: ``dispatch(key, x, w, cfg)`` (no graph); backward: the
    exact-product jacobian of ``x @ w`` in float32, cast to the
    operands' dtypes.  The key and the config get no gradient."""

    @staticmethod
    def forward(ctx, x, w, key, cfg, dispatch):
        ctx.save_for_backward(x, w)
        return dispatch(key, x, w, cfg)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(torch.float32)
        gx = (g @ w.to(torch.float32).T).to(x.dtype)
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        gw = (x2.T @ g.reshape(-1, g.shape[-1])).to(w.dtype)
        return gx, gw, None, None, None


def _dispatch(key, x, w, cfg: ScConfig):
    fn = get_backend(cfg.backend)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    n = w.shape[-1]
    with _dispatch_scope("sc_dot", cfg.backend, x2.shape[0], x2.shape[1], n):
        y = fn(key, x2, w, cfg)
    return y.reshape(*lead, n)


def sc_dot(key, x, w, cfg: ScConfig = ScConfig()):
    """``x @ w`` through the configured SC backend.

    key: raw ``(2,)`` uint32 key (``exact`` ignores it); x: (..., K)
    float32, leading dims flatten to rows; w: (K, N) float32.  Returns
    (..., N) float32.  The gradient is straight-through whatever the
    backend.
    """
    return _StraightThrough.apply(x, w, key, cfg, _dispatch)


def _dispatch_rows(keys, x, w, cfg: ScConfig):
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    k2 = keys.reshape(-1, keys.shape[-1])
    m, k = x2.shape
    with _dispatch_scope("sc_dot_rows", cfg.backend, m, k, w.shape[-1]):
        fn = _ROW_BACKENDS.get(cfg.backend)
        if fn is not None:
            y = fn(k2, x2, w, cfg)
        else:
            base = get_backend(cfg.backend)
            rows = [base(k2[i], x2[i : i + 1], w, cfg) for i in range(m)]
            y = torch.cat(rows, dim=0) if rows else x2 @ w
    return y.reshape(*lead, w.shape[-1])


def sc_dot_rows(keys, x, w, cfg: ScConfig = ScConfig()):
    """``x @ w`` with PER-ROW keys: row i draws from ``keys[i]`` alone.

    keys: (..., 2) raw uint32 keys matching ``x``'s leading dims.  Row
    i's output (bits AND encoding scale) is a function of
    ``(keys[i], x[i], w)`` only and equals ``sc_dot(keys[i], x[i:i+1],
    w, cfg)``.  The gradient is the same straight-through jacobian as
    :func:`sc_dot`'s.
    """
    return _StraightThrough.apply(x, w, keys, cfg, _dispatch_rows)
