"""repro_torch.sc — the SC multiplication substrate (port of ``repro.sc``).

One operation interface, ``sc_dot(key, x, w, cfg)`` and its per-row-key
variant ``sc_dot_rows``, with the backends behind a registry and the
straight-through gradient at the dispatch boundary: ``exact``,
``moment``, ``bitexact``, ``pallas_moment`` (CUDA kernel
``csrc/sc_mac.cu``), the packed bit-exact engine ``pallas_bitexact``
(``csrc/sc_mul.cu``), the fused bit-exact engine ``pallas_fused``
(``csrc/sc_fused.cu``; ``fast_backend`` upgrades ``pallas_bitexact`` to
it, as in the reference), and the lazily registered ``array``
architecture simulator (``repro_torch.arch``).  ``use_device_profile``
scopes a device-realism profile over every ``ScConfig`` the model stack
builds.  ``draft_backend`` names the cheap backend speculative decoding
drafts with for a verify backend (``register_draft_pair`` sets one).
The launch shapes of the bit-exact kernels come from
:mod:`repro_torch.sc.autotune` (a versioned cache measured on the card,
a heuristic on a miss; no tile changes a bit).

Scale-out lives in :mod:`repro_torch.sc.sharded`: ``sc_dot_sharded``
splits one contraction over a ``torch.distributed`` device mesh (rows
over the data axes, the contraction over the model axis with a SUM
merge), and ``use_mesh`` makes the model stack route every one-key
stochastic matmul through it.
"""

from repro_torch.sc import autotune  # noqa: F401
from repro_torch.sc import backends as _backends  # noqa: F401  (registers)
from repro_torch.sc import ctr_rng, encoding  # noqa: F401
from repro_torch.core.physics import DeviceProfile  # noqa: F401
from repro_torch.sc.config import (  # noqa: F401
    ScConfig,
    current_device_profile,
    use_device_profile,
)
from repro_torch.sc.registry import (  # noqa: F401
    available_backends,
    draft_backend,
    fast_backend,
    get_backend,
    register_backend,
    register_draft_pair,
    register_rows_backend,
    sc_dot,
    sc_dot_rows,
)
from repro_torch.sc.sharded import (  # noqa: F401
    DEFAULT_RULES,
    ScShardRules,
    active_mesh,
    current_shard_count,
    resolve_rules,
    sc_dot_sharded,
    shard_counts,
    shard_scope,
    use_mesh,
)
