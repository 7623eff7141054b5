"""repro_torch.serve — the fixed-slot and paged serving engines."""

from repro_torch.serve.api import (  # noqa: F401
    ServeOptions,
    add_cli_args,
    build_engine,
    from_cli_args,
)
from repro_torch.serve.engine import (  # noqa: F401
    PagedServeConfig,
    PagedServingEngine,
    Request,
    ServeConfig,
    ServingEngine,
)
from repro_torch.serve.kv_cache import (  # noqa: F401
    BlockPool,
    CachePlan,
    PagedCacheConfig,
    PagedKVCache,
    default_num_blocks,
)
from repro_torch.serve.scheduler import Scheduler, TickPlan  # noqa: F401
