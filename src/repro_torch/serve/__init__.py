"""repro_torch.serve — the paged continuous-batching serving engine."""

from repro_torch.serve.api import ServeOptions, build_engine  # noqa: F401
from repro_torch.serve.engine import (  # noqa: F401
    PagedServeConfig,
    PagedServingEngine,
    Request,
)
from repro_torch.serve.kv_cache import (  # noqa: F401
    BlockPool,
    PagedCacheConfig,
    PagedKVCache,
    default_num_blocks,
)
from repro_torch.serve.scheduler import Scheduler, TickPlan  # noqa: F401
