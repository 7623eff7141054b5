"""repro_torch.obs — lightweight, dependency-free observability.

The port's copy of ``repro.obs``: a metrics registry (counters, gauges,
fixed-bucket histograms, Prometheus exposition, JSON snapshot) and
structured trace spans.  The process-global default registry is
DISABLED by default; serving engines own their own always-on registry
(``engine.metrics``) so concurrent engines never mix series.  The
package imports nothing from the rest of ``repro_torch``.
"""

from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    disable,
    enable,
    enabled,
)
from repro_torch.obs.trace import (  # noqa: F401
    NULL_TRACER,
    Span,
    Tracer,
    current_tracer,
    install_tracer,
    read_jsonl,
    to_chrome,
    uninstall_tracer,
)
