"""repro_torch.arch — array-level simulator of the SOT-MRAM SC engine
(port of ``repro.arch``).

    spec.py        ArraySpec — chip → bank → subarray → 256-cell rows
    tiler.py       decompose sc_dot(x, w) into row-sized tiles / waves
    schedule.py    compile tiles to a PRESET/PULSE/READ/POPCOUNT/MERGE trace
    accounting.py  walk the trace with core.costmodel.CostParams →
                   cycles / energy / utilization, and the fault census
    trace.py       collectors recording every array-backend call
    backend.py     the registered ``array`` SC backend + ambient spec/params
    workload.py    static per-layer matmul extraction for production shapes

Usage — run a matmul "on hardware" and read the bill:

    from repro_torch import arch, sc
    with arch.collect() as records:
        y = sc.sc_dot(key, x, w, sc.ScConfig(backend="array", nbit=1024))
    print(arch.format_trace(records[0].trace))
    print(arch.report_dict(records[0].report))
"""

from repro_torch.arch.spec import DEFAULT_SPEC, ArraySpec  # noqa: F401
from repro_torch.arch.tiler import (  # noqa: F401
    Tile,
    TilePlan,
    iter_tiles,
    occupancy,
    plan_summary,
    tile_matmul,
)
from repro_torch.arch.schedule import (  # noqa: F401
    OPS,
    Command,
    compile_schedule,
    format_trace,
    makespan,
)
from repro_torch.arch.accounting import (  # noqa: F401
    TraceReport,
    account,
    bit_error_census,
    merge_concurrent_reports,
    merge_reports,
    report_dict,
    subarray_error_masks,
)
from repro_torch.arch.trace import (  # noqa: F401
    CallRecord,
    TraceCollector,
    collect,
    scaled,
    summarize,
)
from repro_torch.arch.backend import (  # noqa: F401
    current_params,
    current_spec,
    schedule_call,
    use_params,
    use_spec,
)
from repro_torch.arch.workload import (  # noqa: F401
    MatmulSite,
    dense_workload,
    price_workload,
    price_workload_sharded,
    shard_site,
)
