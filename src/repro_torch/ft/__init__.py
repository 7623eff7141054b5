from repro_torch.ft.supervisor import (  # noqa: F401
    FaultInjector,
    StragglerMonitor,
    Supervisor,
    WorkerFailure,
)
