from repro_torch.ft.supervisor import (  # noqa: F401
    ChaosMonkey,
    EngineHealth,
    FaultInjector,
    FleetSupervisor,
    HealthMonitor,
    StragglerMonitor,
    Supervisor,
    WorkerFailure,
    engine_health,
)
