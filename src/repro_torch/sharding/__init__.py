"""repro_torch.sharding — logical-axis -> mesh-axis rules (port of
``repro.sharding``)."""

from repro_torch.sharding.rules import (  # noqa: F401
    ACT_RULES,
    PARAM_RULES,
    Placement,
    act_spec,
    logical_rules,
    param_partition_specs,
    param_shardings,
    sc_shard_rules,
)
