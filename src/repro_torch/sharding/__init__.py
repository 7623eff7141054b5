"""repro_torch.sharding — logical-axis -> mesh-axis rules (port of
``repro.sharding``)."""

from repro_torch.sharding.rules import (  # noqa: F401
    ACT_RULES,
    PARAM_RULES,
    act_spec,
    logical_rules,
    param_partition_specs,
    sc_shard_rules,
)
