from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    get_config,
    get_smoke_config,
    supported_shapes,
)
