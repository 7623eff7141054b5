"""repro_torch.distributed — cross-pod int8 gradient compression (port
of ``repro.distributed``)."""

from repro_torch.distributed.compression import (  # noqa: F401
    compressed_grads,
    init_error_feedback,
)
