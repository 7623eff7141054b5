from repro_torch.checkpoint.ckpt import (  # noqa: F401
    latest_step,
    restore,
    restore_resharded,
    save,
)
