from repro_torch.train.step import (  # noqa: F401
    TrainConfig,
    make_eval_step,
    make_train_step,
    train_state_init,
)
