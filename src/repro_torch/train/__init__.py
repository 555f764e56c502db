"""Training substrate: optimizer, train step, data pipeline, checkpoints."""
from repro_torch.train.optim import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from repro_torch.train.train_step import TrainState, make_train_step, init_state  # noqa: F401
from repro_torch.train.checkpoint import CheckpointManager                 # noqa: F401
from repro_torch.train.data import TokenPipeline                           # noqa: F401
