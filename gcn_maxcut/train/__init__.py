from gcn_maxcut.train.config import TrainingConfig
from gcn_maxcut.train.loop import (
    TrainState,
    setup_train_state,
    make_epoch_fn,
    make_monitored_epoch_fn,
    init_early_stop_state,
    train_model,
    train_dataset,
    train_from_files,
    evaluate_model,
)
from gcn_maxcut.train.checkpoint import (
    save_checkpoint,
    load_checkpoint,
    checkpoint_name,
)
from gcn_maxcut.train.torch_compat import (
    load_torch_checkpoint,
    save_torch_checkpoint,
    config_from_torch,
)

__all__ = [
    "TrainingConfig",
    "TrainState",
    "setup_train_state",
    "make_epoch_fn",
    "make_monitored_epoch_fn",
    "init_early_stop_state",
    "train_model",
    "train_dataset",
    "train_from_files",
    "evaluate_model",
    "save_checkpoint",
    "load_checkpoint",
    "checkpoint_name",
    "load_torch_checkpoint",
    "save_torch_checkpoint",
    "config_from_torch",
]
