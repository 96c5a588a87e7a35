from .checkpoint import CheckpointManager, find_latest_run, timestamp_run_name
from .state import TrainState, create_train_state, make_optimizer
from .step import Normalizer, make_eval_step, make_train_step

__all__ = ["CheckpointManager", "Normalizer", "TrainState",
           "create_train_state", "find_latest_run", "make_eval_step",
           "make_optimizer", "make_train_step", "timestamp_run_name"]
