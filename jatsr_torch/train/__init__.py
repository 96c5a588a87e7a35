from .state import TrainState, create_train_state, make_optimizer
from .step import Normalizer, make_eval_step, make_train_step

__all__ = ["Normalizer", "TrainState", "create_train_state", "make_eval_step",
           "make_optimizer", "make_train_step"]
