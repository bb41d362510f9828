from .optimizers import Optimizer, adagrad, adam, sgd
from .schedule import constant_lr, parallel_lr_schedule

__all__ = ["Optimizer", "adagrad", "adam", "sgd",
           "parallel_lr_schedule", "constant_lr"]
