"""Learning-rate schedules, including the paper's parallel scaling rule (§3):

  effective lr = base_lr · k   (k = #workers) for the first ``reset_epochs``
  epochs, then reset to base_lr.  Base lr 0.001 in the paper.
"""
from __future__ import annotations


def constant_lr(lr: float):
    return lambda epoch: lr


def parallel_lr_schedule(base_lr: float = 1e-3, n_workers: int = 1,
                         reset_epochs: int = 10):
    """Paper §3: lr = base·k for the first 10 epochs, then base."""

    def schedule(epoch: int) -> float:
        return base_lr * n_workers if epoch < reset_epochs else base_lr

    return schedule
