"""Learning-rate schedules (the JAX package's ``training/schedules.py``).

The reference trains at a constant lr injected per iteration
(reference train.py:210-211) and tells users to anneal manually
(README "decrease learning rate"). Here the common schedules are provided
as step -> lr functions the trainer evaluates each iteration (keeping the
live-injection design: the schedule runs on the host, the state carries
the current scalar).
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def constant(lr: float) -> Schedule:
    return lambda step: lr


def exponential_decay(lr: float, decay_rate: float, decay_steps: int,
                      staircase: bool = False,
                      min_lr: float = 0.0) -> Schedule:
    """lr * decay_rate^(step / decay_steps), floored at min_lr."""
    def schedule(step: int) -> float:
        exponent = step / decay_steps
        if staircase:
            exponent = math.floor(exponent)
        return max(lr * decay_rate ** exponent, min_lr)
    return schedule


def warmup_exponential(lr: float, warmup_steps: int, decay_rate: float = 1.0,
                       decay_steps: int = 10000,
                       min_lr: float = 0.0) -> Schedule:
    """Linear warmup to ``lr`` then exponential decay — the practical
    recipe for Tacotron-style training stability."""
    decay = exponential_decay(lr, decay_rate, decay_steps, min_lr=min_lr)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return lr * (step + 1) / warmup_steps
        return decay(step - warmup_steps)
    return schedule


def piecewise(boundaries_and_lrs) -> Schedule:
    """[(step_boundary, lr), ...] — lr of the last boundary <= step."""
    items = sorted(boundaries_and_lrs)

    def schedule(step: int) -> float:
        current = items[0][1]
        for boundary, lr in items:
            if step >= boundary:
                current = lr
        return current
    return schedule
