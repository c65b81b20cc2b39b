"""Learning-rate schedules of the reference trainers, counterparts of
`uformer_tpu/train/schedules.py`: step -> lr callables (Python floats)
with epoch granularity. The lr used during 1-indexed epoch
e = step // steps_per_epoch + 1 is

  warmup + cosine: base * e / warmup_epochs while e <= warmup_epochs,
                   then cosine annealing to eta_min over the rest;
  step:            base * gamma ** (e // step_size).
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def warmup_cosine_schedule(base_lr: float, nepoch: int, steps_per_epoch: int,
                           warmup_epochs: int = 3,
                           eta_min: float = 1e-6) -> Schedule:
    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch + 1
        if epoch <= warmup_epochs:
            return base_lr * epoch / warmup_epochs
        t = epoch - warmup_epochs
        total = max(nepoch - warmup_epochs, 1)
        return eta_min + 0.5 * (base_lr - eta_min) * (
            1 + math.cos(math.pi * t / total))

    return schedule


def step_lr_schedule(base_lr: float, steps_per_epoch: int,
                     step_size: int = 50, gamma: float = 0.5) -> Schedule:
    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch + 1
        return base_lr * gamma ** (epoch // step_size)

    return schedule
