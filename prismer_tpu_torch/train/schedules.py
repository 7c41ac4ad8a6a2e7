"""LR schedules, ported from prismer_tpu/train/schedules.py: plain step -> lr
functions with the reference's formulas (utils.py:13-31)."""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def cosine_schedule(init_lr: float, min_lr: float, max_steps: int
                    ) -> Schedule:
    """(init - min) * 0.5 * (1 + cos(pi * step / max_steps)) + min."""
    def fn(step: int) -> float:
        return ((init_lr - min_lr) * 0.5
                * (1.0 + math.cos(math.pi * step / max_steps)) + min_lr)
    return fn


def warmup_schedule(init_lr: float, max_lr: float, max_steps: int
                    ) -> Schedule:
    """min(max_lr, init + (max - init) * step / max_steps)."""
    def fn(step: int) -> float:
        return min(max_lr, init_lr + (max_lr - init_lr) * step / max_steps)
    return fn


def step_schedule(init_lr: float, min_lr: float, decay_rate: float
                  ) -> Schedule:
    """max(min_lr, init * decay ** epoch)."""
    def fn(epoch: int) -> float:
        return max(min_lr, init_lr * decay_rate ** epoch)
    return fn


def pretrain_schedule(init_lr: float, min_lr: float, warmup_lr: float,
                      warmup_steps: int, steps_per_epoch: int,
                      max_epoch: int) -> Schedule:
    """Per-step warmup inside the first `warmup_steps` of epoch 0,
    per-epoch cosine otherwise."""
    cos = cosine_schedule(init_lr, min_lr, max_epoch)
    warm = warmup_schedule(warmup_lr, init_lr, warmup_steps)

    def fn(step: int) -> float:
        epoch = step // steps_per_epoch
        if epoch == 0 and step % steps_per_epoch < warmup_steps:
            return warm(step % steps_per_epoch)
        return cos(epoch)
    return fn


def per_step_cosine(init_lr: float, min_lr: float, steps_per_epoch: int,
                    max_epoch: int) -> Schedule:
    """The caption / VQA fine-tune schedule: cosine over all steps."""
    return cosine_schedule(init_lr, min_lr, steps_per_epoch * max_epoch)
