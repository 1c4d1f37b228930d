"""Learning-rate schedules, the port of the JAX package's
``ops/schedules.py``: ``step -> lr`` over the optimizer step count.  The
port keeps that count on the host (a Python int), so a schedule is plain
host arithmetic and reading it never waits for the device."""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def constant(lr: float) -> Schedule:
    return lambda step: float(lr)


def _warmup(step: int, lr: float, warmup_steps: int) -> float:
    """Linear 0 -> lr over ``warmup_steps`` (lr at step >= warmup_steps)."""
    if warmup_steps <= 0:
        return float(lr)
    return lr * min((step + 1.0) / float(warmup_steps), 1.0)


def _decay_frac(step: int, total_steps: int, warmup_steps: int) -> float:
    decay_steps = max(total_steps - warmup_steps, 1)
    return min(max((step - warmup_steps) / decay_steps, 0.0), 1.0)


def warmup_cosine(lr: float, total_steps: int, warmup_steps: int = 0,
                  min_lr: float = 0.0) -> Schedule:
    """Linear warmup then cosine decay to ``min_lr`` at ``total_steps``."""
    def sched(step):
        if step < warmup_steps:
            return _warmup(step, lr, warmup_steps)
        t = _decay_frac(step, total_steps, warmup_steps)
        return min_lr + 0.5 * (lr - min_lr) * (1.0 + math.cos(math.pi * t))

    return sched


def warmup_linear(lr: float, total_steps: int, warmup_steps: int = 0,
                  min_lr: float = 0.0) -> Schedule:
    """Linear warmup then linear decay to ``min_lr`` at ``total_steps``."""
    def sched(step):
        if step < warmup_steps:
            return _warmup(step, lr, warmup_steps)
        return lr + (min_lr - lr) * _decay_frac(step, total_steps,
                                                warmup_steps)

    return sched


SCHEDULES = {"constant": constant, "cosine": warmup_cosine,
             "linear": warmup_linear}


def make(name: str, lr: float, total_steps: int = 0, warmup_steps: int = 0,
         min_lr: float = 0.0) -> Schedule:
    """Build from config strings (``TrainConfig.lr_schedule``)."""
    if name == "constant":
        return constant(lr)
    if name not in SCHEDULES:
        raise ValueError(f"unknown schedule {name!r}; have {sorted(SCHEDULES)}")
    if total_steps <= 0:
        raise ValueError(f"schedule {name!r} needs total_steps > 0")
    return SCHEDULES[name](lr, total_steps, warmup_steps, min_lr)
