"""Learning-rate schedules: port of apex_example_tpu/optim/schedules.py.

A schedule is a plain Python function ``f(step) -> lr`` of the 1-based
step count the optimizer passes after incrementing it (the apex
``state.step`` convention its bias corrections use).  Every schedule
composes linear warmup (0 -> base over ``warmup_steps``) with a decay phase;
the arithmetic is the JAX package's, on host floats.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Union

Schedule = Callable[[int], float]


def _warmup_factor(step: int, warmup_steps: int) -> float:
    """Linear 0 -> 1 over warmup_steps; 1 afterwards."""
    if warmup_steps <= 0:
        return 1.0
    return min(step / float(warmup_steps), 1.0)


def constant_lr(base_lr: float, warmup_steps: int = 0) -> Schedule:
    def f(step):
        return base_lr * _warmup_factor(step, warmup_steps)
    return f


def step_decay(base_lr: float, boundaries: Sequence[int],
               gamma: float = 0.1, warmup_steps: int = 0) -> Schedule:
    """lr = base * gamma^(number of boundaries passed)."""
    bounds = sorted(int(b) for b in boundaries)

    def f(step):
        passed = sum(step >= b for b in bounds)
        return (base_lr * gamma ** passed
                * _warmup_factor(step, warmup_steps))
    return f


def cosine_decay(base_lr: float, total_steps: int, warmup_steps: int = 0,
                 min_lr: float = 0.0) -> Schedule:
    """Cosine from base to min_lr over [warmup_steps, total_steps]."""
    span = max(total_steps - warmup_steps, 1)

    def f(step):
        s = min(max(step - warmup_steps, 0.0), float(span))
        cos = 0.5 * (1.0 + math.cos(math.pi * s / span))
        return ((min_lr + (base_lr - min_lr) * cos)
                * _warmup_factor(step, warmup_steps))
    return f


def polynomial_decay(base_lr: float, total_steps: int, warmup_steps: int = 0,
                     power: float = 1.0, min_lr: float = 0.0) -> Schedule:
    """Polynomial decay (linear at power 1): the BERT/LAMB pretraining
    schedule, warmup then linear to min_lr."""
    span = max(total_steps - warmup_steps, 1)

    def f(step):
        s = min(max(step - warmup_steps, 0.0), float(span))
        frac = (1.0 - s / span) ** power
        return ((min_lr + (base_lr - min_lr) * frac)
                * _warmup_factor(step, warmup_steps))
    return f


def build_schedule(name: str, base_lr: float, total_steps: int,
                   warmup_steps: int = 0, boundaries: Sequence[int] = (),
                   gamma: float = 0.1, power: float = 1.0,
                   min_lr: float = 0.0) -> Union[float, Schedule]:
    """CLI-facing factory, ``name`` in {const, step, cosine, poly}.  A
    warmup-free const returns the float itself."""
    if name == "const":
        if warmup_steps <= 0:
            return base_lr
        return constant_lr(base_lr, warmup_steps)
    if name == "step":
        if not boundaries:
            boundaries = [total_steps // 3, 2 * total_steps // 3]
        return step_decay(base_lr, boundaries, gamma, warmup_steps)
    if name == "cosine":
        return cosine_decay(base_lr, total_steps, warmup_steps, min_lr)
    if name == "poly":
        return polynomial_decay(base_lr, total_steps, warmup_steps, power,
                                min_lr)
    raise ValueError(f"unknown schedule {name!r}")
