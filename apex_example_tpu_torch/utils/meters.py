"""Meters of the training loop: a copy of ``AverageMeter`` (:12),
``accuracy`` (:36) and ``Throughput`` (:47) from
apex_example_tpu/utils/meters.py, ``accuracy`` in torch."""

from __future__ import annotations

import time
from typing import Optional, Tuple

import torch


class AverageMeter:
    """Running average, with the reference harness's meter surface."""

    def __init__(self, name: str = "", fmt: str = ":f"):
        self.name, self.fmt = name, fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        return f"{self.name} {self.val:.4f} ({self.avg:.4f})"


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             topk: Tuple[int, ...] = (1,)) -> Tuple[torch.Tensor, ...]:
    """Top-k accuracy in percent, 0-d fp32 tensors (the reference's
    ``accuracy()``); ties rank by index, as jnp.argsort's stable sort."""
    maxk = max(topk)
    top = torch.argsort(-logits, dim=-1, stable=True)[..., :maxk]
    correct = top == labels[..., None]
    return tuple(100.0 * correct[..., :k].any(-1).float().mean()
                 for k in topk)


class Throughput:
    """Items per second with warmup skipping: ``warmup_steps=K`` starts the
    clock at the end of step K and counts items from step K+1 on;
    ``warmup_steps=0`` starts it at construction and counts every step."""

    def __init__(self, warmup_steps: int = 2):
        self.warmup = max(int(warmup_steps), 0)
        self.items = 0
        self.seen_steps = 0
        self.start: Optional[float] = \
            time.perf_counter() if self.warmup == 0 else None

    def step(self, n_items: int):
        self.seen_steps += 1
        if self.seen_steps == self.warmup:
            self.start = time.perf_counter()
            self.items = 0
        elif self.start is not None:
            self.items += n_items

    @property
    def rate(self) -> float:
        if self.start is None or self.items == 0:
            return 0.0
        elapsed = time.perf_counter() - self.start
        return self.items / max(elapsed, 1e-9)
