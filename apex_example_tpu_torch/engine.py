"""The single-device train step: port of apex_example_tpu/engine.py
(``TrainState`` :48, ``create_train_state`` :57, ``make_train_step`` :106)
at amp O0, one microbatch, no DDP.

At O0 the JAX step's loss scaler is the identity (amp/scaler.py:57-60,
73-78, 101-103): the loss is not scaled, the grads are not unscaled, and
``grads_finite`` is the constant 1.  So one step here is forward ->
loss -> backward -> optimizer step, with the metrics the JAX step reports:
``loss``, ``scale`` 1.0, ``grads_finite`` 1.0 and ``grad_norm``, the
global norm of the grads before any clip (:272).  FusedLAMB's step takes
that norm for its own clip and returns it; an optimizer that takes none
(FusedAdam's step returns None) is asked for it after its step, one
L2-norm launch over the grads, which the step does not change.

The JAX state is an immutable pytree that each step replaces; here the
model and optimizer update in place and the step returns the same
``TrainState`` with its counter advanced.  The grads are zeroed in place
before each backward, so their storage stays where the optimizer's device
table points.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn

from apex_example_tpu_torch.workloads import mlm_loss


@dataclass
class TrainState:
    """What the step carries: the step count, the model (its parameters
    are the fp32 master weights at O0) and the optimizer with its state."""
    step: int
    model: nn.Module
    optimizer: Any


def create_train_state(model: nn.Module, optimizer) -> TrainState:
    """Pair a model with an optimizer built over its parameters."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return TrainState(step=0, model=model, optimizer=optimizer)


def make_train_step(loss_fn: Callable = mlm_loss):
    """``train_step(state, (x, y)) -> (state, metrics)``; ``y`` is what
    ``loss_fn(logits, y)`` takes (for MLM, (labels, weights))."""

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        x, y = batch
        state.model.train()
        state.optimizer.zero_grad()
        loss = loss_fn(state.model(x), y)
        loss.backward()
        grad_norm = state.optimizer.step()
        if grad_norm is None:
            grad_norm = state.optimizer.grad_norm()
        state.step += 1
        metrics = {"loss": loss.detach(), "scale": 1.0,
                   "grads_finite": 1.0, "grad_norm": grad_norm}
        return state, metrics

    return train_step
