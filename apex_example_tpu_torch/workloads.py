"""Language-model losses and the Transformer-XL train step: port of
apex_example_tpu/workloads.py (``mlm_loss`` :32, ``lm_loss`` :45,
``make_txl_train_step`` :61).

The TXL step at amp O0 with one microbatch: the loss scaler is the
identity (no scaling, no unscale, ``grads_finite`` the constant 1), so one
step is zero the grads -> forward with the memory -> ``lm_loss`` ->
backward -> the global-norm clip over the optimizer's own grads
(``clip_grad_norm`` :145; on the card one L2-norm and one scale launch over
the optimizer's device table) -> the optimizer step.  Its metrics are the
JAX step's (:156-158): ``loss``, ``grad_norm`` (the norm before the clip),
``ppl = exp(loss)``, ``scale`` 1.0 and ``grads_finite`` 1.0.  The new
memory comes back detached, so the next step's backward stops at it, as
the JAX step never differentiates through its mems carry.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from apex_example_tpu_torch.ops.xentropy import softmax_cross_entropy


def mlm_loss(logits: torch.Tensor,
             target: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Masked-LM loss: the CE summed over the masked positions (weights
    mark them) over their count, at least 1.  target = (labels, weights)."""
    labels, weights = target
    ce = softmax_cross_entropy(logits, labels)
    return (ce * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Next-token CE, mean over all positions."""
    return softmax_cross_entropy(logits, labels).mean()


def make_txl_train_step(max_grad_norm: float = 0.25):
    """``train_step(state, mems, (inp, tgt)) -> (state, new_mems,
    metrics)`` for a TransformerXL ``state.model`` (engine.TrainState) and
    an optimizer with ``clip_grad_norm`` (optim/fused.py)."""

    def train_step(state, mems: torch.Tensor, batch
                   ) -> Tuple[object, torch.Tensor, Dict]:
        inp, tgt = batch
        state.model.train()
        state.optimizer.zero_grad()
        logits, new_mems = state.model(inp, mems)
        loss = lm_loss(logits, tgt)
        del logits          # the loss's graph holds what the backward needs
        loss.backward()
        grad_norm = state.optimizer.clip_grad_norm(max_grad_norm)
        state.optimizer.step()
        state.step += 1
        loss = loss.detach()
        metrics = {"loss": loss, "grad_norm": grad_norm,
                   "ppl": torch.exp(loss), "scale": 1.0,
                   "grads_finite": 1.0}
        return state, new_mems, metrics

    return train_step
