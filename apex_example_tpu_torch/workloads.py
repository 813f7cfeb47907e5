"""Language-model losses: port of apex_example_tpu/workloads.py:32-47."""

from __future__ import annotations

from typing import Tuple

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
