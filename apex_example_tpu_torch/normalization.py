"""FusedLayerNorm: port of apex_example_tpu/normalization.py:23.

LayerNorm over the last axis through ops/layer_norm.py — the CUDA kernel on
the card, its plain version on the CPU.  Parameters ``scale`` and ``bias``
are (H,) fp32 and the statistics are fp32 whatever x's dtype (the
MixedFusedLayerNorm contract); the output follows the input dtype, or is
cast to ``dtype`` when one is given (:46).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from apex_example_tpu_torch.ops.layer_norm import layer_norm


class FusedLayerNorm(nn.Module):
    def __init__(self, hidden_size: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(
            torch.ones(hidden_size, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(
            torch.zeros(hidden_size, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = layer_norm(x, self.scale, self.bias, self.eps)
        return y if self.dtype is None else y.to(self.dtype)

