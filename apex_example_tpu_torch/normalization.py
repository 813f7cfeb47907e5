"""FusedLayerNorm / MixedFusedLayerNorm and FusedRMSNorm / MixedFusedRMSNorm:
port of apex_example_tpu/normalization.py.

LayerNorm and RMSNorm over the last axis through ops/layer_norm.py — the
CUDA kernels on the card, their plain versions on the CPU.  The statistics
are fp32 whatever x's dtype (the MixedFused contract); the parameters are
(H,) in ``param_dtype`` (fp32 by default) and reach the op in it, which
reads them as fp32 and returns their gradients in it; the output follows
the input dtype, or is cast to ``dtype`` when one is given (:46, :74).

``use_scale`` / ``use_bias`` off: no parameter of that name is registered,
as the flax module then has no ``scale`` / ``bias`` leaf, and a constant
ones / zeros buffer (left out of ``state_dict``) stands in its place, so
that ``state_dict`` keys match the flax tree
(``convert.norm_params_from_flax``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from apex_example_tpu_torch.ops.layer_norm import layer_norm, rms_norm


def _param_or_constant(module: nn.Module, name: str, learned: bool,
                       value: torch.Tensor) -> None:
    """``value`` as the parameter ``name``, or, when it is not learned, as
    a buffer of that name that ``state_dict`` leaves out."""
    if learned:
        module.register_parameter(name, nn.Parameter(value))
    else:
        module.register_buffer(name, value, persistent=False)


class FusedLayerNorm(nn.Module):
    """LayerNorm over the last axis, backed by the LayerNorm kernels."""

    def __init__(self, hidden_size: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None, device=None, *,
                 param_dtype: torch.dtype = torch.float32,
                 use_bias: bool = True, use_scale: bool = True):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        kw = dict(dtype=param_dtype, device=device)
        _param_or_constant(self, "scale", use_scale,
                           torch.ones(hidden_size, **kw))
        _param_or_constant(self, "bias", use_bias,
                           torch.zeros(hidden_size, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = layer_norm(x, self.scale, self.bias, self.eps)
        return y if self.dtype is None else y.to(self.dtype)


MixedFusedLayerNorm = FusedLayerNorm


class FusedRMSNorm(nn.Module):
    """RMSNorm over the last axis, backed by the RMSNorm kernels: apex's
    later ``FusedRMSNorm``, LayerNorm without the mean or a bias;
    ``elementwise_affine`` is ``use_scale``."""

    def __init__(self, hidden_size: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32,
                 use_scale: bool = True, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        _param_or_constant(self, "scale", use_scale,
                           torch.ones(hidden_size, dtype=param_dtype,
                                      device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = rms_norm(x, self.scale, self.eps)
        return y if self.dtype is None else y.to(self.dtype)


MixedFusedRMSNorm = FusedRMSNorm
