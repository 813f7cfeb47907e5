"""Precision policies: port of apex_example_tpu/amp/policy.py (``Policy``
:31, ``opt_level_table`` :99, ``get_policy`` :173) with torch dtypes.

Each of apex's opt levels O0-O3 is a bundle of properties; here a
:class:`Policy` carries the dtypes that the port threads into model
construction (``compute_dtype``, ``param_dtype``, ``bn_dtype``) and the
loss-scaling mode that the train step reads.  Nothing is patched: the
policy is the configuration of the model and the step.

The reduced dtype defaults to bf16, as in the JAX package: bf16 has fp32's
exponent range, so O1 and O2 default to a static loss scale of 1.0 (the
scaler is then the identity and costs nothing).  fp16 is chosen through the
library (``amp.initialize(half_dtype=torch.float16)``), not the CLI; its
O1 and O2 default to dynamic loss scaling.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """The precision properties of one opt level.

    ``param_dtype`` stores the model's parameters: fp32 for O0-O2 (they are
    the master weights; the forward casts them to ``compute_dtype``), half
    for O3.  ``compute_dtype`` is that of convolutions and matrix products,
    ``bn_dtype`` that of BatchNorm's moments and normalization
    (``keep_batchnorm_fp32``).  ``loss_scale`` None is a static 1.0, a
    number a static scale, "dynamic" dynamic loss scaling.
    ``cast_at_call_sites`` is O1's per-op-class casting (amp/autocast.py).
    """

    opt_level: str
    param_dtype: torch.dtype
    compute_dtype: torch.dtype
    bn_dtype: torch.dtype
    master_weights: bool
    loss_scale: Union[None, float, str]
    cast_at_call_sites: bool = False

    @property
    def uses_dynamic_scaling(self) -> bool:
        return self.loss_scale == "dynamic"

    @property
    def static_scale(self) -> float:
        if self.loss_scale is None:
            return 1.0
        if self.loss_scale == "dynamic":
            raise ValueError("dynamic policy has no static scale")
        return float(self.loss_scale)

    def replace(self, **kw) -> "Policy":
        return dataclasses.replace(self, **kw)


def opt_level_table(half_dtype: torch.dtype = torch.bfloat16):
    """The four opt levels with ``half_dtype`` as the reduced dtype."""
    h, f = half_dtype, torch.float32
    dynamic_if_fp16 = "dynamic" if h == torch.float16 else None
    return {
        # O0: pure fp32.
        "O0": Policy("O0", f, f, f, master_weights=False, loss_scale=None),
        # O1: fp32 params, per-op-class casts, sensitive ops in fp32.
        "O1": Policy("O1", f, h, f, master_weights=False,
                     loss_scale=dynamic_if_fp16, cast_at_call_sites=True),
        # O2: the model computes in half except BN's statistics; fp32
        # master weights.
        "O2": Policy("O2", f, h, f, master_weights=True,
                     loss_scale=dynamic_if_fp16),
        # O3: everything half, static scale 1.0.
        "O3": Policy("O3", h, h, h, master_weights=False, loss_scale=1.0),
    }


def get_policy(opt_level: str,
               loss_scale: Union[None, str, float] = None,
               keep_batchnorm_fp32: Optional[bool] = None,
               half_dtype: torch.dtype = torch.bfloat16) -> Policy:
    """Look up an opt level and apply ``amp.initialize``'s overrides:
    ``loss_scale`` "dynamic" or a number (a numeric string too);
    ``keep_batchnorm_fp32`` sets ``bn_dtype`` to fp32 (True) or to the
    compute dtype (False)."""
    table = opt_level_table(half_dtype)
    key = opt_level.upper()
    if key not in table:
        raise ValueError(
            f"Unexpected optimization level {opt_level!r}; options are "
            f"'O0', 'O1', 'O2', 'O3'.")
    p = table[key]
    if loss_scale is not None:
        if isinstance(loss_scale, str) and loss_scale != "dynamic":
            loss_scale = float(loss_scale)
        p = p.replace(loss_scale=loss_scale)
    if keep_batchnorm_fp32 is not None:
        p = p.replace(bn_dtype=torch.float32 if keep_batchnorm_fp32
                      else p.compute_dtype)
    return p
