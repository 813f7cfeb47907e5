"""The O1 cast engine: port of apex_example_tpu/amp/autocast.py
(``disable_casts`` :51, ``op_dtype`` :62, ``cast_args`` :86,
``ModuleDtypes`` :97, ``module_dtypes`` :109).

apex's O1 patches torch functions so each call casts its arguments by the
op lists.  The JAX package realizes it at module boundaries instead:
:func:`op_dtype` answers what dtype an op class runs in under a policy, and
:func:`module_dtypes` bundles the answers that model builders thread into
construction.  The port keeps that contract, not ``torch.autocast``, whose
per-op semantics differ (it would, for one, run BatchNorm in the input's
dtype), so that the port's O1 computes what the JAX package's O1 computes:

  op class      O0     O1                O2                O3
  conv/dense    fp32   half              half              half
  batch_norm    fp32   fp32 (I/O+stats)  half I/O,         half
                                         fp32 stats
  layer_norm    fp32   fp32              half I/O          half I/O
  softmax       fp32   fp32              fp32              half
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Tuple

import torch

from apex_example_tpu_torch.amp import lists
from apex_example_tpu_torch.amp.policy import Policy

# apex's amp.handle.disable_casts: inside the context O1 answers fp32 for
# every op class.  Thread-local, as apex's.
_TLS = threading.local()


@contextlib.contextmanager
def disable_casts():
    """Run a region with O1's call-site casting forced to fp32."""
    saved = getattr(_TLS, "casts_disabled", False)
    _TLS.casts_disabled = True
    try:
        yield
    finally:
        _TLS.casts_disabled = saved


def op_dtype(policy: Policy, op: str,
             *operand_dtypes: torch.dtype) -> Optional[torch.dtype]:
    """The dtype op class ``op`` runs in under ``policy``; None means no
    opinion (the caller keeps its configured dtype).  Only O1 consults the
    lists."""
    if not policy.cast_at_call_sites:
        return None
    if getattr(_TLS, "casts_disabled", False):
        return torch.float32
    cls = lists.classify(op)
    if cls == "half":
        return policy.compute_dtype
    if cls == "float":
        return torch.float32
    if cls == "promote" and operand_dtypes:
        out = operand_dtypes[0]
        for d in operand_dtypes[1:]:
            out = torch.promote_types(out, d)
        return out
    return None


def cast_args(policy: Policy, op: str, *tensors: torch.Tensor):
    """Cast tensors by the op's classification (identity when the policy
    has no opinion); one tensor in, one out."""
    d = op_dtype(policy, op, *(t.dtype for t in tensors))
    out = tensors if d is None else tuple(t.to(d) for t in tensors)
    return out if len(out) != 1 else out[0]


@dataclasses.dataclass(frozen=True)
class ModuleDtypes:
    """Per-op-class dtypes of one policy, for model builders."""
    compute: torch.dtype        # conv/dense/matmul
    bn_io: torch.dtype          # BatchNorm input/output
    bn_stats: torch.dtype       # BatchNorm moments and normalization
    ln_io: torch.dtype          # LayerNorm input/output
    softmax: torch.dtype        # softmax
    param: torch.dtype          # parameter storage


def module_dtypes(policy: Policy) -> ModuleDtypes:
    """Every module-boundary dtype of ``policy``.  O2 and O3 cast the whole
    model (BN's I/O follows the compute dtype; ``keep_batchnorm_fp32``
    keeps only its statistics fp32); O1 resolves each op class through the
    lists, so the norms run wholly in fp32."""
    if policy.cast_at_call_sites:      # O1
        conv = op_dtype(policy, "conv") or policy.compute_dtype
        return ModuleDtypes(
            compute=conv,
            bn_io=op_dtype(policy, "batch_norm") or conv,
            bn_stats=op_dtype(policy, "batch_norm") or policy.bn_dtype,
            ln_io=op_dtype(policy, "layer_norm") or conv,
            softmax=op_dtype(policy, "softmax") or conv,
            param=policy.param_dtype)
    half_everything = policy.opt_level == "O3"
    return ModuleDtypes(
        compute=policy.compute_dtype,
        bn_io=policy.compute_dtype,
        bn_stats=policy.bn_dtype,
        ln_io=policy.compute_dtype,
        softmax=(policy.compute_dtype if half_everything
                 else torch.float32),
        param=policy.param_dtype)
