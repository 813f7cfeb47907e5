"""SyncBatchNorm: port of apex_example_tpu/parallel/sync_batchnorm.py
(``SyncBatchNorm`` :35-161, ``convert_syncbn_model`` :164).

Normalizes over the last axis of a channels-last tensor (..., C), as the
JAX module does, with torch.nn.BatchNorm2d's semantics: biased variance in
the normalization, the unbiased estimate in ``var``, ``momentum`` the
weight of the new statistic.  The moments are one pass centred on the
running mean ``c`` (:106), accumulated in fp32 whatever the input dtype:
exact for any constant shift, and free of cancellation while ``c`` tracks
the batch mean.  A non-finite running mean (a NaN batch's average, which
the JAX module keeps as well) centres on 0, so the next batch's
statistics are its own and finite, as JAX's are.

Dtypes: ``dtype`` is the I/O dtype (None: the input's), ``stats_dtype``
that of the normalization arithmetic (None: fp32; ``keep_batchnorm_fp32``),
and the parameters ``scale`` and ``bias`` are ``param_dtype`` (fp32); the
running ``mean`` and ``var`` are fp32 buffers, not parameters.  In eval
mode the running averages normalize.

``replay_centre`` is None but while a rematerialised block recomputes its
forward in the backward (models/resnet.py): then it holds the running
mean that the forward read, the recompute centres its moments on it, and
the running statistics are not updated a second time.

The training branch is the JAX composite form, in plain torch ops (the JAX
package computes it in XLA, so no library BatchNorm kernel stands in for
it), unless the module is built with ``fused_kernel=True``: then it goes
through ops/batch_norm.py ``batch_norm_train``, the statistics and
backward-sum kernels.  The ResNet builds its norms without it, as the JAX
ResNet does (models/resnet.py).

``axis_name`` (parallel/mesh.py: ``"data"`` for the default process
group, a DataMesh or a ProcessGroup) makes the training statistics the
whole group's batch, as N-process SyncBN equals full-batch BN.  The
composite branch sums each process's moments about ``c`` (the same on
every process) with one ``all_reduce_sum``, the differentiable
all-reduce, so each process's backward gets the other processes' terms.
That gives the statistics of the JAX branch's Welford merge (:128-143) in
one all-reduce a direction where its two psums run one after the other,
and in one process it is the plain branch's arithmetic exactly.  The fused
branch sums the kernels' moments and backward sums across the group
(ops/batch_norm.py).  Either way each process's dx is the full batch's,
and its dscale and dbias are its own share, which the data-parallel
step's average over the processes makes the full batch's.
:func:`convert_syncbn_model` binds a group to every SyncBatchNorm of a
model.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from apex_example_tpu_torch.ops.batch_norm import batch_norm_train
from apex_example_tpu_torch.parallel.distributed import all_reduce_sum
from apex_example_tpu_torch.parallel.mesh import DATA_AXIS, axis_size


class SyncBatchNorm(nn.Module):
    """BatchNorm over the last axis of x (..., C)."""

    def __init__(self, num_features: int, momentum: float = 0.1,
                 epsilon: float = 1e-5,
                 dtype: Optional[torch.dtype] = None,
                 stats_dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32,
                 use_bias: bool = True, use_scale: bool = True,
                 fused_kernel: bool = False,
                 axis_name=None, device=None):
        super().__init__()
        self.axis_name = axis_name
        self.num_features = num_features
        self.momentum, self.epsilon = momentum, epsilon
        self.dtype, self.stats_dtype = dtype, stats_dtype
        self.fused_kernel = fused_kernel
        kw = {"dtype": param_dtype, "device": device}
        self.scale = (nn.Parameter(torch.ones(num_features, **kw))
                      if use_scale else None)
        self.bias = (nn.Parameter(torch.zeros(num_features, **kw))
                     if use_bias else None)
        self.register_buffer("mean", torch.zeros(
            num_features, dtype=torch.float32, device=device))
        self.register_buffer("var", torch.ones(
            num_features, dtype=torch.float32, device=device))
        self.replay_centre: Optional[torch.Tensor] = None

    def _affine(self, x: torch.Tensor):
        feat = self.num_features
        scale = (self.scale.float() if self.scale is not None
                 else torch.ones(feat, device=x.device))
        bias = (self.bias.float() if self.bias is not None
                else torch.zeros(feat, device=x.device))
        return scale, bias

    def forward(self, x: torch.Tensor,
                use_running_average: Optional[bool] = None) -> torch.Tensor:
        use_ra = (not self.training if use_running_average is None
                  else use_running_average)
        md = self.stats_dtype or torch.float32
        out_dtype = self.dtype or x.dtype
        scale, bias = self._affine(x)
        if use_ra:
            inv = torch.rsqrt(self.var + self.epsilon).to(md)
            y = (x.to(md) - self.mean.to(md)) * (inv * scale.to(md))
            return (y + bias.to(md)).to(out_dtype)

        replay = self.replay_centre is not None
        # A non-finite running mean (after a NaN batch) centres on 0: the
        # moments stay those of this batch, as the JAX module's, which
        # never reads the running mean in training.
        c = torch.nan_to_num(self.replay_centre if replay
                             else self.mean.float(), nan=0.0, posinf=0.0,
                             neginf=0.0)
        axis = self.axis_name
        n_local = x.numel() // x.shape[-1]
        n = n_local * (axis_size(axis) if axis is not None else 1)
        if self.fused_kernel:
            y, mean, var = batch_norm_train(x, scale, bias, c, self.epsilon,
                                            md, out_dtype, axis)
        else:
            dims = tuple(range(x.dim() - 1))
            xc = x.float() - c
            sums = torch.stack([xc.sum(dims), (xc * xc).sum(dims)])
            if axis is not None:               # one differentiable sum
                sums = all_reduce_sum(sums, axis)
            s, ss = sums.unbind(0)
            mean_c = s / n                             # E[x] - c
            m2 = ss - mean_c * mean_c * n
            mean = c + mean_c
            # E[x^2] - E[x]^2 can go fractionally negative under rounding.
            var = torch.clamp(m2 / n, min=0.0)
            inv = torch.rsqrt(var + self.epsilon).to(md)
            y = (x.to(md) - mean.to(md)) * (inv * scale.to(md))
            y = y + bias.to(md)

        if replay:
            return y.to(out_dtype)
        with torch.no_grad():
            m = self.momentum
            unbiased = var.detach() * (float(n) / max(n - 1, 1))
            self.mean.copy_((1 - m) * self.mean + m * mean.detach())
            self.var.copy_((1 - m) * self.var + m * unbiased)
        return y.to(out_dtype)


def convert_syncbn_model(module: nn.Module, axis_name=DATA_AXIS
                         ) -> nn.Module:
    """apex.parallel.convert_syncbn_model: bind ``axis_name`` (a group,
    parallel/mesh.py) to every SyncBatchNorm of ``module``, recursively,
    in place, and to its ``bn_axis_name``; returns ``module``.  A model
    without ``bn_axis_name`` (not built from the port's norm layers) is
    refused, as the JAX function refuses it."""
    if not hasattr(module, "bn_axis_name"):
        raise TypeError(
            f"{type(module).__name__} does not expose bn_axis_name; "
            "only models built with framework norm layers can be converted")
    module.bn_axis_name = axis_name
    for m in module.modules():
        if isinstance(m, SyncBatchNorm):
            m.axis_name = axis_name
    return module
