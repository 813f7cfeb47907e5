"""Data-parallel gradient reduction, the DDP layer: port of
apex_example_tpu/parallel/distributed.py (``DDPConfig`` :43,
``allreduce_grads`` :89, ``_quantized_psum`` :133, ``broadcast_from_zero``
:161, ``reduce_mean`` :179, ``DistributedDataParallel`` :184, ``Reducer``
:216).

The port writes its own reductions on ``torch.distributed``'s
``all_reduce`` (SUM, MAX) and ``broadcast``, one for one with the JAX
package's ``psum``, ``pmax`` and masked ``psum``.  Library stand-ins
(``torch.nn.parallel.DistributedDataParallel``, ``torch.distributed.nn``)
would reduce with other semantics: hooks firing per bucket during the
backward, no pre-divide, no int8 exchange.

:func:`allreduce_grads` reduces after the backward, as apex's
``delay_allreduce=True`` does and as the JAX step's ``psum`` at the end of
the step does: one all-reduce per gradient dtype, over the grads of that
dtype flattened into one buffer, then copied back in place (the
optimizer's device tables point at the grads' storage).  ``message_size``
and ``delay_allreduce`` are accepted and recorded; they change nothing.
The grads it takes are each process's own: torch's autograd never sums
across processes, so the JAX function's ``already_reduced`` has no
counterpart.

:func:`all_reduce_sum` is the differentiable sum across processes:
forward an all-reduce, backward an all-reduce of the cotangent (the
transpose of ``psum`` is ``psum``).  SyncBatchNorm's composite branch
merges its statistics through it, so that each process's backward gets
every process's terms.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from apex_example_tpu_torch.parallel.mesh import (DATA_AXIS, axis_size,
                                                  group_of)
from apex_example_tpu_torch.quant import core as qcore


@dataclasses.dataclass(frozen=True)
class DDPConfig:
    """apex.parallel.DistributedDataParallel's reduction options.

    ``gradient_average`` divides the sum by the world size;
    ``gradient_predivide_factor`` f divides each process's grads by f
    before the sum and the sum by world / f after it (headroom for fp16
    sums); ``allreduce_always_fp32`` reduces in fp32 and casts back.

    ``quantized_allreduce``: the exchange in int8 (EQuARX, PAPERS.md).
    Per ``quant_chunk`` elements of each gradient tensor the processes
    agree on one max-abs scale (a MAX all-reduce), round their chunk onto
    it (to nearest, ties to even), sum the integers in int32 and multiply
    the sum by the scale.  Each process adds at most scale / 2 of rounding
    per element, so ``|quantized - exact| <= world * scale / 2``.  The
    scaling and the sum run in fp32 whatever ``allreduce_always_fp32``
    says, and the result is cast to the gradient's dtype.
    """
    gradient_average: bool = True
    gradient_predivide_factor: float = 1.0
    allreduce_always_fp32: bool = False
    quantized_allreduce: bool = False
    quant_chunk: int = 1024
    # accepted and recorded; the reduction is always after the backward
    delay_allreduce: bool = True
    message_size: int = 10_000_000


class AllReduceSum(torch.autograd.Function):
    """Sum over the processes of a group; its backward sums the
    cotangents the same way."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        out = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ctx.group)
        return out, None


def all_reduce_sum(x: torch.Tensor, axis_name=DATA_AXIS) -> torch.Tensor:
    """``lax.psum(x, axis_name)``: the sum over the group, differentiable
    (the backward sums the cotangents over the group)."""
    return AllReduceSum.apply(x, group_of(axis_name))


def all_reduce_max(x: torch.Tensor, axis_name=DATA_AXIS) -> torch.Tensor:
    """``lax.pmax(x, axis_name)``: the elementwise maximum over the group,
    a new tensor (not differentiable)."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group_of(axis_name))
    return out


def _by_dtype(tensors: Sequence[torch.Tensor]) -> Dict[torch.dtype, List]:
    out: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        out.setdefault(t.dtype, []).append(i)
    return out


def _copy_back(tensors: Sequence[torch.Tensor], flat: torch.Tensor) -> None:
    """Copy the pieces of ``flat`` into ``tensors`` in order, in place,
    cast to each one's dtype."""
    pieces = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(list(tensors),
                         [p.view(t.shape) for p, t in zip(pieces, tensors)])


@torch.no_grad()
def allreduce_grads(grads: Sequence[torch.Tensor],
                    config: DDPConfig = DDPConfig(),
                    axis_name=DATA_AXIS) -> Sequence[torch.Tensor]:
    """Sum ``grads`` (each process's own) over the group with apex's
    averaging, in place; returns ``grads``.  One all-reduce per dtype of
    the flattened grads (two under ``quantized_allreduce``: the scales'
    MAX and the integers' SUM)."""
    group = group_of(axis_name)
    world = dist.get_world_size(group)
    pre = config.gradient_predivide_factor
    post = (world / pre) if config.gradient_average else (1.0 / pre)
    for idx in _by_dtype(grads).values():
        gs = [grads[i] for i in idx]
        if config.quantized_allreduce:
            flat = _quantized_psum(gs, group, config)
        else:
            flat = torch.cat([g.reshape(-1) for g in gs])
            if config.allreduce_always_fp32:
                flat = flat.float()
            if pre != 1.0:
                flat.div_(pre)
            dist.all_reduce(flat, group=group)
        if post != 1.0:
            flat.div_(post)
        _copy_back(gs, flat)
    return grads


def _quantized_psum(gs: Sequence[torch.Tensor], group,
                    config: DDPConfig) -> torch.Tensor:
    """The shared-scale int8 sum of each tensor of ``gs`` (DDPConfig),
    chunked per tensor as the JAX function chunks each leaf, all of them
    in one MAX and one SUM all-reduce.  Pre-divides; returns the fp32 SUM
    of the tensors flattened in order (the caller averages)."""
    chunk = max(int(config.quant_chunk), 1)
    pre = config.gradient_predivide_factor
    rows = []
    for g in gs:
        flat = g.float().reshape(-1)
        if pre != 1.0:
            flat = flat / pre
        rows.append(F.pad(flat, (0, (-flat.numel()) % chunk)).view(-1, chunk))
    x = torch.cat(rows)
    # one scale per chunk, the same on every process: the integer sum is
    # exact, and the only error is each process's rounding
    scale = qcore.abs_max_scale(x, dim=1)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = qcore.quantize_int8(x, scale).to(torch.int32)
    dist.all_reduce(q, group=group)
    total = q.float() * scale
    out = [r.reshape(-1)[:g.numel()]
           for r, g in zip(total.split([r.shape[0] for r in rows]), gs)]
    return torch.cat(out)


@torch.no_grad()
def replicate_mean(tensors: Sequence[torch.Tensor],
                   axis_name=DATA_AXIS) -> None:
    """Average ``tensors`` (a model's running statistics) over the group
    in place: one all-reduce of the floating ones, flattened in fp32 (the
    JAX engine's ``_replicate_mean`` :532, psum / world)."""
    floats = [t for t in tensors if t.is_floating_point()]
    if not floats:
        return
    group = group_of(axis_name)
    flat = torch.cat([t.reshape(-1).float() for t in floats])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    _copy_back(floats, flat)


@torch.no_grad()
def broadcast_from_zero(tensors: Sequence[torch.Tensor],
                        axis_name=DATA_AXIS) -> Sequence[torch.Tensor]:
    """Make rank 0's values every process's, in place (DDP's broadcast of
    rank 0's parameters at construction; the JAX function is a masked
    psum)."""
    group = group_of(axis_name)
    src = 0 if group is None else dist.get_global_rank(group, 0)
    for t in tensors:
        dist.broadcast(t, src=src, group=group)
    return tensors


@torch.no_grad()
def reduce_mean(x: torch.Tensor, axis_name=DATA_AXIS) -> torch.Tensor:
    """``lax.pmean``: the mean over the group, as a new tensor (metric
    averaging)."""
    out = x.detach().float().clone()
    dist.all_reduce(out, group=group_of(axis_name))
    return out / axis_size(axis_name)


class DistributedDataParallel:
    """apex's constructor over the reduction: it holds a
    :class:`DDPConfig` and reduces grads it is given.  A torch module's
    backward could be intercepted by hooks; the reduction here runs after
    the backward, as ``delay_allreduce`` does::

        ddp = DistributedDataParallel(model, delay_allreduce=True)
        loss_fn(ddp(x), y).backward()
        ddp.allreduce([p.grad for p in model.parameters()])
    """

    def __init__(self, module: Any = None, message_size: int = 10_000_000,
                 delay_allreduce: bool = True, gradient_average: bool = True,
                 gradient_predivide_factor: float = 1.0,
                 allreduce_always_fp32: bool = False,
                 allreduce_trigger_params: Optional[Any] = None):
        del allreduce_trigger_params  # bucket tuning: no bucketing here
        self.module = module
        self.config = DDPConfig(
            gradient_average=gradient_average,
            gradient_predivide_factor=gradient_predivide_factor,
            allreduce_always_fp32=allreduce_always_fp32,
            delay_allreduce=delay_allreduce,
            message_size=message_size)

    def allreduce(self, grads: Sequence[torch.Tensor],
                  axis_name=DATA_AXIS) -> Sequence[torch.Tensor]:
        return allreduce_grads(grads, self.config, axis_name)

    def __call__(self, *args, **kwargs):
        if self.module is None:
            raise ValueError("no module wrapped")
        return self.module(*args, **kwargs)


class Reducer(DistributedDataParallel):
    """apex.parallel.Reducer: the reduction called by hand, for instance
    once every N accumulated steps; ``reduce`` is ``allreduce``."""

    def __init__(self, module: Any = None, gradient_average: bool = True):
        super().__init__(module, gradient_average=gradient_average)

    reduce = DistributedDataParallel.allreduce
