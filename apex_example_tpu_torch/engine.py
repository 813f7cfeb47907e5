"""The train and eval steps: port of apex_example_tpu/engine.py
(``TrainState`` :48, ``create_train_state`` :57, ``cross_entropy_loss``
:84, ``make_train_step`` :106, ``make_eval_step`` :299,
``make_sharded_train_step`` :320, ``_replicate_mean`` :532).

One step follows the JAX step's amp protocol (:160-291): zero the grads ->
forward -> loss -> ``scale_loss`` -> backward -> ``unscale_grads`` (the
multi-tensor scale kernel over the optimizer's grads, and its int32
non-finite flag on the card) -> the optimizer step -> ``update_scaler``.
With the identity scaler (a static scale of 1.0: O0, and O1-O3 in bf16)
the scale and unscale do nothing and launch nothing.  Under dynamic
scaling a non-finite grad skips the step the way the JAX step selects the
old params and the whole old optimizer state (:250-257): the optimizer
takes the flag as apex's ``noop_flag`` (every fused optimizer of
optim/fused.py) and leaves the parameters, its buffers and its step count
untouched; the scale halves.  Nothing in the step reads
a device value on the host.  BN running statistics are not rolled back,
as in JAX and apex.

Metrics, as the JAX step's: ``loss``, ``scale`` (after the update),
``grads_finite``, ``grad_norm`` (the global norm of the unscaled grads:
FusedLAMB's step takes it for its clip and FusedNovoGrad's for its second
moments; for the others it is one L2-norm launch after the step, which
leaves the grads as they are) and, where the
labels are one tensor of classes, ``top1`` (percent of the batch).

The data-parallel step (``make_sharded_train_step``) is the same step in
each process of a group (parallel/mesh.py) on that process's rows of the
global batch, with the JAX sharded step's collectives in its order: the
local forward and backward, ``allreduce_grads`` (parallel/distributed.py,
apex's averaging options), the unscale with its flag, the optimizer's
noop-flag step, then the loss and top-1 averaged over the processes and
every BatchNorm running statistic averaged over them (``_replicate_mean``:
a SyncBatchNorm's are equal already, a local BatchNorm's would drift).
After the all-reduce the grads, and so the flag and the update, are the
same in every process.  No host sync is added.

Gradient accumulation (``grad_accum=K``, :183-229): the batch splits into
K microbatches of ``batch // K`` consecutive rows (every tensor of ``y``
too, so MLM's (labels, weights) split with the ids), each runs its
forward and backward, and the grads become the mean of the microbatches'
fp32 grads in the parameters' dtype (:class:`GradAccumulator`).  Then,
once, the all-reduce, the unscale with its flag, the optimizer step and
the scaler update, in the order above.  The loss is the mean of the
microbatch losses (MLM's each normalised by its own weight count, as
JAX's are) and top-1 the mean of their top-1s, each summed in microbatch
order.  BatchNorm running statistics update on every microbatch's
forward.

The JAX state is an immutable pytree that each step replaces; here the
model, optimizer and scaler update in place and the step returns the same
``TrainState`` with its counter advanced.  The grads are zeroed in place
before each backward, so their storage stays where the optimizer's device
table points.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from apex_example_tpu_torch import amp
from apex_example_tpu_torch.amp.policy import Policy
from apex_example_tpu_torch.amp.scaler import ScalerState
from apex_example_tpu_torch.ops.multi_tensor import (
    TensorTable, multi_tensor_axpby_cuda, multi_tensor_axpby_plain,
    multi_tensor_scale_cuda, multi_tensor_scale_plain)
from apex_example_tpu_torch.ops.xentropy import softmax_cross_entropy
from apex_example_tpu_torch.parallel.distributed import (
    DDPConfig, allreduce_grads, reduce_mean, replicate_mean)
from apex_example_tpu_torch.parallel.mesh import DATA_AXIS
from apex_example_tpu_torch.utils.meters import accuracy


@dataclass
class TrainState:
    """What the step carries: the step count, the model (its parameters
    are the master weights, fp32 but under O3), the optimizer with its
    state, the precision policy and the loss scaler."""
    step: int
    model: nn.Module
    optimizer: Any
    policy: Policy
    scaler: ScalerState


def create_train_state(model: nn.Module, optimizer,
                       policy: Optional[Policy] = None,
                       scaler: Optional[ScalerState] = None) -> TrainState:
    """Pair a model with an optimizer built over its parameters, a policy
    (default O0) and its scaler (default ``amp.make_scaler(policy)`` on the
    parameters' device).  fp32 matrix products and convolutions run in
    full fp32, without TF32, on the card; cuDNN picks its convolution
    algorithms by timing them (``cudnn.benchmark``) at each new shape."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    policy = policy or amp.get_policy("O0")
    if scaler is None:
        scaler = amp.make_scaler(policy, device=optimizer.device)
    return TrainState(step=0, model=model, optimizer=optimizer,
                      policy=policy, scaler=scaler)


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy on fp32 logits."""
    return softmax_cross_entropy(logits.float(), labels).mean()


def batch_top1(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Percent of the batch whose argmax is the label (:294)."""
    return (logits.argmax(-1) == y).float().mean() * 100.0


class GradAccumulator:
    """The mean of a step's K microbatch grads, summed in fp32 as the JAX
    step's ``gsum`` (:203-225) and cast to each parameter's dtype, in the
    optimizer's own grads.

    fp32 grads sum in ``.grad`` itself: each backward adds into it in
    place, g0 + g1 + ..., JAX's order; :meth:`finish` scales them by 1/K
    in place (one scale launch per fp32 table).  A half grad (O3) would
    round every partial sum, so after each microbatch but the last
    :meth:`fold` adds the half grads into fp32 accumulators, acc = g +
    acc, and zeroes them (one axpby launch per half table); :meth:`finish`
    writes acc / K + g / K over the last microbatch's grads, rounded once
    to their dtype (one axpby launch).  1/K is exact for K a power of two,
    and then the mean is bitwise JAX's ``(gsum / K).astype(dtype)``; for
    other K it is within a rounding or two of it.  CPU grads take the
    kernels' plain versions."""

    def __init__(self, optimizer, k: int):
        self.k, self.opt = k, optimizer
        self.cuda = optimizer.device.type != "cpu"
        self.full = []      # fp32: (group index, grads)
        self.half = []      # half: (grads, fp32 sums, CUDA tables)
        for gi, idx in enumerate(optimizer.groups):
            grads = [optimizer.params[i].grad for i in idx]
            if grads[0].dtype == torch.float32:
                self.full.append((gi, grads))
            else:
                acc = [torch.zeros_like(g, dtype=torch.float32)
                       for g in grads]
                tables = ((TensorTable([grads, acc, acc]),
                           TensorTable([acc, grads, grads]))
                          if self.cuda else None)
                self.half.append((grads, acc, tables))

    def begin(self) -> None:
        """Zero the fp32 accumulators (the optimizer zeroes the grads)."""
        for _, acc, _ in self.half:
            torch._foreach_zero_(acc)

    @torch.no_grad()
    def fold(self) -> None:
        """After a microbatch's backward, not the last: acc += g for the
        half grads, which are then zeroed for the next backward."""
        for grads, acc, tables in self.half:
            if tables is not None:
                multi_tensor_axpby_cuda(tables[0], 1.0, 1.0)
            else:
                for a, out in zip(acc, multi_tensor_axpby_plain(
                        1.0, grads, 1.0, acc)):
                    a.copy_(out)
            torch._foreach_zero_(grads)

    @torch.no_grad()
    def finish(self) -> None:
        """After the last backward: every grad becomes the mean."""
        inv = 1.0 / self.k
        for gi, grads in self.full:
            if self.cuda:
                multi_tensor_scale_cuda(self.opt.tables[gi], 1, 1, scale=inv)
            else:
                outs, _ = multi_tensor_scale_plain(grads, inv)
                torch._foreach_copy_(grads, outs)
        for grads, acc, tables in self.half:
            if tables is not None:
                multi_tensor_axpby_cuda(tables[1], inv, inv)
            else:
                torch._foreach_copy_(grads, multi_tensor_axpby_plain(
                    inv, acc, inv, grads))


def accumulator_cache(k: int) -> Callable:
    """``accumulator(opt)``: the :class:`GradAccumulator` of ``opt`` at
    ``k`` microbatches, made at the first step and kept while the step
    runs with that optimizer."""
    kept = []

    def accumulator(opt) -> GradAccumulator:
        if not kept or kept[0].opt is not opt:
            kept[:] = [GradAccumulator(opt, k)]
        return kept[0]

    return accumulator


def split_batch(tree, k: int) -> list:
    """K microbatches of ``tree`` (a tensor or nested tuples of them), each
    ``batch // k`` consecutive rows of every tensor, as JAX's
    ``reshape(k, batch // k, ...)``."""
    if torch.is_tensor(tree):
        if tree.shape[0] % k:
            raise ValueError(f"batch {tree.shape[0]} not divisible by "
                             f"grad_accum {k}")
        return list(torch.split(tree, tree.shape[0] // k))
    return list(zip(*(split_batch(t, k) for t in tree)))


def ordered_mean(values: Sequence[torch.Tensor]) -> torch.Tensor:
    """(v0 + v1 + ...) / K, summed in order as JAX's scan carries it."""
    total = values[0]
    for v in values[1:]:
        total = total + v
    return total / len(values)


def make_train_step(loss_fn: Callable = cross_entropy_loss,
                    compute_accuracy: bool = True,
                    ddp: Optional[DDPConfig] = None, axis_name=None,
                    grad_accum: int = 1):
    """``train_step(state, (x, y)) -> (state, metrics)``; ``y`` is what
    ``loss_fn(logits, y)`` takes (for MLM, (labels, weights)).  With
    ``axis_name`` (a group) the grads are reduced over it with ``ddp``'s
    options before the unscale, and the loss and top-1 averaged over it
    (see :func:`make_sharded_train_step`).  ``grad_accum=K`` runs K
    microbatches before the one optimizer step (module docstring)."""
    ddp = ddp or DDPConfig()
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    accumulator = accumulator_cache(grad_accum)

    def forward_backward(state, x, y, with_top1: bool):
        logits = state.model(x)
        loss = loss_fn(logits, y)
        top1 = batch_top1(logits.detach(), y) if with_top1 else None
        del logits          # the loss's graph holds what the backward needs
        amp.scale_loss(loss, state.scaler).backward()
        return loss.detach(), top1

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        x, y = batch
        opt, scaler = state.optimizer, state.scaler
        with_top1 = compute_accuracy and torch.is_tensor(y)
        state.model.train()
        opt.zero_grad()
        if grad_accum == 1:
            loss, top1 = forward_backward(state, x, y, with_top1)
        else:
            acc = accumulator(opt)
            acc.begin()
            losses, top1s = [], []
            for i, (x_mb, y_mb) in enumerate(split_batch((x, y),
                                                         grad_accum)):
                loss_mb, top1_mb = forward_backward(state, x_mb, y_mb,
                                                    with_top1)
                losses.append(loss_mb)
                top1s.append(top1_mb)
                if i + 1 < grad_accum:
                    acc.fold()
            acc.finish()
            loss = ordered_mean(losses)
            top1 = ordered_mean(top1s) if with_top1 else None
        if axis_name is not None:
            # the scaled grads, as the reference's backward hooks reduce
            allreduce_grads(opt.grads, ddp, axis_name)
            loss = reduce_mean(loss, axis_name)
        found_inf = amp.unscale_grads(opt, scaler)
        if found_inf is None:
            grad_norm = opt.step()
        else:
            grad_norm = opt.step(noop_flag=found_inf)
        if grad_norm is None:
            grad_norm = opt.grad_norm()
        state.scaler = amp.update_scaler(scaler, found_inf)
        state.step += 1
        metrics = {"loss": loss, "scale": state.scaler.scale,
                   "grads_finite": (1.0 if found_inf is None
                                    else (found_inf == 0).float()),
                   "grad_norm": grad_norm}
        if top1 is not None:
            if axis_name is not None:
                top1 = reduce_mean(top1, axis_name)
            metrics["top1"] = top1
        return state, metrics

    return train_step


def make_sharded_train_step(axis_name=DATA_AXIS,
                            ddp: Optional[DDPConfig] = None,
                            loss_fn: Callable = cross_entropy_loss,
                            compute_accuracy: bool = True,
                            grad_accum: int = 1):
    """The data-parallel step: ``train_step(state, (x, y)) -> (state,
    metrics)`` run by every process of ``axis_name``'s group on its own
    rows of the global batch, the state equal in every process before and
    after.  Each step is :func:`make_train_step` with the grads reduced
    over the group (``ddp``'s options), the loss and top-1 averaged over
    it, then every running statistic of the model averaged over it.
    ``grad_accum`` splits each process's rows into microbatches, and the
    all-reduce runs once, on their mean."""
    per_rank = make_train_step(loss_fn, compute_accuracy, ddp=ddp,
                               axis_name=axis_name, grad_accum=grad_accum)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        state, metrics = per_rank(state, batch)
        replicate_mean(list(state.model.buffers()), axis_name)
        return state, metrics

    return train_step


def make_eval_step(loss_fn: Callable = cross_entropy_loss):
    """``eval_step(state, (x, y)) -> metrics``: the model in eval mode
    (BatchNorm on its running statistics), ``loss`` and the reference
    harness's ``top1`` and ``top5`` (utils/meters.accuracy)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch) -> Dict:
        x, y = batch
        state.model.eval()
        logits = state.model(x)
        loss = loss_fn(logits, y)
        k5 = min(5, logits.shape[-1])
        top1, top5 = accuracy(logits, y, topk=(1, k5))
        return {"loss": loss, "top1": top1, "top5": top5}

    return eval_step
