"""FusedAdam, FusedLAMB, FusedSGD, FusedNovoGrad and FusedAdagrad: port of
apex_example_tpu/optim/fused.py (:50, :140, :271, :198, :324).

FusedAdam is Adam (``adam_w_mode=False``: the decay folded into the
gradient) or AdamW (the default: the decay added to the update), one
kernel launch over the parameters of each dtype (ops/fused_optim.py
``adam_cuda``): one for a model of one dtype, two under amp O3.

FusedLAMB has the two-stage fused structure of apex's multi_tensor_lamb:

1. the global grad norm (ops/multi_tensor.py; over several dtypes,
   sqrt of the sum of each table's squared norm) and LAMB's clip scale
   ``where(gnorm > max_grad_norm, max_grad_norm / (gnorm + 1e-6), 1)``
   (``lamb_clip_scale`` :120);
2. stage 1 (ops/fused_optim.py): Adam-style moments and the update u, with
   per-tensor ||p||^2 and ||u||^2;
3. per tensor the trust ratio ||p|| / ||u|| where both are positive, else 1
   (``lamb_update_leaf`` :127-137);
4. stage 2: p -= lr * ratio * u.
Stages 1 and 2 launch once per parameter dtype, each with its own u.

The JAX optimizers are pure (``apply(grads, state, params)``); these are
torch optimizers that update the parameters and their state in place.
``step()`` returns the grad norm it computed (FusedLAMB, 0-d fp32 on the
parameters' device), or None where it computes none (FusedAdam); then
:meth:`grad_norm` takes one.  :meth:`clip_grad_norm` is
ops/multi_tensor.py's global-norm clip (``clip_grad_norm`` :265) over the
optimizer's own grads, for a step that clips before the update (the
Transformer-XL step, workloads.py).

On the card every call is one kernel launch (two for the clip) over the
parameters of each dtype, each reading one device table (``tables``) of
those parameters, their grads and the moments, built here once: they keep
their storage for the optimizer's life.  So the grads are allocated here,
and :meth:`zero_grad` zeroes them in place.  No step reads a device value
on the host.  On the CPU every call runs the plain versions, tensor by
tensor, as the JAX package does.

State: ``step`` (the count of steps taken), ``mu`` and ``nu`` (fp32).  The
learning rate is a float or a schedule ``f(step)`` of the 1-based step
(optim/schedules.py); the bias corrections ``c = 1 / (1 - beta^t)`` are
fp32, as the JAX optimizers compute them from their traced step.  The step
count lives on the card and each step's (lr, c1, c2) is a row of a device
table that the count indexes (``_DeviceStepCount``), so both optimizers'
``step`` take apex's ``noop_flag``: the kernels exit on the flag and the
count advances by ``1 - flag``, so a skipped step leaves the parameters,
the moments, the count and so the next step's bias corrections as JAX's
``select_tree`` leaves them (workloads.py:149-153), with no host sync.

FusedSGD is momentum SGD (Nesterov, dampening, L2 weight decay folded into
the gradient), one kernel launch over the parameters of each dtype
(ops/fused_optim.py ``sgd_cuda``): one launch for a model of one dtype, two
under amp O3, whose BatchNorm parameters stay fp32 beside half convolution
weights.  Its momentum buffers are fp32 and start at zero.  Its step count
lives on the device, and its ``step`` takes apex's ``noop_flag``: the loss
scaler's int32 non-finite flag on the card.  A flagged step leaves the
parameters, the buffers and the step count as they were, and so the
learning rate a schedule gives at that count (the JAX step selects the old
params and the whole old ``SGDState``, engine.py:250-257), with no host
sync: the kernel exits on the flag, the count advances by ``1 - flag``,
and a schedule's values stand in a device table that the count indexes.

FusedNovoGrad (layer-wise normalised momentum: one fp32 second moment per
tensor, the EMA of its squared grad norm) and FusedAdagrad (``h += g^2``)
share that device count and noop flag, one launch each per dtype, as
FusedSGD; NovoGrad's step also launches the L2 norm,
whose per-tensor sums are its second moments' input and whose global norm
its ``step`` returns.  The JAX step keeps the whole old optimizer state on
a skipped step, step count included, so NovoGrad's bias corrections and
first-step branch read the count on the card.
"""

from __future__ import annotations

from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from apex_example_tpu_torch.ops.fused_optim import (
    adagrad_cuda, adagrad_update_plain, adam_cuda, adam_update_plain,
    lamb_stage1_cuda, lamb_stage1_plain, lamb_stage2_cuda, lamb_stage2_plain,
    novograd_cuda, novograd_moment_plain, novograd_update_plain, sgd_cuda,
    sgd_update_plain, trust_ratio_plain)
from apex_example_tpu_torch.ops.multi_tensor import (
    TensorTable, clip_grad_norm_plain, multi_tensor_l2norm_cuda,
    multi_tensor_l2norm_plain, multi_tensor_scale_cuda,
    multi_tensor_scale_plain)

Schedule = Union[float, Callable[[int], float]]


def _lr_at(lr: Schedule, step: int) -> float:
    return float(lr(step) if callable(lr) else lr)


def _bias_corrections(betas, step: int, enabled: bool = True
                      ) -> Tuple[float, float]:
    """c1, c2 = 1 / (1 - beta^t) at the 1-based ``step``, in fp32, as the
    JAX package computes them (FusedAdam.apply :76-78, lamb_step_scalars
    :110-116)."""
    if not enabled:
        return 1.0, 1.0
    b1, b2 = (np.float32(b) for b in betas)
    one, t = np.float32(1.0), np.float32(step)
    return (float(one / (one - np.power(b1, t))),
            float(one / (one - np.power(b2, t))))


def lamb_step_scalars(lamb: "FusedLAMB", step: int
                      ) -> Tuple[float, float, float]:
    """(bias_c1, bias_c2, lr) at the 1-based ``step`` (:105-117): the row
    of the step's scalars on the card, in this order."""
    lr, c1, c2 = lamb._scalars_at(step)
    return c1, c2, lr


def lamb_clip_scale(lamb: "FusedLAMB", gnorm: torch.Tensor) -> torch.Tensor:
    """The gradient scale of LAMB's global-norm clip (:120-124)."""
    return torch.where(gnorm > lamb.max_grad_norm,
                       lamb.max_grad_norm / (gnorm + 1e-6),
                       torch.ones_like(gnorm))


def lamb_update_leaf(lamb: "FusedLAMB", p, g, m, v, c1, c2, lr, gscale):
    """Stage 1 -> trust ratio -> stage 2 for one tensor, plain versions;
    returns (p', m', v') as new tensors (:127-137)."""
    u, mo, vo, p_sq, u_sq = lamb_stage1_plain(
        p, g, m, v, beta1=lamb.betas[0], beta2=lamb.betas[1], eps=lamb.eps,
        weight_decay=lamb.weight_decay, bias_c1=c1, bias_c2=c2,
        grad_scale=gscale)
    ratio = trust_ratio_plain(p_sq, u_sq)
    return lamb_stage2_plain(p, u, lr * ratio), mo, vo


class _ListOptimizer:
    """What the fused optimizers share: the parameter list, grads allocated
    once and zeroed in place, fp32 state lists named by ``state_names``,
    one device table per parameter dtype over (params, grads, *state), the
    grad norm, the clip, the unscale and the state dict."""

    state_names: Tuple[str, ...] = ("mu", "nu")

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule,
                 weight_decay: float):
        self.params = list(params)
        if not self.params:
            raise ValueError(f"{type(self).__name__} needs at least one "
                             f"parameter")
        self.lr, self.weight_decay = lr, weight_decay
        self.step_count = 0
        self.device = self.params[0].device
        with torch.no_grad():
            for p in self.params:
                if p.device != self.device:
                    raise ValueError(f"a parameter lies on {p.device}, "
                                     f"another on {self.device}")
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            for name in self.state_names:
                setattr(self, name, [torch.zeros_like(p, dtype=torch.float32)
                                     for p in self.params])
        # parameter indices by dtype, in order of first appearance
        by_dtype: Dict[torch.dtype, list] = {}
        for i, p in enumerate(self.params):
            by_dtype.setdefault(p.dtype, []).append(i)
        self.groups = list(by_dtype.values())
        self.tables = []
        if self.device.type != "cpu":      # the kernels, or their refusal
            lists = [self.params, self.grads] + [
                getattr(self, name) for name in self.state_names]
            self.tables = [TensorTable([[lst[i] for i in idx]
                                        for lst in lists])
                           for idx in self.groups]

    @property
    def grads(self):
        return [p.grad for p in self.params]

    def zero_grad(self) -> None:
        """Zero every grad in place: its storage stays where the device
        table points."""
        with torch.no_grad():
            torch._foreach_zero_(self.grads)

    def grad_norm(self) -> torch.Tensor:
        """The global L2 norm of the grads (0-d fp32): one L2-norm launch
        per device table."""
        if not self.tables:
            return multi_tensor_l2norm_plain(self.grads)[0]
        norms = [multi_tensor_l2norm_cuda(t, index=1)[0] for t in self.tables]
        if len(norms) == 1:
            return norms[0]
        return torch.sqrt(sum(n * n for n in norms))

    @torch.no_grad()
    def clip_grad_norm(self, max_norm: float,
                       eps: float = 1e-6) -> torch.Tensor:
        """Scale the grads in place by min(1, max_norm / (norm + eps)), the
        norm over every grad: one L2-norm and one scale launch per device
        table, the scale reading the global norm on the card.  Returns the
        norm before the clip (0-d fp32)."""
        if not self.tables:
            return clip_grad_norm_plain(self.grads, max_norm, eps)
        total = self.grad_norm()
        for table in self.tables:
            multi_tensor_scale_cuda(table, 1, 1, norm=total,
                                    max_norm=max_norm, eps=eps)
        return total

    @torch.no_grad()
    def unscale_grads(self, inv_scale: torch.Tensor) -> torch.Tensor:
        """Multiply the grads in place by the 0-d fp32 ``inv_scale`` (read
        on the device); returns a 0-d int32 on the grads' device, 1 when an
        unscaled grad element is inf or nan.  One scale launch per device
        table; the plain version on the CPU."""
        if not self.tables:
            outs, finite = multi_tensor_scale_plain(self.grads, inv_scale,
                                                    flag_output=True)
            for g, out in zip(self.grads, outs):
                g.copy_(out)
            return (~finite).to(torch.int32)
        flags = [multi_tensor_scale_cuda(t, 1, 1, scale_t=inv_scale,
                                         flag_output=True)
                 for t in self.tables]
        flag = flags[0]
        for f in flags[1:]:
            flag = torch.maximum(flag, f)
        return flag

    def state_dict(self) -> Dict:
        out = {"step": self.step_count}
        for name in self.state_names:
            out[name] = [t.detach().clone() for t in getattr(self, name)]
        return out

    def load_state_dict(self, state: Dict) -> None:
        """Copy a :meth:`state_dict` in, into the existing state storage."""
        for name in self.state_names:
            if len(state[name]) != len(getattr(self, name)):
                raise ValueError(f"state holds {len(state[name])} {name} "
                                 f"moments, the optimizer "
                                 f"{len(getattr(self, name))}")
        with torch.no_grad():
            for name in self.state_names:
                for dst, src in zip(getattr(self, name), state[name]):
                    dst.copy_(src)
        self.step_count = int(state["step"])


class _DeviceStepCount:
    """The step count on the device, for the optimizers, whose ``step``
    all take apex's ``noop_flag``: the count advances by ``1 - flag`` on the
    card, and the scalars a step takes from it (the schedule's learning
    rate; Adam's, LAMB's and NovoGrad's bias corrections) stand in a device
    table of one row per step, built on the host ahead of the count and
    indexed by it there, so a flagged step changes nothing and no step
    reads the device."""

    skips_on_flag = True        # step() takes the scaler's noop flag

    def _init_step_count(self, table: bool) -> None:
        """The count at 0 and, where the steps read ``table``, its first
        rows, built now so that no step allocates them."""
        self.step_t = torch.zeros((), dtype=torch.int32, device=self.device)
        self._step_table: Optional[torch.Tensor] = None
        self._attempts = 0
        if table:
            self._step_row()

    @property
    def step_count(self) -> int:
        """The count of steps taken (reads the device)."""
        return int(self.step_t)

    @step_count.setter
    def step_count(self, value: int) -> None:
        if hasattr(self, "step_t"):          # (not yet in the base __init__)
            self.step_t.fill_(int(value))
            self._attempts = max(self._attempts, int(value))

    def _scalars_at(self, step: int) -> Sequence[float]:
        """The per-step scalars at the 1-based ``step``."""
        raise NotImplementedError

    def _step_row(self) -> torch.Tensor:
        """The scalars of the next step, fp32 [k] on the device: the
        table's row at the device step count.  The table grows on the host
        ahead of the count (at least as many rows as steps attempted) and
        crosses to the device without a sync."""
        need = max(self._attempts, 1)
        if self._step_table is None or self._step_table.shape[0] < need:
            n = max(2 * need, 64)
            host = torch.tensor([list(self._scalars_at(s))
                                 for s in range(1, n + 1)],
                                dtype=torch.float32)
            if self.device.type == "cuda":
                host = host.pin_memory()
            self._step_table = host.to(self.device, non_blocking=True)
        return torch.index_select(self._step_table, 0,
                                  self.step_t.view(1).long()).view(-1)

    def _count_step(self, noop_flag: Optional[torch.Tensor]) -> None:
        if noop_flag is None:
            self.step_t += 1
        else:
            self.step_t += 1 - noop_flag


class _ScheduledLR(_DeviceStepCount):
    """A learning rate that is a float (a host scalar) or a schedule read
    from the device table at the count."""

    def _scalars_at(self, step: int) -> Sequence[float]:
        return (_lr_at(self.lr, step),)

    def lr_tensor(self) -> Optional[torch.Tensor]:
        """The learning rate of the next step, a one-element fp32 tensor on
        the device: the schedule at the device step count + 1.  None for a
        float ``lr``."""
        return self._step_row() if callable(self.lr) else None

    def _update(self, kernel, plain, state: List[torch.Tensor], hyper: Dict,
                noop_flag: Optional[torch.Tensor]) -> None:
        """One step of an optimizer with one fp32 state list: ``kernel``
        over each device table (the lr from the card under a schedule), or
        ``plain(p, g, s, lr=, **hyper) -> (p', s')`` tensor by tensor on
        the CPU, where a set ``noop_flag`` keeps p and s; then the count."""
        self._attempts += 1
        lr_t = self.lr_tensor()
        if self.tables:
            for table in self.tables:
                kernel(table, lr=0.0 if lr_t is not None else self.lr,
                       lr_t=lr_t, noop_flag=noop_flag, **hyper)
        else:
            lr = lr_t if lr_t is not None else self.lr
            keep = None if noop_flag is None else noop_flag != 0
            for p, s in zip(self.params, state):
                po, so = plain(p, p.grad, s, lr=lr, **hyper)
                if keep is not None:
                    po, so = torch.where(keep, p, po), torch.where(keep, s, so)
                p.copy_(po)
                s.copy_(so)
        self._count_step(noop_flag)


class _AdamScalars(_DeviceStepCount):
    """Adam's and LAMB's per-step row on the card: (lr, c1, c2)."""

    bias_correction = True

    def _scalars_at(self, step: int) -> Sequence[float]:
        c1, c2 = _bias_corrections(self.betas, step, self.bias_correction)
        return (_lr_at(self.lr, step), c1, c2)

    def _begin_step(self) -> torch.Tensor:
        """The row of the step about to run."""
        self._attempts += 1
        return self._step_row()

    def _copy_plain(self, outs, noop_flag) -> None:
        """Write the plain versions' ``(p', m', v')`` per parameter (an
        iterable, consumed one parameter at a time) in place; a set
        ``noop_flag`` keeps the old values."""
        keep = None if noop_flag is None else noop_flag != 0
        for dsts, srcs in zip(zip(self.params, self.mu, self.nu), outs):
            for dst, src in zip(dsts, srcs):
                dst.copy_(src if keep is None else torch.where(keep, dst,
                                                               src))


class FusedAdam(_AdamScalars, _ListOptimizer):
    """Adam/AdamW over a list of parameters, updated in place.  The
    constructor mirrors the JAX one (and apex's): ``adam_w_mode=True`` is
    AdamW, False classic Adam; amsgrad is refused, as there.  The step
    count lives on the device and ``step`` takes the noop flag (see the
    module docstring)."""

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule = 1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adam_w_mode: bool = True,
                 amsgrad: bool = False):
        if amsgrad:
            raise ValueError("FusedAdam does not support amsgrad (parity "
                             "with the reference)")
        super().__init__(params, lr, weight_decay)
        self.betas, self.eps = tuple(betas), eps
        self.adam_w_mode = adam_w_mode
        self._init_step_count(True)

    @torch.no_grad()
    def step(self, noop_flag: Optional[torch.Tensor] = None) -> None:
        """One Adam step over the grads in ``p.grad``; ``noop_flag`` (0-d
        int32 on the device, nonzero: skip) is apex's.  Takes no norm."""
        scal = self._begin_step()
        hyper = dict(beta1=self.betas[0], beta2=self.betas[1], eps=self.eps,
                     weight_decay=self.weight_decay,
                     adam_w_mode=self.adam_w_mode)
        if self.tables:
            for table in self.tables:
                adam_cuda(table, scalars_t=scal, noop_flag=noop_flag,
                          **hyper)
        else:
            lr, c1, c2 = scal
            self._copy_plain(
                (adam_update_plain(p, p.grad, m, v, lr=lr, bias_c1=c1,
                                   bias_c2=c2, **hyper)
                 for p, m, v in zip(self.params, self.mu, self.nu)),
                noop_flag)
        self._count_step(noop_flag)


class FusedLAMB(_AdamScalars, _ListOptimizer):
    """LAMB over a list of parameters, updated in place (see the module
    docstring).  Defaults follow the JAX package's (and apex's).  The step
    count lives on the device and ``step`` takes the noop flag."""

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule = 1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.01, max_grad_norm: float = 1.0,
                 bias_correction: bool = True):
        super().__init__(params, lr, weight_decay)
        self.betas, self.eps = tuple(betas), eps
        self.max_grad_norm = max_grad_norm
        self.bias_correction = bias_correction
        self._u = [torch.empty(t.total, dtype=torch.float32,
                               device=self.device) for t in self.tables]
        self._init_step_count(True)

    @property
    def clips(self) -> bool:
        return bool(self.max_grad_norm and self.max_grad_norm > 0)

    @torch.no_grad()
    def step(self, noop_flag: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        """One LAMB step over the grads in ``p.grad``; ``noop_flag`` as
        FusedAdam's.  Returns the global grad norm before LAMB's clip (0-d
        fp32; not finite on a step that overflowed, which the flag
        skips)."""
        scal = self._begin_step()
        if self.tables:
            gnorm = self._step_cuda(scal, noop_flag)
        else:
            gnorm = self._step_plain(scal, noop_flag)
        self._count_step(noop_flag)
        return gnorm

    def _step_cuda(self, scal, noop_flag) -> torch.Tensor:
        gnorm = self.grad_norm()
        for table, u in zip(self.tables, self._u):
            _, ratio = lamb_stage1_cuda(
                table, u, gnorm if self.clips else None,
                beta1=self.betas[0], beta2=self.betas[1], eps=self.eps,
                weight_decay=self.weight_decay, scalars_t=scal,
                max_grad_norm=float(self.max_grad_norm or 0.0),
                noop_flag=noop_flag)
            lamb_stage2_cuda(table, u, ratio, scal, noop_flag=noop_flag)
        return gnorm

    def _step_plain(self, scal, noop_flag) -> torch.Tensor:
        lr, c1, c2 = scal
        gnorm, _ = multi_tensor_l2norm_plain(self.grads)
        gscale = lamb_clip_scale(self, gnorm) if self.clips else 1.0
        self._copy_plain(
            (lamb_update_leaf(self, p, p.grad, m, v, c1, c2, lr, gscale)
             for p, m, v in zip(self.params, self.mu, self.nu)), noop_flag)
        return gnorm


class FusedSGD(_ScheduledLR, _ListOptimizer):
    """Momentum SGD over a list of parameters, updated in place (see the
    module docstring).  The constructor mirrors the JAX one (and apex's):
    zero-initialized fp32 momentum buffers, so with ``dampening`` 0 the
    first step equals torch's (whose first buffer is the gradient)."""

    state_names = ("momentum_buffer",)

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule = 1e-2,
                 momentum: float = 0.0, weight_decay: float = 0.0,
                 dampening: float = 0.0, nesterov: bool = False):
        super().__init__(params, lr, weight_decay)
        self.momentum, self.dampening = momentum, dampening
        self.nesterov = nesterov
        self._init_step_count(callable(lr))

    @torch.no_grad()
    def step(self, noop_flag: Optional[torch.Tensor] = None) -> None:
        """One SGD step over the grads in ``p.grad``; ``noop_flag`` (0-d
        int32 on the device, nonzero: skip) is apex's.  Takes no norm."""
        self._update(sgd_cuda, sgd_update_plain, self.momentum_buffer,
                     dict(momentum=self.momentum,
                          weight_decay=self.weight_decay,
                          dampening=self.dampening, nesterov=self.nesterov),
                     noop_flag)


class FusedAdagrad(_ScheduledLR, _ListOptimizer):
    """Adagrad over a list of parameters, updated in place: ``h += g^2``,
    ``p -= lr g / (sqrt(h) + eps)``, one kernel launch over the parameters
    of each dtype (ops/fused_optim.py ``adagrad_cuda``).  The constructor
    mirrors the JAX one (:324, and apex's): weight decay folded into the
    gradient, or added to the update under ``adagrad_w_mode``; fp32 sums of
    squares ``sum_sq`` that start at zero.  The step count lives on the
    device and ``step`` takes the noop flag, as FusedSGD's."""

    state_names = ("sum_sq",)

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule = 1e-2,
                 eps: float = 1e-10, weight_decay: float = 0.0,
                 adagrad_w_mode: bool = False):
        super().__init__(params, lr, weight_decay)
        self.eps, self.adagrad_w_mode = eps, adagrad_w_mode
        self._init_step_count(callable(lr))

    @torch.no_grad()
    def step(self, noop_flag: Optional[torch.Tensor] = None) -> None:
        """One Adagrad step over the grads in ``p.grad``; ``noop_flag`` as
        FusedSGD's.  Takes no norm."""
        self._update(adagrad_cuda, adagrad_update_plain, self.sum_sq,
                     dict(eps=self.eps, weight_decay=self.weight_decay,
                          adagrad_w_mode=self.adagrad_w_mode), noop_flag)


class FusedNovoGrad(_DeviceStepCount, _ListOptimizer):
    """NovoGrad over a list of parameters, updated in place: layer-wise
    normalised momentum SGD.  The constructor mirrors the JAX one (:198,
    and apex's): betas (0.95, 0.98), eps 1e-8, ``grad_averaging``,
    ``bias_correction``, ``init_zero=False`` (the first step's second
    moment is the squared grad norm itself), L2 decay added to the
    normalised gradient; amsgrad refused.

    The first moment ``mu`` is fp32 per element; the second moment is ONE
    fp32 per tensor (the EMA of the tensor's squared grad norm), kept as one
    [T] vector per parameter dtype and shown as ``nu``, 0-d views in
    parameter order (the JAX state's per-leaf scalars).  A step is, per
    dtype, one L2-norm launch (the per-tensor squared norms, and the global
    grad norm that ``step`` returns) and one NovoGrad call (a per-tensor
    kernel for v, then the chunk kernel).  The step count lives on the
    device and ``step`` takes the noop flag, as FusedSGD's; each step's
    ``(lr * c1, c2)`` is a row of the device table that the count indexes,
    and the first-step branch is the count being 0 there."""

    state_names = ("mu",)

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule = 1e-3,
                 betas=(0.95, 0.98), eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_averaging: bool = True,
                 bias_correction: bool = True, init_zero: bool = False,
                 amsgrad: bool = False):
        if amsgrad:
            raise ValueError("FusedNovoGrad does not support amsgrad "
                             "(parity with the reference)")
        super().__init__(params, lr, weight_decay)
        self.betas, self.eps = tuple(betas), eps
        self.grad_averaging = grad_averaging
        self.bias_correction = bias_correction
        self.init_zero = init_zero
        self._v = [torch.zeros(len(idx), dtype=torch.float32,
                               device=self.device) for idx in self.groups]
        self._init_step_count(True)

    @property
    def grad_avg_coeff(self) -> float:
        """``1 - beta1`` under grad averaging (rounded to fp32 from the
        exact value, as the JAX optimizer's Python float), else 1."""
        return (float(np.float32(1.0 - self.betas[0]))
                if self.grad_averaging else 1.0)

    @property
    def nu(self) -> List[torch.Tensor]:
        """The second moments, one 0-d fp32 view per parameter, in
        parameter order."""
        out: List[Optional[torch.Tensor]] = [None] * len(self.params)
        for v, idx in zip(self._v, self.groups):
            for j, i in enumerate(idx):
                out[i] = v[j]
        return out

    def _scalars_at(self, step: int) -> Sequence[float]:
        """(lr * c1, c2) at the 1-based ``step``, fp32 as the JAX
        optimizer computes them (:236-244)."""
        c1, c2 = _bias_corrections(self.betas, step, self.bias_correction)
        return (float(np.float32(_lr_at(self.lr, step)) * np.float32(c1)),
                c2)

    @torch.no_grad()
    def step(self, noop_flag: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One NovoGrad step over the grads in ``p.grad``; ``noop_flag`` as
        FusedSGD's.  Returns the global grad norm (0-d fp32), from the same
        L2-norm launch as the second moments."""
        self._attempts += 1
        scal = self._step_row()
        hyper = dict(beta1=self.betas[0], weight_decay=self.weight_decay,
                     grad_avg_coeff=self.grad_avg_coeff)
        if self.tables:
            norms = []
            for table, v in zip(self.tables, self._v):
                norm, sq = multi_tensor_l2norm_cuda(table, index=1)
                novograd_cuda(table, sq, v, scal, self.step_t,
                              beta2=self.betas[1], eps=self.eps,
                              init_zero=self.init_zero, noop_flag=noop_flag,
                              **hyper)
                norms.append(norm)
            gnorm = (norms[0] if len(norms) == 1
                     else torch.sqrt(sum(n * n for n in norms)))
        else:
            gnorm = self._step_plain(scal, hyper, noop_flag)
        self._count_step(noop_flag)
        return gnorm

    def _step_plain(self, scal, hyper, noop_flag) -> torch.Tensor:
        gnorm, sq = multi_tensor_l2norm_plain(self.grads)
        keep = None if noop_flag is None else noop_flag != 0
        for v, idx in zip(self._v, self.groups):
            vn, inv = novograd_moment_plain(
                sq[idx], v, beta2=self.betas[1], eps=self.eps, c2=scal[1],
                first_step=self.step_t == 0, init_zero=self.init_zero)
            for j, i in enumerate(idx):
                p, m = self.params[i], self.mu[i]
                po, mo = novograd_update_plain(p, p.grad, m, inv_denom=inv[j],
                                               lr_c1=scal[0], **hyper)
                if keep is not None:
                    po, mo = torch.where(keep, p, po), torch.where(keep, m, mo)
                p.copy_(po)
                m.copy_(mo)
            v.copy_(vn if keep is None else torch.where(keep, v, vn))
        return gnorm

    def state_dict(self) -> Dict:
        out = super().state_dict()
        out["nu"] = [t.detach().clone() for t in self.nu]
        return out

    def load_state_dict(self, state: Dict) -> None:
        """Copy a :meth:`state_dict` in, into the existing state storage;
        ``nu`` holds one 0-d second moment per parameter."""
        if len(state["nu"]) != len(self.params):
            raise ValueError(f"state holds {len(state['nu'])} nu moments, "
                             f"the optimizer {len(self.params)}")
        super().load_state_dict(state)
        with torch.no_grad():
            for dst, src in zip(self.nu, state["nu"]):
                dst.copy_(src)
