"""FusedAdam and FusedLAMB: port of apex_example_tpu/optim/fused.py (:50,
:140).

FusedAdam is Adam (``adam_w_mode=False``: the decay folded into the
gradient) or AdamW (the default: the decay added to the update), one
kernel over the whole parameter list (ops/fused_optim.py ``adam_cuda``).

FusedLAMB has the two-stage fused structure of apex's multi_tensor_lamb:

1. the global grad norm (ops/multi_tensor.py) and LAMB's clip scale
   ``where(gnorm > max_grad_norm, max_grad_norm / (gnorm + 1e-6), 1)``
   (``lamb_clip_scale`` :120);
2. stage 1 (ops/fused_optim.py): Adam-style moments and the update u, with
   per-tensor ||p||^2 and ||u||^2;
3. per tensor the trust ratio ||p|| / ||u|| where both are positive, else 1
   (``lamb_update_leaf`` :127-137);
4. stage 2: p -= lr * ratio * u.

The JAX optimizers are pure (``apply(grads, state, params)``); these are
torch optimizers that update the parameters and their state in place.
``step()`` returns the grad norm it computed (FusedLAMB, 0-d fp32 on the
parameters' device), or None where it computes none (FusedAdam); then
:meth:`grad_norm` takes one.  :meth:`clip_grad_norm` is
ops/multi_tensor.py's global-norm clip (``clip_grad_norm`` :265) over the
optimizer's own grads, for a step that clips before the update (the
Transformer-XL step, workloads.py).

On the card every call is one kernel launch (two for the clip) over the
whole parameter list, all reading one device table (``table``) of the
parameters, their grads and the moments, built here once: they keep their
storage for the optimizer's life.  So the grads are allocated here, and
:meth:`zero_grad` zeroes them in place.  No step reads a device value on
the host.  On the CPU every call runs the plain versions, tensor by
tensor, as the JAX package does.

State: ``step`` (the count of steps taken), ``mu`` and ``nu`` (fp32).  The
learning rate is a float or a schedule ``f(step)`` of the 1-based step
(optim/schedules.py); the bias corrections ``c = 1 / (1 - beta^t)`` are
fp32, computed on the host before each step.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple, Union

import numpy as np
import torch

from apex_example_tpu_torch.ops.fused_optim import (adam_cuda,
                                                    adam_update_plain,
                                                    lamb_stage1_cuda,
                                                    lamb_stage1_plain,
                                                    lamb_stage2_cuda,
                                                    lamb_stage2_plain,
                                                    trust_ratio_plain)
from apex_example_tpu_torch.ops.multi_tensor import (
    TensorTable, clip_grad_norm_cuda, clip_grad_norm_plain,
    multi_tensor_l2norm_cuda, multi_tensor_l2norm_plain)

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
    """(bias_c1, bias_c2, lr) at the 1-based ``step`` (:105-117)."""
    c1, c2 = _bias_corrections(lamb.betas, step, lamb.bias_correction)
    return c1, c2, _lr_at(lamb.lr, step)


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
    """What FusedAdam and FusedLAMB share: the parameter list, grads
    allocated once and zeroed in place, fp32 moments ``mu`` and ``nu``, the
    device table over (params, grads, mu, nu), the grad norm and clip, and
    the state dict."""

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule,
                 betas, eps: float, weight_decay: float):
        self.params = list(params)
        if not self.params:
            raise ValueError(f"{type(self).__name__} needs at least one "
                             f"parameter")
        self.lr, self.betas, self.eps = lr, tuple(betas), eps
        self.weight_decay = weight_decay
        self.step_count = 0
        self.device = self.params[0].device
        with torch.no_grad():
            for p in self.params:
                if p.device != self.device:
                    raise ValueError(f"a parameter lies on {p.device}, "
                                     f"another on {self.device}")
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            self.mu = [torch.zeros_like(p, dtype=torch.float32)
                       for p in self.params]
            self.nu = [torch.zeros_like(p, dtype=torch.float32)
                       for p in self.params]
        self.table = None
        if self.device.type != "cpu":      # the kernels, or their refusal
            self.table = TensorTable([self.params, self.grads, self.mu,
                                      self.nu])

    @property
    def grads(self):
        return [p.grad for p in self.params]

    def zero_grad(self) -> None:
        """Zero every grad in place: its storage stays where the device
        table points."""
        with torch.no_grad():
            torch._foreach_zero_(self.grads)

    def grad_norm(self) -> torch.Tensor:
        """The global L2 norm of the grads (0-d fp32)."""
        if self.table is not None:
            return multi_tensor_l2norm_cuda(self.table, index=1)[0]
        return multi_tensor_l2norm_plain(self.grads)[0]

    @torch.no_grad()
    def clip_grad_norm(self, max_norm: float,
                       eps: float = 1e-6) -> torch.Tensor:
        """Scale the grads in place by min(1, max_norm / (norm + eps));
        returns the norm before the clip (0-d fp32)."""
        if self.table is not None:
            return clip_grad_norm_cuda(self.table, max_norm, index=1,
                                       eps=eps)
        return clip_grad_norm_plain(self.grads, max_norm, eps)

    def state_dict(self) -> Dict:
        return {"step": self.step_count,
                "mu": [m.detach().clone() for m in self.mu],
                "nu": [v.detach().clone() for v in self.nu]}

    def load_state_dict(self, state: Dict) -> None:
        """Copy a :meth:`state_dict` in, into the existing moment storage."""
        if len(state["mu"]) != len(self.mu) or \
                len(state["nu"]) != len(self.nu):
            raise ValueError(f"state holds {len(state['mu'])} moments, the "
                             f"optimizer {len(self.mu)}")
        with torch.no_grad():
            for dst, src in zip(self.mu + self.nu,
                                list(state["mu"]) + list(state["nu"])):
                dst.copy_(src)
        self.step_count = int(state["step"])


class FusedAdam(_ListOptimizer):
    """Adam/AdamW over a list of parameters, updated in place.  The
    constructor mirrors the JAX one (and apex's): ``adam_w_mode=True`` is
    AdamW, False classic Adam; amsgrad is refused, as there."""

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule = 1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adam_w_mode: bool = True,
                 amsgrad: bool = False):
        if amsgrad:
            raise ValueError("FusedAdam does not support amsgrad (parity "
                             "with the reference)")
        super().__init__(params, lr, betas, eps, weight_decay)
        self.adam_w_mode = adam_w_mode

    @torch.no_grad()
    def step(self) -> None:
        """One Adam step over the grads in ``p.grad``; takes no norm."""
        self.step_count += 1
        c1, c2 = _bias_corrections(self.betas, self.step_count)
        hyper = dict(lr=_lr_at(self.lr, self.step_count),
                     beta1=self.betas[0], beta2=self.betas[1], eps=self.eps,
                     weight_decay=self.weight_decay, bias_c1=c1, bias_c2=c2,
                     adam_w_mode=self.adam_w_mode)
        if self.table is not None:
            adam_cuda(self.table, **hyper)
            return
        for p, m, v in zip(self.params, self.mu, self.nu):
            po, mo, vo = adam_update_plain(p, p.grad, m, v, **hyper)
            p.copy_(po)
            m.copy_(mo)
            v.copy_(vo)


class FusedLAMB(_ListOptimizer):
    """LAMB over a list of parameters, updated in place (see the module
    docstring).  Defaults follow the JAX package's (and apex's)."""

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule = 1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.01, max_grad_norm: float = 1.0,
                 bias_correction: bool = True):
        super().__init__(params, lr, betas, eps, weight_decay)
        self.max_grad_norm = max_grad_norm
        self.bias_correction = bias_correction
        self._u = None
        if self.table is not None:
            self._u = torch.empty(self.table.total, dtype=torch.float32,
                                  device=self.device)

    @property
    def clips(self) -> bool:
        return bool(self.max_grad_norm and self.max_grad_norm > 0)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One LAMB step over the grads in ``p.grad``; returns the global
        grad norm before LAMB's clip (0-d fp32)."""
        self.step_count += 1
        c1, c2, lr = lamb_step_scalars(self, self.step_count)
        if self.table is not None:
            return self._step_cuda(c1, c2, lr)
        return self._step_plain(c1, c2, lr)

    def _step_cuda(self, c1, c2, lr) -> torch.Tensor:
        gnorm, _ = multi_tensor_l2norm_cuda(self.table, index=1)
        _, ratio = lamb_stage1_cuda(
            self.table, self._u, gnorm if self.clips else None,
            beta1=self.betas[0], beta2=self.betas[1], eps=self.eps,
            weight_decay=self.weight_decay, bias_c1=c1, bias_c2=c2,
            max_grad_norm=float(self.max_grad_norm or 0.0))
        lamb_stage2_cuda(self.table, self._u, ratio, lr)
        return gnorm

    def _step_plain(self, c1, c2, lr) -> torch.Tensor:
        gnorm, _ = multi_tensor_l2norm_plain(self.grads)
        gscale = lamb_clip_scale(self, gnorm) if self.clips else 1.0
        for p, m, v in zip(self.params, self.mu, self.nu):
            po, mo, vo = lamb_update_leaf(self, p, p.grad, m, v, c1, c2, lr,
                                          gscale)
            p.copy_(po)
            m.copy_(mo)
            v.copy_(vo)
        return gnorm
