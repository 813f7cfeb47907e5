"""LARC, layer-wise adaptive rate clipping: port of
apex_example_tpu/parallel/larc.py (``larc`` :24, ``LARC`` :71).

A wrapper over one of the port's fused optimizers (optim/fused.py).  Its
``step`` scales each parameter's grad in place by the trust ratio

    adaptive = trust_coefficient * ||p|| / (||g|| + weight_decay ||p|| + eps)

(1 where ||p|| or ||g|| is 0; in clip mode ``min(adaptive / lr, 1)``, so
that the inner step is ``min(adaptive, lr)``), after adding
``weight_decay * p`` to it, and then runs the inner optimizer's step with
the noop flag.  Weight decay belongs to LARC: the inner optimizer is built
with none (train.py :561-582), since a decay added after the scaling would
be another update.  The norms are fp32 over each tensor, in plain torch
(the JAX package computes them in XLA); the scaling is
``(g.float() * adaptive).to(g.dtype)``.

``step`` returns the global norm of the grads as they came in (0-d fp32),
the JAX step's ``grad_norm`` metric (taken before the optimizer, LARC
included).  Everything else (``params``, ``zero_grad``, ``unscale_grads``,
``clip_grad_norm``, ``device``, the state) is the inner optimizer's.
"""

from __future__ import annotations

from typing import Optional

import torch


class LARC:
    """apex.parallel.LARC over a fused optimizer of the port."""

    def __init__(self, optimizer, trust_coefficient: float = 0.02,
                 clip: bool = True, eps: float = 1e-8,
                 lr: Optional[float] = None, weight_decay: float = 0.0):
        if clip and lr is None:
            raise ValueError("clip mode requires the outer lr "
                             "(apex: decay = min(adaptive_lr / group_lr, 1))")
        self.optimizer = optimizer
        self.trust_coefficient, self.clip, self.eps = (trust_coefficient,
                                                       clip, eps)
        self.lr, self.weight_decay = lr, weight_decay

    def __getattr__(self, name):
        if name == "optimizer":           # not set yet: no recursion
            raise AttributeError(name)
        return getattr(self.optimizer, name)

    @torch.no_grad()
    def _scale_grads(self) -> torch.Tensor:
        """Scale every grad in place by its trust ratio; returns the
        global norm of the grads before the scaling."""
        params = self.optimizer.params
        grads = [p.grad for p in params]
        pn = torch.stack(torch._foreach_norm([p.float() for p in params]))
        gn = torch.stack(torch._foreach_norm([g.float() for g in grads]))
        adaptive = self.trust_coefficient * pn / (
            gn + self.weight_decay * pn + self.eps)
        one = torch.ones_like(adaptive)
        adaptive = torch.where(pn > 0, adaptive, one)
        adaptive = torch.where(gn > 0, adaptive, one)
        if self.clip:
            adaptive = torch.minimum(adaptive / self.lr, one)
        if self.weight_decay:
            torch._foreach_add_(grads, params, alpha=self.weight_decay)
        for g, a in zip(grads, adaptive.unbind()):
            g.copy_(g.float() * a)
        return torch.sqrt(torch.sum(gn * gn))

    def step(self, noop_flag: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        """Scale the grads, then the inner optimizer's step with
        ``noop_flag``; returns the grads' global norm before LARC."""
        gnorm = self._scale_grads()
        self.optimizer.step(noop_flag=noop_flag)
        return gnorm
