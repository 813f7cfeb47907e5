"""Legacy fp16 utilities, the predecessor of amp: port of
apex_example_tpu/fp16_utils.py (``network_to_half`` :38,
``prep_param_lists`` :57, ``master_to_model`` :69, ``grads_to_master`` :77,
``FP16_Optimizer`` :92, ``LossScaler`` :154, ``DynamicLossScaler`` :160),
in PyTorch's idiom, as apex's ``apex.fp16_utils`` is.

The JAX module is functional (an init/step pair over a state pytree); this
one keeps apex's shape: ``FP16_Optimizer`` wraps one of the port's fused
optimizers (optim/fused.py) built over fp32 master copies of a half
model's parameters, and updates the model's parameters in place:

    model_params, masters = prep_param_lists(network_to_half(model))
    opt = FP16_Optimizer(FusedSGD(masters, lr=0.1), model_params,
                         dynamic_loss_scale=True)
    opt.zero_grad()
    opt.backward(loss)          # the loss times the scale, backward
    opt.step()                  # unscale, skip on overflow, update, copy

``step`` copies the model's half grads into the masters' fp32 grads,
unscales them (the multi-tensor scale kernel on the card, and its int32
non-finite flag), steps the inner optimizer with that flag as apex's
``noop_flag``, updates the scaler and writes the masters back into the
model's parameters.  A step whose unscaled grads are not finite leaves the
masters, the optimizer's state and its step count as they were and halves
a dynamic scale, as the JAX step's ``select_tree`` does, with no host
sync: the skip is the inner optimizer's (every fused optimizer takes the
flag), and this module adds no kernel.

The scalers are amp's :class:`~apex_example_tpu_torch.amp.scaler.
ScalerState`: ``LossScaler`` a static one, ``DynamicLossScaler`` apex's
growth/backoff schedule.  Half means bf16 by default; fp16 is a
``half_dtype`` away.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple, Union

import torch
from torch import nn

from apex_example_tpu_torch import amp
from apex_example_tpu_torch.amp.scaler import ScalerState
from apex_example_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm

_BATCHNORMS = (SyncBatchNorm, nn.modules.batchnorm._BatchNorm)


def network_to_half(model_or_params, half_dtype=torch.bfloat16):
    """A module or a list / dict of tensors in half precision.

    A module is converted in place and returned (apex's
    ``network_to_half``, whose ``BN_convert_float`` keeps BatchNorm fp32):
    every parameter and floating buffer outside a BatchNorm module becomes
    ``half_dtype``, and so does every compute ``dtype`` the port's modules
    carry (``dtype``, ``compute_dtype``); a BatchNorm module keeps its
    parameters, running statistics and statistics dtype fp32 and takes
    half I/O.  This is the JAX module's clone with ``dtype`` half and
    ``bn_dtype`` fp32.  A list or dict of tensors comes back as a new one
    with its floating tensors cast and the others as they were."""
    if isinstance(model_or_params, nn.Module):
        for mod in model_or_params.modules():
            if isinstance(mod, _BATCHNORMS):    # BN_convert_float
                if isinstance(mod, SyncBatchNorm):
                    mod.dtype, mod.stats_dtype = half_dtype, torch.float32
                continue
            for attr in ("dtype", "compute_dtype"):
                if isinstance(getattr(mod, attr, None), torch.dtype):
                    setattr(mod, attr, half_dtype)
            with torch.no_grad():
                for t in list(mod.parameters(recurse=False)) + list(
                        mod.buffers(recurse=False)):
                    if t.is_floating_point():
                        t.data = t.data.to(half_dtype)
        return model_or_params
    cast = lambda t: t.to(half_dtype) if t.is_floating_point() else t  # noqa
    if isinstance(model_or_params, dict):
        return {k: cast(t) for k, t in model_or_params.items()}
    return [cast(t) for t in model_or_params]


def prep_param_lists(model: Union[nn.Module, Iterable[torch.Tensor]]
                     ) -> Tuple[List[torch.Tensor], List[nn.Parameter]]:
    """``(model_params, master_params)``: the model's parameters and an
    fp32 copy of each, a new leaf that the master optimizer updates (apex's
    ``prep_param_lists``)."""
    params = list(model.parameters() if isinstance(model, nn.Module)
                  else model)
    masters = [nn.Parameter(p.detach().to(torch.float32, copy=True))
               for p in params]
    return params, masters


@torch.no_grad()
def master_to_model(masters: Iterable[torch.Tensor],
                    model_params: Iterable[torch.Tensor]
                    ) -> List[torch.Tensor]:
    """Copy each fp32 master into its model parameter, in the parameter's
    dtype, in place; returns the model parameters (apex's
    ``master_params_to_model_params``)."""
    model_params = list(model_params)
    for p, m in zip(model_params, masters):
        p.copy_(m)
    return model_params


@torch.no_grad()
def grads_to_master(model_params: Iterable[torch.Tensor],
                    masters: Iterable[torch.Tensor]) -> List[torch.Tensor]:
    """Copy each model parameter's grad into its master's grad, upcast to
    fp32, in place (a master without a grad gets one; a parameter without a
    grad gives zeros); returns the master grads (apex's
    ``model_grads_to_master_grads``)."""
    out = []
    for p, m in zip(model_params, masters):
        if m.grad is None:
            m.grad = torch.zeros_like(m)
        if p.grad is None:
            m.grad.zero_()
        else:
            m.grad.copy_(p.grad)
        out.append(m.grad)
    return out


def LossScaler(scale: float = 1.0, device="cpu") -> ScalerState:
    """A static loss scale (apex's ``fp16_utils.LossScaler``); 1.0 is the
    identity."""
    return ScalerState(
        scale=torch.full((), scale, dtype=torch.float32, device=device),
        growth_counter=torch.zeros((), dtype=torch.int32, device=device),
        dynamic=False, identity=(scale == 1.0))


def DynamicLossScaler(init_scale: float = 2.0 ** 16,
                      scale_factor: float = 2.0, scale_window: int = 2000,
                      device="cpu") -> ScalerState:
    """apex's ``fp16_utils.DynamicLossScaler`` as the JAX module builds
    it: the scale halves on an overflow (amp's backoff) and multiplies by
    ``scale_factor`` after ``scale_window`` finite steps in a row."""
    return ScalerState(
        scale=torch.full((), init_scale, dtype=torch.float32, device=device),
        growth_counter=torch.zeros((), dtype=torch.int32, device=device),
        dynamic=True, growth_factor=scale_factor,
        growth_interval=scale_window)


class FP16_Optimizer:
    """Manual master-weight mixed precision (apex's
    ``fp16_utils.FP16_Optimizer``; see the module docstring).  ``inner`` is
    a fused optimizer of optim/fused.py over the fp32 ``master_params`` of
    ``prep_param_lists``; ``model_params`` are the model's parameters, in
    the same order."""

    def __init__(self, inner, model_params: Iterable[torch.Tensor],
                 static_loss_scale: float = 1.0,
                 dynamic_loss_scale: bool = False,
                 dynamic_loss_args: Optional[Dict] = None):
        self.inner = inner
        self.model_params = list(model_params)
        if len(self.model_params) != len(inner.params):
            raise ValueError(f"{len(self.model_params)} model parameters "
                             f"for {len(inner.params)} masters")
        kw = dict(dynamic_loss_args or {})
        if dynamic_loss_scale:
            self.scaler = DynamicLossScaler(
                init_scale=kw.get("init_scale", 2.0 ** 16),
                scale_factor=kw.get("scale_factor", 2.0),
                scale_window=kw.get("scale_window", 2000),
                device=inner.device)
        else:
            self.scaler = LossScaler(static_loss_scale, device=inner.device)

    @property
    def masters(self) -> List[torch.Tensor]:
        return self.inner.params

    def zero_grad(self) -> None:
        """Drop the model's grads (the masters' are overwritten by
        :meth:`step`)."""
        for p in self.model_params:
            p.grad = None

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The loss times the loss scale."""
        return amp.scale_loss(loss, self.scaler)

    def backward(self, loss: torch.Tensor) -> None:
        """Backward of the scaled loss into the model's grads."""
        self.scale_loss(loss).backward()

    @torch.no_grad()
    def step(self) -> Optional[torch.Tensor]:
        """Master grads from the model's, unscaled (the flag of a dynamic
        scaler), the inner step (skipped on the flag), the scaler's update,
        the masters written back into the model.  Returns the inner step's
        result (a grad norm, or None)."""
        grads_to_master(self.model_params, self.masters)
        found_inf = amp.unscale_grads(self.inner, self.scaler)
        if found_inf is None:
            out = self.inner.step()
        else:
            out = self.inner.step(noop_flag=found_inf)
        self.scaler = amp.update_scaler(self.scaler, found_inf)
        master_to_model(self.masters, self.model_params)
        return out

    def state_dict(self) -> Dict:
        """The scaler's state (host values), the inner optimizer's state
        and the fp32 masters."""
        return {"scaler": amp.state_dict(self.scaler),
                "optimizer": self.inner.state_dict(),
                "masters": [m.detach().clone() for m in self.masters]}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Load a :meth:`state_dict` in place and write the masters back
        into the model."""
        self.scaler = amp.load_state_dict(self.scaler, state["scaler"])
        self.inner.load_state_dict(state["optimizer"])
        for m, saved in zip(self.masters, state["masters"]):
            m.copy_(saved)
        master_to_model(self.masters, self.model_params)
