"""Loss scaling as device state: port of apex_example_tpu/amp/scaler.py
(``ScalerState`` :33, ``make_scaler`` :50, ``scale_loss`` :73,
``unscale_grads`` :90, ``update`` :114, ``state_dict`` :143,
``load_state_dict`` :155).

apex's dynamic scaler reads the overflow flag back on the host, halves the
scale there and skips ``optimizer.step()``.  Here, as in the JAX package,
nothing is read back: ``scale`` and ``growth_counter`` are 0-d tensors on
the parameters' device, :func:`unscale_grads` leaves an int32 non-finite
flag there, the optimizer's kernel takes that flag as apex's ``noop_flag``
and leaves the parameters and its own state untouched when it is set
(FusedSGD, optim/fused.py: this is the JAX step's ``select_tree`` of the old
params and optimizer state), and :func:`update` applies apex's
growth/backoff schedule with ``torch.where`` alone.

:func:`unscale_grads` multiplies the optimizer's grads in place by
``1 / scale`` through the multi-tensor scale kernel (ops/multi_tensor.py,
one launch over the optimizer's device table; the plain version on the
CPU), which flags a non-finite element of the unscaled grads, as the JAX
package's ``all_finite`` of the unscaled tree does.  With the identity
scaler (a static scale of 1.0, the bf16 O1/O2 default) it does nothing and
launches nothing.  A static scaler of another value unscales and reports no
flag: its step is never skipped.

Defaults are apex's: initial scale 2**16, growth interval 2000, growth
factor 2, backoff 0.5.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from apex_example_tpu_torch.amp.policy import Policy


@dataclasses.dataclass(frozen=True)
class ScalerState:
    """The loss scaler: ``scale`` (0-d fp32) and ``growth_counter`` (0-d
    int32, consecutive finite steps) on the device, and its static
    configuration.  ``identity`` records that the scale is 1.0 forever."""
    scale: torch.Tensor
    growth_counter: torch.Tensor
    dynamic: bool = False
    growth_interval: int = 2000
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    identity: bool = False

    def replace(self, **kw) -> "ScalerState":
        return dataclasses.replace(self, **kw)


def make_scaler(policy: Policy, init_scale: float = 2.0 ** 16,
                growth_interval: int = 2000, device="cpu") -> ScalerState:
    """The scaler of ``policy``, its tensors on ``device``."""
    counter = torch.zeros((), dtype=torch.int32, device=device)
    if policy.uses_dynamic_scaling:
        return ScalerState(
            scale=torch.full((), init_scale, dtype=torch.float32,
                             device=device),
            growth_counter=counter, dynamic=True,
            growth_interval=growth_interval)
    static = policy.static_scale
    return ScalerState(
        scale=torch.full((), static, dtype=torch.float32, device=device),
        growth_counter=counter, dynamic=False, identity=(static == 1.0))


def scale_loss(loss: torch.Tensor, scaler: ScalerState) -> torch.Tensor:
    """The loss times the scale (``with amp.scale_loss(...)``'s enter)."""
    if scaler.identity:
        return loss
    return loss * scaler.scale.to(loss.dtype)


def unscale_grads(optimizer, scaler: ScalerState) -> Optional[torch.Tensor]:
    """Multiply ``optimizer``'s grads by ``1 / scale`` in place.  Returns
    the int32 flag (1: some unscaled grad element is inf or nan) for a
    dynamic scaler, None for a static one; the identity launches nothing
    and returns None."""
    if scaler.identity and not scaler.dynamic:
        return None
    flag = optimizer.unscale_grads(1.0 / scaler.scale)
    return flag if scaler.dynamic else None


def update(scaler: ScalerState,
           found_inf: Optional[torch.Tensor]) -> ScalerState:
    """apex's growth/backoff after a step whose flag is ``found_inf``:
    non-finite halves the scale and resets the counter; ``growth_interval``
    finite steps in a row double it.  Device ops only, no host sync; a
    static scaler is returned as it is."""
    if not scaler.dynamic:
        return scaler
    finite = found_inf == 0
    counter = torch.where(finite, scaler.growth_counter + 1,
                          torch.zeros_like(scaler.growth_counter))
    grow = counter >= scaler.growth_interval
    scale = torch.where(
        finite,
        torch.where(grow, scaler.scale * scaler.growth_factor, scaler.scale),
        scaler.scale * scaler.backoff_factor)
    counter = torch.where(grow, torch.zeros_like(counter), counter)
    return scaler.replace(scale=scale, growth_counter=counter)


def state_dict(scaler: ScalerState) -> dict:
    """The scaler's state as host values (reads the device)."""
    return {"scale": float(scaler.scale),
            "growth_counter": int(scaler.growth_counter),
            "dynamic": scaler.dynamic}


def load_state_dict(scaler: ScalerState, d: dict) -> ScalerState:
    """``scaler`` with the state of :func:`state_dict` on its device; a
    static scaler's identity is derived again from the loaded scale."""
    scale = float(d["scale"])
    dev = scaler.scale.device
    return scaler.replace(
        scale=torch.full((), scale, dtype=torch.float32, device=dev),
        growth_counter=torch.full((), int(d["growth_counter"]),
                                  dtype=torch.int32, device=dev),
        identity=(not scaler.dynamic and scale == 1.0))
