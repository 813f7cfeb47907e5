"""Language-model losses and the Transformer-XL train steps: port of
apex_example_tpu/workloads.py (``mlm_loss`` :32, ``lm_loss`` :45,
``make_txl_train_step`` :61, ``make_sharded_txl_train_step`` :207).

The TXL step with one microbatch follows the JAX step's amp protocol
(:61-160), in its order: zero the grads -> forward with the memory ->
``lm_loss`` -> ``amp.scale_loss`` -> backward -> ``amp.unscale_grads``
(one scale launch per device table and its int32 non-finite flag on the
card) -> the global-norm clip over the optimizer's own grads
(``clip_grad_norm`` :145; on the card one L2-norm and one scale launch per
table, the scale reading the norm there) -> the optimizer step, which takes
the flag as apex's ``noop_flag`` -> ``amp.update_scaler``.  With the
identity scaler (O0, and O1-O3 in bf16) the scale and unscale launch
nothing.  A dynamic scaler's overflow step is skipped on the card with no
host sync: the optimizer leaves the parameters, its moments and its step
count as JAX's ``select_tree`` does (:149-153), and the scale halves.  Its
metrics are the JAX step's (:156-158): ``loss``, ``grad_norm`` (the norm
before the clip), ``ppl = exp(loss)``, ``scale`` (the scaler's, after the
update) and ``grads_finite``.  The new memory comes from the forward
whatever the skip, as JAX's does, and comes back detached, so the next
step's backward stops at it, as the JAX step never differentiates through
its mems carry.

The data-parallel step (``make_sharded_txl_train_step``) runs that step
in every process of a group on its rows of the batch and its rows of the
memory (the memory splits on its batch axis, dim 1 of (layers, B, mem,
d), as JAX's ``P(None, "data")``), with the grads reduced over the group
(parallel/distributed.py ``allreduce_grads``) before the unscale and the
clip, so the clip reads the reduced grads' norm; the loss is averaged
over the group.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from typing import Optional

from apex_example_tpu_torch import amp
from apex_example_tpu_torch.ops.xentropy import softmax_cross_entropy
from apex_example_tpu_torch.parallel.distributed import (DDPConfig,
                                                         allreduce_grads,
                                                         reduce_mean)
from apex_example_tpu_torch.parallel.mesh import DATA_AXIS


def mlm_loss(logits: torch.Tensor,
             target: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Masked-LM loss: the CE summed over the masked positions (weights
    mark them) over their count, at least 1.  target = (labels, weights)."""
    labels, weights = target
    ce = softmax_cross_entropy(logits, labels)
    return (ce * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Next-token CE, mean over all positions."""
    return softmax_cross_entropy(logits, labels).mean()


def make_txl_train_step(max_grad_norm: float = 0.25,
                        ddp: Optional[DDPConfig] = None, axis_name=None):
    """``train_step(state, mems, (inp, tgt)) -> (state, new_mems,
    metrics)`` for a TransformerXL ``state.model`` (engine.TrainState: its
    policy and loss scaler too) and an optimizer with ``clip_grad_norm``
    and a ``step`` that takes the noop flag (optim/fused.py).  With
    ``axis_name`` the grads are reduced over its group with ``ddp``'s
    options and the loss averaged over it."""
    ddp = ddp or DDPConfig()

    def train_step(state, mems: torch.Tensor, batch
                   ) -> Tuple[object, torch.Tensor, Dict]:
        inp, tgt = batch
        opt, scaler = state.optimizer, state.scaler
        state.model.train()
        opt.zero_grad()
        logits, new_mems = state.model(inp, mems)
        loss = lm_loss(logits, tgt)
        del logits          # the loss's graph holds what the backward needs
        amp.scale_loss(loss, scaler).backward()
        if axis_name is not None:
            allreduce_grads(opt.grads, ddp, axis_name)
            loss = reduce_mean(loss, axis_name)
        found_inf = amp.unscale_grads(opt, scaler)
        grad_norm = opt.clip_grad_norm(max_grad_norm)
        if found_inf is None:
            opt.step()
        else:
            opt.step(noop_flag=found_inf)
        state.scaler = amp.update_scaler(scaler, found_inf)
        state.step += 1
        loss = loss.detach()
        metrics = {"loss": loss, "grad_norm": grad_norm,
                   "ppl": torch.exp(loss), "scale": state.scaler.scale,
                   "grads_finite": (1.0 if found_inf is None
                                    else (found_inf == 0).float())}
        return state, new_mems, metrics

    return train_step


def make_sharded_txl_train_step(axis_name=DATA_AXIS,
                                ddp: Optional[DDPConfig] = None,
                                max_grad_norm: float = 0.25):
    """The data-parallel Transformer-XL step: ``train_step(state, mems,
    (inp, tgt))`` in every process of ``axis_name``'s group, with its own
    rows of the batch and of the memory (dim 1), the state equal in every
    process (see the module docstring)."""
    return make_txl_train_step(max_grad_norm, ddp=ddp, axis_name=axis_name)
