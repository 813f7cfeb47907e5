"""Language-model losses, the Transformer-XL train steps and the LM eval
steps: port of apex_example_tpu/workloads.py (``mlm_loss`` :32,
``lm_loss`` :45, ``make_txl_train_step`` :61, ``make_bert_eval_step``
:167, ``make_gpt_eval_step`` :181, ``make_txl_eval_step`` :192,
``make_sharded_txl_train_step`` :207).

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

With ``grad_accum=K`` (:86-131) the batch splits into K groups of
independent streams, ``batch // K`` consecutive rows each, and the memory
with them along its batch axis (dim 1 of (layers, B, mem, d)): each
group's forward and backward runs on its own rows of the memory, so each
stream's carry stays exact, and the new memory is put back together in
stream order.  The grads become the mean of the groups' fp32 grads in
the parameters' dtype (engine.GradAccumulator), and the loss the mean of
their losses; then the unscale, the clip and the step run once, on the
mean.

The data-parallel step (``make_sharded_txl_train_step``) runs that step
in every process of a group on its rows of the batch and its rows of the
memory (the memory splits on its batch axis, dim 1 of (layers, B, mem,
d), as JAX's ``P(None, "data")``), with the grads reduced over the group
(parallel/distributed.py ``allreduce_grads``) before the unscale and the
clip, so the clip reads the reduced grads' norm; the loss is averaged
over the group.

The eval steps run the model in eval mode under ``torch.no_grad()``, at
the dtypes its amp policy built it with, and touch no optimizer, scaler
or grad: BERT's gives ``loss`` and ``masked_acc`` (percent of the weighted
positions whose argmax is the label, the weight sum clamped to at least
1), GPT's ``loss``, and Transformer-XL's threads its memory through,
``(state, mems, batch) -> (new_mems, {loss})``; perplexity is the
caller's, ``exp`` of the mean loss over the eval batches.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from apex_example_tpu_torch import amp
from apex_example_tpu_torch.engine import (accumulator_cache, ordered_mean,
                                           split_batch)
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
                        ddp: Optional[DDPConfig] = None, axis_name=None,
                        grad_accum: int = 1):
    """``train_step(state, mems, (inp, tgt)) -> (state, new_mems,
    metrics)`` for a TransformerXL ``state.model`` (engine.TrainState: its
    policy and loss scaler too) and an optimizer with ``clip_grad_norm``
    and a ``step`` that takes the noop flag (optim/fused.py).  With
    ``axis_name`` the grads are reduced over its group with ``ddp``'s
    options and the loss averaged over it.  ``grad_accum=K`` runs K groups
    of streams before the one step (module docstring)."""
    ddp = ddp or DDPConfig()
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    accumulator = accumulator_cache(grad_accum)

    def forward_backward(state, mems, inp, tgt):
        logits, new_mems = state.model(inp, mems)
        loss = lm_loss(logits, tgt)
        del logits          # the loss's graph holds what the backward needs
        amp.scale_loss(loss, state.scaler).backward()
        return loss.detach(), new_mems

    def train_step(state, mems: torch.Tensor, batch
                   ) -> Tuple[object, torch.Tensor, Dict]:
        inp, tgt = batch
        opt, scaler = state.optimizer, state.scaler
        state.model.train()
        opt.zero_grad()
        if grad_accum == 1:
            loss, new_mems = forward_backward(state, mems, inp, tgt)
        else:
            acc = accumulator(opt)
            acc.begin()
            rows = inp.shape[0] // grad_accum
            losses, parts = [], []
            for i, (inp_mb, tgt_mb) in enumerate(
                    split_batch((inp, tgt), grad_accum)):
                loss_mb, mems_mb = forward_backward(
                    state, mems[:, i * rows:(i + 1) * rows], inp_mb, tgt_mb)
                losses.append(loss_mb)
                parts.append(mems_mb)
                if i + 1 < grad_accum:
                    acc.fold()
            acc.finish()
            loss = ordered_mean(losses)
            new_mems = torch.cat(parts, dim=1)
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
        metrics = {"loss": loss, "grad_norm": grad_norm,
                   "ppl": torch.exp(loss), "scale": state.scaler.scale,
                   "grads_finite": (1.0 if found_inf is None
                                    else (found_inf == 0).float())}
        return state, new_mems, metrics

    return train_step


def make_bert_eval_step():
    """``eval_step(state, (ids, (labels, weights))) -> {loss, masked_acc}``:
    the MLM loss and the accuracy over the masked positions only."""

    @torch.no_grad()
    def eval_step(state, batch) -> Dict:
        ids, (labels, weights) = batch
        state.model.eval()
        logits = state.model(ids)
        hit = (logits.argmax(-1) == labels).float()
        denom = torch.clamp(weights.sum(), min=1.0)
        return {"loss": mlm_loss(logits, (labels, weights)),
                "masked_acc": (hit * weights).sum() / denom * 100.0}

    return eval_step


def make_gpt_eval_step():
    """``eval_step(state, (x, y)) -> {loss}``: next-token CE on a held-out
    batch."""

    @torch.no_grad()
    def eval_step(state, batch) -> Dict:
        x, y = batch
        state.model.eval()
        return {"loss": lm_loss(state.model(x), y)}

    return eval_step


def make_txl_eval_step():
    """``eval_step(state, mems, (inp, tgt)) -> (new_mems, {loss})``: the
    held-out next-token loss with the memory threaded through, as in
    training."""

    @torch.no_grad()
    def eval_step(state, mems: torch.Tensor, batch
                  ) -> Tuple[torch.Tensor, Dict]:
        inp, tgt = batch
        state.model.eval()
        logits, new_mems = state.model(inp, mems)
        return new_mems, {"loss": lm_loss(logits, tgt)}

    return eval_step


def make_sharded_txl_train_step(axis_name=DATA_AXIS,
                                ddp: Optional[DDPConfig] = None,
                                max_grad_norm: float = 0.25,
                                grad_accum: int = 1):
    """The data-parallel Transformer-XL step: ``train_step(state, mems,
    (inp, tgt))`` in every process of ``axis_name``'s group, with its own
    rows of the batch and of the memory (dim 1), the state equal in every
    process (see the module docstring); ``grad_accum`` splits each
    process's streams."""
    return make_txl_train_step(max_grad_norm, ddp=ddp, axis_name=axis_name,
                               grad_accum=grad_accum)
