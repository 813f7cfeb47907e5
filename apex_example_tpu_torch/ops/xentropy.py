"""Softmax cross-entropy with label smoothing: port of
apex_example_tpu/ops/xentropy.py.

An ``autograd.Function`` over the logsumexp form, as the JAX
``custom_vjp`` (:46): the forward saves only ``(logits, labels, lse)`` and
the backward rebuilds the probabilities as ``exp(logits - lse)`` instead of
keeping a [tokens, V] residual.  The JAX package has no Pallas kernel here
(XLA fuses both passes), so plain torch is the port.

Smoothing ``e`` targets ``(1 - e) * onehot + e / V``:
``loss = lse - z_y + e * (z_y - mean(z))``.
"""

from __future__ import annotations

import torch


def _xent_fwd(logits: torch.Tensor, labels: torch.Tensor,
              smoothing: float):
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    z_y = lf.gather(-1, labels[..., None].long())[..., 0]
    loss = lse - z_y
    if smoothing:
        loss = loss + smoothing * (z_y - lf.mean(-1))
    return loss, lse


class SoftmaxCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, smoothing):
        loss, lse = _xent_fwd(logits, labels, smoothing)
        ctx.save_for_backward(logits, labels, lse)
        ctx.smoothing = smoothing
        return loss

    @staticmethod
    def backward(ctx, dloss):
        logits, labels, lse = ctx.saved_tensors
        smoothing = ctx.smoothing
        lf = logits.float()
        v = logits.shape[-1]
        # rematerialized, and updated in place: at Transformer-XL's vocab
        # of 267,735 one [tokens, V] fp32 buffer is 6.6 GB a batch
        grad = (lf - lse[..., None]).exp_()
        if smoothing:
            grad.sub_(smoothing / v)
        grad.scatter_add_(-1, labels[..., None].long(),
                          torch.full_like(lse[..., None], smoothing - 1.0))
        grad.mul_(dloss[..., None].float())
        return grad.to(logits.dtype), None, None


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          smoothing: float = 0.0) -> torch.Tensor:
    """Per-example softmax CE: logits (..., V) of any float dtype, labels
    (...,) int; fp32 losses of shape (...)."""
    return SoftmaxCrossEntropy.apply(logits, labels, float(smoothing))
