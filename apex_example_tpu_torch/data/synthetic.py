"""Synthetic image and language-model batches: port of ``CIFAR10`` and
``IMAGENET`` (:31-32), ``image_batch`` (:45), ``lm_batch`` (:82) and
``mlm_batch`` (:108) of apex_example_tpu/data/synthetic.py.

Images: a fixed low-frequency pattern per class plus noise, NHWC fp32, so
models learn and the loss falls.  The patterns are an (num_classes, 8, 8,
C) normal draw from numpy's ``RandomState(seed)``, resized bilinearly with
half-pixel centres as ``jax.image.resize`` does (:36-42; upsampling, where
the edge pixels repeat in both), made once per device.  Labels, the noise
and the label noise of a step are drawn ON the target device from a
``torch.Generator`` seeded from (seed, step), as the JAX trainer makes its
batches on the device (train.py:753-756): on the host, numpy would make
the 154 MB of noise of a C2 batch (256 x 224 x 224 x 3 fp32) each step, as
long as a device step.  A batch is therefore a function of (seed, step)
and of the device's generator, not the same across devices, and not the
JAX generator's numbers: the parity tests hand the same numpy arrays to
both sides.

Tokens:
The same distributions, drawn from numpy's ``RandomState((seed, step))``
on the host:

- token streams with affine-bigram structure, ``t+1 = (31 t + 17) mod V``,
  each step replaced by a uniform token with probability 0.1;
- BERT masking over them: 15% of positions masked, of those 80% become
  ``mask_token_id``, 10% a uniform random token and 10% stay as they are;
  labels hold the original tokens and weights are 1.0 at masked positions.

The JAX functions draw from ``jax.random``, whose stream numpy cannot
reproduce: the same ``(seed, step)`` gives other tokens here.  The parity
tests therefore make their batches with the JAX function and feed the
numpy arrays to both sides.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# Shapes of the reference's workload matrix.
CIFAR10 = dict(image_size=32, channels=3, num_classes=10)
IMAGENET = dict(image_size=224, channels=3, num_classes=1000)

_A, _B = 31, 17          # coprime with typical vocab sizes


def lm_batch(step: int, *, batch_size: int, seq_len: int, vocab_size: int,
             seed: int = 0, noise_p: float = 0.1) -> np.ndarray:
    """Token sequences (B, L+1) int32; callers slice inputs = [:, :-1],
    targets = [:, 1:]."""
    rs = np.random.RandomState((seed ^ 0x5eed, step))
    toks = np.empty((batch_size, seq_len + 1), np.int64)
    toks[:, 0] = rs.randint(0, vocab_size, size=batch_size)
    rand = rs.randint(0, vocab_size, size=(batch_size, seq_len))
    flip = rs.random_sample((batch_size, seq_len)) < noise_p
    for j in range(seq_len):
        clean = (_A * toks[:, j] + _B) % vocab_size
        toks[:, j + 1] = np.where(flip[:, j], rand[:, j], clean)
    return toks.astype(np.int32)


def mlm_batch(step: int, *, batch_size: int, seq_len: int, vocab_size: int,
              mask_token_id: int, seed: int = 0, mask_prob: float = 0.15
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """BERT-style MLM batch ``(input_ids, labels, weights)``, (B, L) each:
    int32, int32 and float32."""
    toks = lm_batch(step, batch_size=batch_size, seq_len=seq_len - 1,
                    vocab_size=vocab_size, seed=seed)
    rs = np.random.RandomState((seed + 101, step))
    is_masked = rs.random_sample(toks.shape) < mask_prob
    u = rs.random_sample(toks.shape)
    rand_tok = rs.randint(0, vocab_size, size=toks.shape)
    inputs = np.where(is_masked & (u < 0.8), mask_token_id, toks)
    inputs = np.where(is_masked & (u >= 0.8) & (u < 0.9), rand_tok, inputs)
    return (inputs.astype(np.int32), toks.astype(np.int32),
            is_masked.astype(np.float32))


def resize_patterns(low: torch.Tensor, image_size: int) -> torch.Tensor:
    """(K, h, w, C) -> (K, image_size, image_size, C), bilinear with
    half-pixel centres (``jax.image.resize(..., "bilinear")`` when
    upsampling)."""
    up = F.interpolate(low.permute(0, 3, 1, 2), size=(image_size,
                                                      image_size),
                       mode="bilinear", align_corners=False)
    return up.permute(0, 2, 3, 1).contiguous()


@functools.lru_cache(maxsize=8)
def class_patterns(num_classes: int, image_size: int, channels: int,
                   seed: int, device: str) -> torch.Tensor:
    """The fixed per-class patterns (K, S, S, C) fp32 on ``device``."""
    low = np.random.RandomState(seed).standard_normal(
        (num_classes, 8, 8, channels)).astype(np.float32)
    return resize_patterns(torch.from_numpy(low).to(device), image_size)


def _generator(seed: int, step: int, device: torch.device
               ) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(step)) % (2 ** 63))
    return gen


def image_batch(step: int, *, batch_size: int, image_size: int = 32,
                channels: int = 3, num_classes: int = 10, seed: int = 0,
                noise: float = 0.5, label_noise: float = 0.0,
                device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """``(images, labels)``: NHWC fp32 images ~N(0, 1)-ish and int64
    labels on ``device``.  ``label_noise=p`` replaces each label with a
    uniform class with probability p (the image keeps its class's
    pattern)."""
    device = torch.device(device)
    pats = class_patterns(num_classes, image_size, channels, seed,
                          str(device))
    gen = _generator(seed, step, device)
    labels = torch.randint(0, num_classes, (batch_size,), generator=gen,
                           device=device)
    imgs = pats[labels] + noise * torch.randn(
        (batch_size, image_size, image_size, channels), generator=gen,
        device=device)
    if label_noise:
        flip = torch.rand((batch_size,), generator=gen,
                          device=device) < label_noise
        rand = torch.randint(0, num_classes, (batch_size,), generator=gen,
                             device=device)
        labels = torch.where(flip, rand, labels)
    return imgs, labels
