"""Synthetic language-model batches: port of ``lm_batch`` (:82) and
``mlm_batch`` (:108) of apex_example_tpu/data/synthetic.py.

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

from typing import Tuple

import numpy as np

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
