"""GPT decoder-only causal LM: port of apex_example_tpu/models/gpt.py.

Learned token + position embeddings -> ``embeddings_ln`` -> N post-LN
layers (models/bert.BertLayer, causal) -> ``final_ln`` -> the tied head
``x @ E^T + lm_bias``, fp32 logits (:197-203).  ``forward`` runs either
the plain causal forward over whole sequences or, given a
:class:`~apex_example_tpu_torch.models.bert.PagedStep`, one step of
block-paged slot decode, where positions come from the host's per-slot
fill levels, clipped into the position table (:136-138).

Weights: random from ``seed`` (a CPU ``torch.Generator``, so the same seed
gives the same weights on any device), or a flax tree through
convert.gpt_params_from_flax.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_example_tpu_torch import resolve_device
from apex_example_tpu_torch.models.bert import BertLayer, PagedStep
from apex_example_tpu_torch.normalization import FusedLayerNorm


class GPTForCausalLM(nn.Module):
    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 intermediate_size: int = 3072, max_position: int = 1024,
                 seed: int = 0, device="cuda"):
        super().__init__()
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_position = max_position
        # Built without storage, filled from the seeded generator on the
        # host, then moved: the weights depend on the seed alone.
        with torch.device("meta"):
            self.word_embeddings = nn.Embedding(vocab_size, hidden_size)
            self.position_embeddings = nn.Embedding(max_position,
                                                    hidden_size)
            self.embeddings_ln = FusedLayerNorm(hidden_size)
            self.layers = nn.ModuleList(
                BertLayer(hidden_size, num_heads, intermediate_size)
                for _ in range(num_layers))
            self.final_ln = FusedLayerNorm(hidden_size)
            self.lm_bias = nn.Parameter(torch.zeros(vocab_size))
        self.to_empty(device="cpu")
        _init_weights(self, seed)
        self.to(resolve_device(device))

    def forward(self, input_ids: torch.Tensor,
                step: Optional[PagedStep] = None) -> torch.Tensor:
        """[B, L] token ids -> [B, L, vocab] fp32 logits."""
        L = input_ids.shape[1]
        if step is None:
            pos = torch.arange(L, device=input_ids.device)[None, :]
        else:
            pos = step.pos.clamp(0, self.max_position - 1)
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        x = self.embeddings_ln(x)
        for i, layer in enumerate(self.layers):
            x = layer(x, None if step is None else step.arenas[i], step)
        x = self.final_ln(x)
        return F.linear(x, self.word_embeddings.weight, self.lm_bias).float()


def _init_weights(model: GPTForCausalLM, seed: int) -> None:
    """Flax's default initialisers in distribution: embeddings and Dense
    kernels normal with std 1/sqrt(fan_in), biases zero, LN scale one."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:                 # [V, H] embedding or [out, in] weight
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=gen)


def gpt_base(**kw) -> GPTForCausalLM:
    return GPTForCausalLM(**kw)


def gpt_tiny(**kw) -> GPTForCausalLM:
    """Test-scale configuration (same code path, CPU-friendly)."""
    kw.setdefault("vocab_size", 256)
    kw.setdefault("hidden_size", 64)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("intermediate_size", 128)
    kw.setdefault("max_position", 128)
    return GPTForCausalLM(**kw)


def topk_filter(logits: torch.Tensor, top_k: np.ndarray) -> torch.Tensor:
    """Rows with ``top_k[b] > 0`` keep the logits >= their k-th largest
    (ties at the threshold keep >= k candidates, :246-253); the rest are
    -inf.  Rows with ``top_k[b] == 0`` pass unchanged."""
    V = logits.shape[-1]
    k = torch.tensor(np.asarray(top_k), dtype=torch.int64,
                     device=logits.device)
    desc = torch.sort(logits, dim=-1, descending=True).values
    thresh = desc.gather(1, (k.clamp(1, V) - 1)[:, None])
    return logits.masked_fill((k[:, None] > 0) & (logits < thresh),
                              float("-inf"))


def sample_tokens(logits: torch.Tensor, temperature, top_k=0,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Next token for each row of [B, V] logits (port of :224).
    ``temperature``/``top_k`` are host values, scalars or per-row
    sequences: temperature 0 is greedy (the FIRST argmax), top_k 0 the full
    softmax.  Sampled rows draw a Gumbel-max sample from ``generator`` at
    ``logits / max(t, 1e-6)`` (:260).  Deciding on the host which lanes
    run keeps the device free of data-dependent branches."""
    B = logits.shape[0]
    t = np.broadcast_to(np.asarray(temperature, np.float32), (B,))
    k = np.broadcast_to(np.asarray(top_k, np.int64), (B,))
    greedy = logits.argmax(-1)
    if not (t > 0).any():
        return greedy
    lg = topk_filter(logits, k) if (k > 0).any() else logits
    scale = torch.from_numpy(np.maximum(t, 1e-6)).to(logits.device)
    u = torch.rand(lg.shape, generator=generator, device=lg.device)
    gumbel = -torch.log(-torch.log(u))
    sampled = (lg / scale[:, None] + gumbel).argmax(-1)
    sample_rows = torch.from_numpy(t > 0).to(logits.device)
    return torch.where(sample_rows, sampled, greedy)
