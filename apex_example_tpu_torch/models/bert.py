"""Post-LN transformer layers: port of apex_example_tpu/models/bert.py.

``BertSelfAttention`` (:72) and ``BertLayer`` (:418) as GPT uses them:
causal attention, either over the whole sequence (the dense path,
:408-415) or as a step of block-paged slot decode (:187-327), and the dense
GELU FFN (:497-501) with post-LN residuals (:468-469, :502-503).  The
einsum attention core is ``_softmax_attention`` (:51): logits DIVIDED by
sqrt(head_dim), masked with -1e9, softmax in fp32.

Paged slot decode.  Each layer owns one K and one V arena of shape
``[num_blocks, block_size, heads, head_dim]``; every batch row is a request
slot whose logical sequence lives in the arena blocks its block table
names.  One step copies the tick's copy-on-write (COW) blocks, scatters the
tick's K/V through the block table, gathers each slot's logical K/V view
back out and attends under the per-slot causal live mask
``arange(L) <= fill + j``.  Unlike the JAX package, which returns new cache
trees, the arenas here are updated IN PLACE.  And where JAX scatters
out-of-range indices with ``mode="drop"`` (the COW ``dst = NB`` of an idle
slot, the dead lanes past ``n_new``), :func:`paged_step` filters them out on
the host: torch has no drop mode, and an out-of-range index on the card is
a device-side assert.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_example_tpu_torch.normalization import FusedLayerNorm

Arena = Tuple[torch.Tensor, torch.Tensor]      # (K, V), [NB, BS, H, D] each


def _softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bool_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q [B, Sq, H, D], k/v [B, Sk, H, D]; ``bool_mask`` broadcasts against
    [B, H, Sq, Sk] (True = attend).  Returns [B, Sq, H, D]."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    logits = logits / math.sqrt(q.shape[-1])    # a division, as at :62
    if bool_mask is not None:
        logits = logits.masked_fill(~bool_mask, -1e9)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


@dataclass
class PagedStep:
    """One tick of paged slot decode, on the device.  Built by
    :func:`paged_step` from the host's per-slot state; every layer reads
    the same index tensors and updates its own arena in place."""

    arenas: Sequence[Arena]
    tokens: torch.Tensor        # [S, C] token ids fed this tick
    pos: torch.Tensor           # [S, C] logical position fill + j
    table: torch.Tensor         # [S, max_blocks] block table, clipped
    cow_src: torch.Tensor       # [P] COW pairs of this tick (valid only)
    cow_dst: torch.Tensor       # [P]
    write_rows: torch.Tensor    # [W] flat arena rows the real lanes write
    write_lanes: torch.Tensor   # [W] their flat lane index s * C + j
    last_lane: torch.Tensor     # [S] lane of each slot's last real token


def paged_step(arenas: Sequence[Arena], tokens: np.ndarray,
               block_table: np.ndarray, fill: np.ndarray, n_new: np.ndarray,
               cow_src: np.ndarray, cow_dst: np.ndarray,
               device) -> PagedStep:
    """Host-side index math of bert.py:250-320 for one tick, moved to the
    device in one copy.  ``tokens`` is [S, C]; the rest is the host's
    per-slot state as the engine builds it (``cow_dst < 0``: no COW)."""
    num_blocks, block_size = arenas[0][0].shape[:2]
    S, C = tokens.shape
    max_blocks = block_table.shape[1]
    j = np.arange(C)
    fill = fill.astype(np.int64)
    pos = fill[:, None] + j[None, :]
    blk = np.take_along_axis(block_table.astype(np.int64),
                             np.clip(pos // block_size, 0, max_blocks - 1),
                             axis=1)
    flat = blk * block_size + pos % block_size
    real = (j[None, :] < n_new[:, None]) & (flat >= 0) \
        & (flat < num_blocks * block_size)
    lanes = np.arange(S)[:, None] * C + j[None, :]
    cow = (cow_dst >= 0) & (cow_dst < num_blocks)
    parts = [np.asarray(p, np.int64) for p in (
        tokens, pos, np.clip(block_table, 0, num_blocks - 1),
        np.clip(cow_src[cow], 0, num_blocks - 1), cow_dst[cow],
        flat[real], lanes[real], np.clip(n_new - 1, 0, C - 1))]
    packed = torch.from_numpy(
        np.concatenate([p.ravel() for p in parts])).to(device)
    views, at = [], 0
    for p in parts:
        views.append(packed[at:at + p.size].view(p.shape))
        at += p.size
    return PagedStep(arenas, *views)


def paged_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    arena: Arena, step: PagedStep) -> torch.Tensor:
    """bert.py:250-326 for one layer: COW, scatter, gather, attend.
    q/k/v are [S, C, H, D]; the arena is updated in place."""
    K, V = arena
    num_blocks, block_size, h, hd = K.shape
    S, C = q.shape[:2]
    # 1. Copy-on-write: this tick's first write into a shared block lands
    # in the fresh copy the host allocated (index_select copies first).
    K.index_copy_(0, step.cow_dst, K.index_select(0, step.cow_src))
    V.index_copy_(0, step.cow_dst, V.index_select(0, step.cow_src))
    # 2. Scatter the real lanes' K/V through the block table.
    rows = num_blocks * block_size
    K.view(rows, h, hd).index_copy_(
        0, step.write_rows, k.reshape(S * C, h, hd).index_select(
            0, step.write_lanes))
    V.view(rows, h, hd).index_copy_(
        0, step.write_rows, v.reshape(S * C, h, hd).index_select(
            0, step.write_lanes))
    # 3. Gather each slot's logical view and attend under the live mask:
    # query j (position fill + j) sees keys at positions <= fill + j.
    keys = K[step.table].reshape(S, -1, h, hd)
    vals = V[step.table].reshape(S, -1, h, hd)
    L = keys.shape[1]
    live = torch.arange(L, device=q.device)[None, None, :] \
        <= step.pos[:, :, None]
    return _softmax_attention(q, keys, vals, live[:, None])


class BertSelfAttention(nn.Module):
    """Causal self-attention with the JAX module's parameter names
    (query, key, value, output)."""

    def __init__(self, hidden_size: int, num_heads: int, device=None):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden {hidden_size} is not a multiple of "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        self.query = nn.Linear(hidden_size, hidden_size, device=device)
        self.key = nn.Linear(hidden_size, hidden_size, device=device)
        self.value = nn.Linear(hidden_size, hidden_size, device=device)
        self.output = nn.Linear(hidden_size, hidden_size, device=device)

    def forward(self, x: torch.Tensor, arena: Optional[Arena] = None,
                step: Optional[PagedStep] = None) -> torch.Tensor:
        B, L, d = x.shape
        h = self.num_heads
        q = self.query(x).view(B, L, h, d // h)
        k = self.key(x).view(B, L, h, d // h)
        v = self.value(x).view(B, L, h, d // h)
        if step is None:
            tri = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
            ctx = _softmax_attention(q, k, v, tri[None, None])
        else:
            ctx = paged_attention(q, k, v, arena, step)
        return self.output(ctx.reshape(B, L, d))


class BertLayer(nn.Module):
    """Post-LN layer: x = LN(x + attn(x)); x = LN(x + FFN(x)), exact GELU."""

    def __init__(self, hidden_size: int, num_heads: int,
                 intermediate_size: int, device=None):
        super().__init__()
        self.attention = BertSelfAttention(hidden_size, num_heads, device)
        self.attention_ln = FusedLayerNorm(hidden_size, device=device)
        self.intermediate = nn.Linear(hidden_size, intermediate_size,
                                      device=device)
        self.output = nn.Linear(intermediate_size, hidden_size, device=device)
        self.output_ln = FusedLayerNorm(hidden_size, device=device)

    def forward(self, x: torch.Tensor, arena: Optional[Arena] = None,
                step: Optional[PagedStep] = None) -> torch.Tensor:
        x = self.attention_ln(x + self.attention(x, arena, step))
        y = self.output(F.gelu(self.intermediate(x), approximate="none"))
        return self.output_ln(x + y)

