"""BERT: port of apex_example_tpu/models/bert.py.

``BertSelfAttention`` (:72) and ``BertLayer`` (:418): attention over the
whole sequence, causal for GPT or bidirectional with an optional additive
key mask for BERT, or causal as a step of block-paged slot decode
(:187-327); the dense GELU FFN (:497-501) with post-LN residuals
(:468-469, :502-503).  ``BertForMaskedLM`` (:508) is the encoder with the
MLM head whose decoder is tied to the word embeddings; ``bert_base`` and
``bert_tiny`` build it.

Attention over whole sequences takes one of two routes, as in JAX
(``_resolve_fused_attention`` :36, :399-415).  The flash-attention kernels
(ops/attention.py ``flash_attention``: scale by multiplication, the key
bias ``mask_bias[:, 0, 0, :]`` in fp32, causal bottom-right) run when
``fused_attention`` is True, or "auto" (the default) at sequence
``FLASH_AUTO_MIN_SEQ`` = 2048 and up, and only under an fp32 softmax: the
kernels' softmax is always fp32, so O3's half softmax keeps the einsum
path.  The einsum core ``_softmax_attention`` (:51) otherwise: logits
DIVIDED by sqrt(head_dim), a boolean mask as -1e9 (-1e4 for a half
softmax), an additive bias clamped at the same, softmax in
``softmax_dtype``.  Paged decode keeps its own path (:157).

Precision (amp, amp/autocast.py ``module_dtypes``): dense layers and
embeddings compute in ``dtype`` over parameters stored in ``param_dtype``
(fp32 masters under O2, cast at call time as flax's ``dtype`` does);
LayerNorm's I/O is ``ln_dtype`` (None: ``dtype``), its statistics fp32 in
the kernel; softmax ``softmax_dtype``; the head's bias and the logits
fp32 (:620-627).

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

import functools
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_example_tpu_torch import resolve_device
from apex_example_tpu_torch.normalization import FusedLayerNorm
from apex_example_tpu_torch.ops.attention import flash_attention

Arena = Tuple[torch.Tensor, torch.Tensor]      # (K, V), [NB, BS, H, D] each
FusedSetting = Union[bool, str]

# The JAX package's crossover (:33): "auto" takes the kernels at this
# sequence length and up.
FLASH_AUTO_MIN_SEQ = 2048


def resolve_fused_attention(setting: FusedSetting, seq_len: int,
                            softmax_dtype: torch.dtype) -> bool:
    """Whether attention over ``seq_len`` takes the kernels (:36-48): an
    explicit bool wins, "auto" keys on ``FLASH_AUTO_MIN_SEQ``; a half
    softmax (O3) always takes the einsum path."""
    if softmax_dtype != torch.float32:
        return False
    if isinstance(setting, bool):
        return setting
    if setting == "auto":
        return seq_len >= FLASH_AUTO_MIN_SEQ
    raise ValueError(f"fused_attention must be bool or 'auto', "
                     f"got {setting!r}")


def _softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bool_mask: Optional[torch.Tensor],
                       add_bias: Optional[torch.Tensor] = None,
                       softmax_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """q [B, Sq, H, D], k/v [B, Sk, H, D]; ``bool_mask`` broadcasts against
    [B, H, Sq, Sk] (True = attend), ``add_bias`` too (added, clamped at
    -1e9, or -1e4 for a half softmax, as at :67).  Returns [B, Sq, H, D]
    in v's dtype."""
    sd = softmax_dtype
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(sd)
    logits = logits / math.sqrt(q.shape[-1])    # a division, as at :62
    neg = -1e9 if sd == torch.float32 else -1e4
    if bool_mask is not None:
        logits = logits.masked_fill(~bool_mask, neg)
    if add_bias is not None:
        logits = logits + add_bias.clamp_min(neg).to(sd)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class Dense(nn.Linear):
    """Flax ``nn.Dense`` with ``dtype``: the input, weight and bias (where
    ``bias``) cast to ``dtype`` at call time, so the stored parameters stay
    the masters."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, device=None,
                 bias: bool = True):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


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
    """Self-attention with the JAX module's parameter names (query, key,
    value, output); ``causal`` masks keys after the query (:104)."""

    def __init__(self, hidden_size: int, num_heads: int, device=None,
                 causal: bool = False, dtype: torch.dtype = torch.float32,
                 softmax_dtype: torch.dtype = torch.float32,
                 fused_attention: FusedSetting = "auto"):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden {hidden_size} is not a multiple of "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        self.causal = causal
        self.softmax_dtype = softmax_dtype
        self.fused_attention = fused_attention
        dense = functools.partial(Dense, hidden_size, hidden_size,
                                  dtype=dtype, device=device)
        self.query, self.key, self.value, self.output = (
            dense(), dense(), dense(), dense())

    def uses_kernel(self, seq_len: int) -> bool:
        """Whether attention over ``seq_len`` tokens (not paged decode)
        takes the flash-attention kernels."""
        return resolve_fused_attention(self.fused_attention, seq_len,
                                       self.softmax_dtype)

    def forward(self, x: torch.Tensor, arena: Optional[Arena] = None,
                step: Optional[PagedStep] = None,
                mask_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask_bias`` broadcasts against [B, H, L, L] (BERT passes
        [B, 1, 1, L]); paged decode is causal and takes none."""
        B, L, d = x.shape
        h = self.num_heads
        q = self.query(x).view(B, L, h, d // h)
        k = self.key(x).view(B, L, h, d // h)
        v = self.value(x).view(B, L, h, d // h)
        if step is not None:
            if not self.causal or mask_bias is not None:
                raise ValueError("paged decode is the causal path and takes "
                                 "no mask")
            ctx = paged_attention(q, k, v, arena, step)
        elif self.uses_kernel(L):
            key_bias = (None if mask_bias is None
                        else mask_bias[:, 0, 0, :].float())
            ctx = flash_attention(q, k, v, key_bias, causal=self.causal,
                                  scale=1.0 / math.sqrt(d // h))
        else:
            tri = None
            if self.causal:
                tri = torch.ones(L, L, dtype=torch.bool,
                                 device=x.device).tril()[None, None]
            ctx = _softmax_attention(q, k, v, tri, mask_bias,
                                     self.softmax_dtype)
        return self.output(ctx.reshape(B, L, d))


class BertLayer(nn.Module):
    """Post-LN layer: x = LN(x + attn(x)); x = LN(x + FFN(x)), exact GELU.
    The LayerNorms' I/O is ``ln_dtype`` (None: ``dtype``), the rest
    computes in ``dtype`` (:459-509)."""

    def __init__(self, hidden_size: int, num_heads: int,
                 intermediate_size: int, device=None, causal: bool = False,
                 dtype: torch.dtype = torch.float32,
                 ln_dtype: Optional[torch.dtype] = None,
                 softmax_dtype: torch.dtype = torch.float32,
                 fused_attention: FusedSetting = "auto"):
        super().__init__()
        self.dtype = dtype
        self.ln_dtype = ln_dtype or dtype
        self.attention = BertSelfAttention(
            hidden_size, num_heads, device, causal=causal, dtype=dtype,
            softmax_dtype=softmax_dtype, fused_attention=fused_attention)
        self.attention_ln = FusedLayerNorm(hidden_size, device=device)
        self.intermediate = Dense(hidden_size, intermediate_size,
                                  dtype=dtype, device=device)
        self.output = Dense(intermediate_size, hidden_size, dtype=dtype,
                            device=device)
        self.output_ln = FusedLayerNorm(hidden_size, device=device)

    def forward(self, x: torch.Tensor, arena: Optional[Arena] = None,
                step: Optional[PagedStep] = None,
                mask_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        ln, dt = self.ln_dtype, self.dtype
        attn = self.attention(x, arena, step, mask_bias)
        x = self.attention_ln((x + attn).to(ln)).to(dt)
        y = self.output(F.gelu(self.intermediate(x), approximate="none"))
        return self.output_ln((x + y).to(ln)).to(dt)


def cast_params(model: nn.Module, param_dtype: torch.dtype) -> None:
    """Store the dense layers' and embeddings' parameters in
    ``param_dtype`` (O3's half parameters), after the fp32 init: the
    LayerNorms' and the head bias stay fp32 (flax's FusedLayerNorm and
    ``self.param(..., jnp.float32)``)."""
    if param_dtype == torch.float32:
        return
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Embedding)):
            mod.to(param_dtype)


class BertForMaskedLM(nn.Module):
    """BERT encoder + MLM head with the decoder tied to the word embeddings
    (:508, :546-637): word + position embeddings -> ``embeddings_ln`` -> N
    post-LN layers -> ``mlm_dense`` -> exact GELU -> ``mlm_ln`` ->
    ``x @ E^T + mlm_bias`` -> fp32 logits [B, L, vocab].  The tie is the one
    ``word_embeddings.weight`` Parameter, read by both ends.

    Weights: random from ``seed`` in the flax initializers' distributions
    (see :func:`init_bert_weights`), or a flax tree through
    convert.bert_params_from_flax.  ``dtype``, ``param_dtype``,
    ``ln_dtype``, ``softmax_dtype`` and ``fused_attention`` as the JAX
    module's (see the module notes)."""

    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 intermediate_size: int = 3072, max_position: int = 512,
                 seed: int = 0, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32,
                 ln_dtype: Optional[torch.dtype] = None,
                 softmax_dtype: torch.dtype = torch.float32,
                 fused_attention: FusedSetting = "auto"):
        super().__init__()
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_position = max_position
        self.dtype = dtype
        self.ln_dtype = ln_dtype or dtype
        # Built without storage, filled from the seeded generator on the
        # host, then moved: the weights depend on the seed alone.
        with torch.device("meta"):
            self.word_embeddings = nn.Embedding(vocab_size, hidden_size)
            self.position_embeddings = nn.Embedding(max_position,
                                                    hidden_size)
            self.embeddings_ln = FusedLayerNorm(hidden_size)
            self.layers = nn.ModuleList(
                BertLayer(hidden_size, num_heads, intermediate_size,
                          dtype=dtype, ln_dtype=ln_dtype,
                          softmax_dtype=softmax_dtype,
                          fused_attention=fused_attention)
                for _ in range(num_layers))
            self.mlm_dense = Dense(hidden_size, hidden_size, dtype=dtype)
            self.mlm_ln = FusedLayerNorm(hidden_size)
            self.mlm_bias = nn.Parameter(torch.zeros(vocab_size))
        self.to_empty(device="cpu")
        init_bert_weights(self, seed)
        cast_params(self, param_dtype)
        self.to(resolve_device(device))

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """[B, L] token ids (and an optional [B, L] mask, > 0 = attend)
        -> [B, L, vocab] fp32 logits."""
        x = embed(self, input_ids)
        mask_bias = None
        if attention_mask is not None:
            mask_bias = torch.where(attention_mask[:, None, None, :] > 0,
                                    0.0, -1e9).float()
        for layer in self.layers:
            x = layer(x, mask_bias=mask_bias)
        x = F.gelu(self.mlm_dense(x), approximate="none")
        return tied_logits(self, self.mlm_ln, x, self.mlm_bias)


def embed(model: nn.Module, input_ids: torch.Tensor,
          pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Word + position embeddings in ``model.dtype`` (fp32 tables looked
    up, then cast), then ``embeddings_ln`` with I/O in ``model.ln_dtype``
    (:582-599); ``pos`` defaults to 0 .. L - 1."""
    dt = model.dtype
    if pos is None:
        pos = torch.arange(input_ids.shape[1],
                           device=input_ids.device)[None, :]
    x = (model.word_embeddings(input_ids).to(dt)
         + model.position_embeddings(pos).to(dt))
    return model.embeddings_ln(x.to(model.ln_dtype)).to(dt)


def tied_logits(model: nn.Module, ln: nn.Module, x: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """The last LayerNorm, then the decoder tied to the word embeddings:
    ``x @ E^T`` in ``model.dtype`` plus the fp32 bias, fp32 logits
    (:617-627)."""
    dt = model.dtype
    x = ln(x.to(model.ln_dtype)).to(dt)
    logits = F.linear(x, model.word_embeddings.weight.to(dt))
    return (logits + bias).float()


def init_bert_weights(model: nn.Module, seed: int) -> None:
    """The flax initializers' distributions, drawn from a CPU generator
    seeded with ``seed``: Dense kernels ``lecun_normal`` (a normal truncated
    at two standard deviations, scaled to variance 1/fan_in), biases zero;
    embeddings ``variance_scaling(1, fan_in, normal)`` over the feature
    axis (std 1/sqrt(H)); LayerNorm scale one and bias zero.  The numbers
    differ from jax.random's: tests convert flax weights instead."""
    gen = torch.Generator().manual_seed(seed)
    # std of a unit normal truncated to [-2, 2] (jax.nn.initializers)
    trunc_std = 0.87962566103423978
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            elif "embeddings" in name:        # [V, H] table
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=gen)
            else:                             # [out, in] Linear weight
                std = 1.0 / math.sqrt(p.shape[1]) / trunc_std
                nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=gen)


def bert_base(**kw) -> BertForMaskedLM:
    return BertForMaskedLM(**kw)


def bert_tiny(**kw) -> BertForMaskedLM:
    """Test-scale configuration (same code path, CPU-friendly)."""
    kw.setdefault("vocab_size", 256)
    kw.setdefault("hidden_size", 64)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("intermediate_size", 128)
    kw.setdefault("max_position", 128)
    return BertForMaskedLM(**kw)

