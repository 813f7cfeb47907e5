"""Transformer-XL for causal LM (workload C5): port of
apex_example_tpu/models/transformer_xl.py without its tensor-parallel
branches.

- Segment recurrence: each layer's INPUT of a segment, after that layer's
  memory, cut to the last ``mem_len`` positions and detached, is the
  layer's memory for the next segment (:229-233).  The memory is
  ``(num_layers, B, mem_len, d_model)``; :meth:`TransformerXL.init_mems`
  gives the zeros a document starts from.  Detached, the carried memory
  never leads a backward into the step that made it.
- Relative attention (:57-122): q from the segment, k and v from memory +
  segment, r from the sinusoidal encodings of the distances klen-1 .. 0
  (clamped at ``clamp_len``, fp32, :219-226), computed on the host and
  cached per length and device, so that every device gets the same bits:
  in fp32 one ulp of ``inv_freq``, times a distance of 341, moves an
  encoding by 3e-5, and the card's ``powf`` and the CPU's may differ by
  that ulp; no projection has a bias;
  per-layer ``u_bias`` and ``v_bias`` (h, head_dim).  Content score AC =
  (q + u) . k plus position score BD = :func:`rel_shift` ((q + v) . r),
  DIVIDED by sqrt(head_dim); the causal-with-memory mask lets query i see
  keys 0 .. mlen + i and fills the rest with -1e30 (-1e4 under a half
  softmax; not -inf); softmax in ``softmax_dtype``.
- Post-LN layers (:136-164): FusedLayerNorm after attention + residual and
  after the ReLU FFN + residual (the LayerNorm kernels on the card).
- Embedding scaled by sqrt(d_model) (:216); the head is tied, x @ E^T with
  no bias, fp32 logits (:240).

Precision (amp, the JAX model's ``dtype``, ``param_dtype``, ``ln_dtype``
and ``softmax_dtype``, :47-50, :129-132, :182-185): the projections, the
FFN and the tied head compute in ``dtype`` over parameters stored in
``param_dtype`` (fp32 masters under O2, cast at call time; half under O3,
``u_bias`` and ``v_bias`` with them; the LayerNorms' stay fp32); the
embedding is looked up, cast to ``dtype`` and scaled by sqrt(d_model)
rounded to ``dtype`` (:216); the LayerNorms' I/O is ``ln_dtype`` (None:
``dtype``); the attention logits are divided by sqrt(head_dim) rounded to
``softmax_dtype`` (:97) and the softmax runs in it (fp32 up to O2, half
under O3); the logits are ``dtype``, then fp32 (:239).  The memory is in
``dtype`` (:193), and so is every layer input that the carry keeps.

Weights: random from ``seed`` (a CPU ``torch.Generator``, in flax's
initializers' distributions, so the same seed gives the same weights on any
device), or a flax tree through convert.txl_params_from_flax.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_example_tpu_torch import resolve_device
from apex_example_tpu_torch.models.bert import Dense
from apex_example_tpu_torch.normalization import FusedLayerNorm


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(..., q, k) scores indexed by key position -> indexed by distance:
    pad one column on the left, view as (..., k + 1, q), drop the first
    row, view back as (..., q, k) (:32-42).  ``reshape`` copies where a
    view cannot express the result."""
    *lead, q, k = x.shape
    x = F.pad(x, (1, 0))
    x = x.reshape(*lead, k + 1, q)[..., 1:, :]
    return x.reshape(*lead, q, k)


def rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to fp32, then to ``dtype``: the JAX model's
    ``jnp.sqrt(n).astype(dtype)`` for a scalar it multiplies or divides
    by."""
    return float(torch.tensor(value, dtype=torch.float32).to(dtype))


class RelMultiHeadAttn(nn.Module):
    """Relative multi-head attention with the flax module's parameter names
    (q, k, v, r, o, u_bias, v_bias), computing in ``dtype`` with its
    softmax in ``softmax_dtype``."""

    def __init__(self, d_model: int, num_heads: int,
                 dtype: torch.dtype = torch.float32,
                 softmax_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype, self.softmax_dtype = dtype, softmax_dtype
        for name in ("q", "k", "v", "r", "o"):
            setattr(self, name, Dense(d_model, d_model, dtype=dtype,
                                      bias=False))
        hd = d_model // num_heads
        self.u_bias = nn.Parameter(torch.zeros(num_heads, hd))
        self.v_bias = nn.Parameter(torch.zeros(num_heads, hd))

    def forward(self, x: torch.Tensor, mem: torch.Tensor,
                pos_emb: torch.Tensor) -> torch.Tensor:
        """x (B, q, d); mem (B, m, d); pos_emb (q + m, d) for distances
        q + m - 1 .. 0.  Returns (B, q, d)."""
        b, qlen, d = x.shape
        mlen = mem.shape[1]
        klen = qlen + mlen
        h = self.num_heads
        hd = d // h
        dt, sd = self.dtype, self.softmax_dtype
        cat = torch.cat([mem.to(x.dtype), x], dim=1)
        q = self.q(x).view(b, qlen, h, hd)
        k = self.k(cat).view(b, klen, h, hd)
        v = self.v(cat).view(b, klen, h, hd)
        r = self.r(pos_emb).view(klen, h, hd)
        ac = torch.einsum("bqhd,bkhd->bhqk", q + self.u_bias.to(dt), k)
        bd = rel_shift(torch.einsum("bqhd,khd->bhqk",
                                    q + self.v_bias.to(dt), r))
        logits = (ac + bd).to(sd) / rounded(math.sqrt(hd), sd)
        qi = torch.arange(qlen, device=x.device)[:, None]
        kj = torch.arange(klen, device=x.device)[None, :]
        neg = -1e30 if sd == torch.float32 else -1e4
        logits = logits.masked_fill(~(kj <= qi + mlen), neg)
        probs = torch.softmax(logits, dim=-1).to(dt)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, qlen, d)
        return self.o(ctx)


class TXLLayer(nn.Module):
    """x = LN(x + attn(x, mem)); x = LN(x + ff2(relu(ff1(x)))); the
    LayerNorms' I/O in ``ln_dtype`` (None: ``dtype``), the rest in
    ``dtype``."""

    def __init__(self, d_model: int, num_heads: int, d_inner: int,
                 dtype: torch.dtype = torch.float32,
                 ln_dtype: Optional[torch.dtype] = None,
                 softmax_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.ln_dtype = dtype, ln_dtype or dtype
        self.attn = RelMultiHeadAttn(d_model, num_heads, dtype,
                                     softmax_dtype)
        self.attn_ln = FusedLayerNorm(d_model)
        self.ff1 = Dense(d_model, d_inner, dtype=dtype)
        self.ff2 = Dense(d_inner, d_model, dtype=dtype)
        self.ff_ln = FusedLayerNorm(d_model)

    def forward(self, x: torch.Tensor, mem: torch.Tensor,
                pos_emb: torch.Tensor) -> torch.Tensor:
        ln, dt = self.ln_dtype, self.dtype
        x = self.attn_ln((x + self.attn(x, mem, pos_emb)).to(ln)).to(dt)
        y = self.ff2(F.relu(self.ff1(x)))
        return self.ff_ln((x + y).to(ln)).to(dt)


class TransformerXL(nn.Module):
    """``forward(ids, mems) -> (logits, new_mems)``; mems (num_layers, B,
    mem_len, d_model) in ``dtype``, None for the zeros of a new document.
    ``dtype``, ``param_dtype``, ``ln_dtype`` and ``softmax_dtype`` as the
    JAX module's (see the module notes)."""

    def __init__(self, vocab_size: int = 267735, d_model: int = 410,
                 num_layers: int = 16, num_heads: int = 10,
                 d_inner: int = 2100, mem_len: int = 150,
                 clamp_len: int = 1000, seed: int = 0, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32,
                 ln_dtype: Optional[torch.dtype] = None,
                 softmax_dtype: torch.dtype = torch.float32):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"{num_heads} heads")
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.num_layers = num_layers
        self.mem_len = mem_len
        self.clamp_len = clamp_len
        self.dtype = dtype
        self._pos_emb = {}          # (klen, device) -> encodings
        # Built without storage, filled from the seeded generator on the
        # host, then moved: the weights depend on the seed alone.
        with torch.device("meta"):
            self.word_emb = nn.Embedding(vocab_size, d_model)
            self.layers = nn.ModuleList(
                TXLLayer(d_model, num_heads, d_inner, dtype, ln_dtype,
                         softmax_dtype)
                for _ in range(num_layers))
        self.to_empty(device="cpu")
        init_txl_weights(self, seed)
        if param_dtype != torch.float32:    # all but the LayerNorms'
            for mod in self.modules():
                if isinstance(mod, (nn.Linear, nn.Embedding,
                                    RelMultiHeadAttn)):
                    mod.to(param_dtype)
        self.to(resolve_device(device))

    def init_mems(self, batch_size: int) -> torch.Tensor:
        """The zero memory a document starts from, in ``dtype`` on the
        model's device."""
        return torch.zeros(self.num_layers, batch_size, self.mem_len,
                           self.d_model, dtype=self.dtype,
                           device=self.word_emb.weight.device)

    def pos_emb(self, klen: int, device) -> torch.Tensor:
        """Sinusoidal encodings (klen, d_model) of the distances klen-1 ..
        0, clamped at ``clamp_len``, fp32: [sin | cos], computed on the
        host once per (klen, device)."""
        key = (klen, str(device))
        if key not in self._pos_emb:
            pos = torch.arange(klen - 1, -1, -1.0)
            if self.clamp_len > 0:
                pos = pos.clamp(max=float(self.clamp_len))
            inv_freq = 1.0 / (10000.0 ** (torch.arange(
                0, self.d_model, 2.0) / self.d_model))
            sinusoid = pos[:, None] * inv_freq[None, :]
            self._pos_emb[key] = torch.cat(
                [torch.sin(sinusoid), torch.cos(sinusoid)], dim=-1).to(device)
        return self._pos_emb[key]

    def forward(self, input_ids: torch.Tensor,
                mems: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, qlen = input_ids.shape
        if mems is None:
            mems = self.init_mems(b)
        klen = qlen + mems.shape[2]
        dt = self.dtype
        x = self.word_emb(input_ids).to(dt) * rounded(math.sqrt(self.d_model),
                                                      dt)
        pos_emb = self.pos_emb(klen, input_ids.device)
        new_mems = []
        for i, layer in enumerate(self.layers):
            new_mems.append(
                torch.cat([mems[i], x], dim=1)[:, -self.mem_len:].detach())
            x = layer(x, mems[i], pos_emb)
        logits = F.linear(x, self.word_emb.weight.to(dt)).float()
        return logits, torch.stack(new_mems)


def init_txl_weights(model: TransformerXL, seed: int) -> None:
    """flax's default initializers in distribution, drawn from a CPU
    generator seeded with ``seed``: the embedding normal with std
    1/sqrt(d_model); Dense kernels ``lecun_normal`` (a normal truncated at
    two standard deviations, variance 1/fan_in); biases, ``u_bias`` and
    ``v_bias`` zero; LayerNorm scale one."""
    gen = torch.Generator().manual_seed(seed)
    trunc_std = 0.87962566103423978   # std of a unit normal cut at +-2
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            elif name == "word_emb.weight":
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=gen)
            else:                             # [out, in] Linear weight
                std = 1.0 / math.sqrt(p.shape[1]) / trunc_std
                nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=gen)


def transformer_xl_base(**kw) -> TransformerXL:
    return TransformerXL(**kw)


def transformer_xl_tiny(**kw) -> TransformerXL:
    """Test-scale configuration (same code path, CPU-friendly)."""
    kw.setdefault("vocab_size", 256)
    kw.setdefault("d_model", 64)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("d_inner", 128)
    kw.setdefault("mem_len", 16)
    return TransformerXL(**kw)
