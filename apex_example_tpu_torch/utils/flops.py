"""Analytic training FLOPs of the port's models, and MFU: port of
apex_example_tpu/utils/flops.py (:29-120) with the card's peaks.

- Transformers (BERT, GPT, Transformer-XL): ``6 N_matmul`` FLOPs a token
  (two a multiply-add, three for forward and backward, over every matmul
  weight: Q, K, V, O, the FFN, the vocabulary head, Transformer-XL's
  relative-position projection) plus the attention's ``12 L S_attn d``
  (QK^T and AV, S d multiply-adds each a token and layer).  Embedding
  gathers count 0.
- ResNets: each convolution's ``2 K^2 C_in C_out H_out^2`` a forward
  image, times three for training; BatchNorm, ReLU and pooling count 0.

The peak comes from the card, chosen by ``torch.cuda.get_device_name``:
the H100 SXM's dense 989.4 TFLOP/s for bf16 and fp16 on the tensor cores
and 66.9 TFLOP/s for fp32 (``PEAKS``).  A card not in the table raises;
nothing assumes an H100.  No step record carries MFU; chip_smoke.py
prints it beside its training lines.
"""

from __future__ import annotations

import torch

# (dense bf16/fp16 tensor-core FLOP/s, fp32 FLOP/s), by the names
# torch.cuda.get_device_name gives the card
PEAKS = {"NVIDIA H100 80GB HBM3": (989.4e12, 66.9e12)}


def peak_flops(device_name: str, dtype: torch.dtype = torch.bfloat16
               ) -> float:
    """The card's peak FLOP/s for products in ``dtype``: the tensor
    cores' for bf16 and fp16, the fp32 rate for fp32."""
    if device_name not in PEAKS:
        raise ValueError(f"no peak FLOP/s known for {device_name!r} (known: "
                         f"{sorted(PEAKS)})")
    half, fp32 = PEAKS[device_name]
    if dtype in (torch.bfloat16, torch.float16):
        return half
    if dtype == torch.float32:
        return fp32
    raise ValueError(f"no peak for products in {dtype}")


def device_peak_flops(dtype: torch.dtype = torch.bfloat16) -> float:
    """:func:`peak_flops` of the current card."""
    return peak_flops(torch.cuda.get_device_name(), dtype)


def mfu_pct(items_per_sec: float, flops_per_item: float,
            peak: float) -> float:
    """Model-FLOPs utilisation in percent of ``peak`` FLOP/s."""
    return 100.0 * items_per_sec * flops_per_item / peak


_RESNET_CFG = {
    # stage sizes, bottleneck
    "resnet18": ([2, 2, 2, 2], False),
    "resnet34": ([3, 4, 6, 3], False),
    "resnet50": ([3, 4, 6, 3], True),
    "resnet101": ([3, 4, 23, 3], True),
    "resnet152": ([3, 8, 36, 3], True),
}


def _resnet_convs(stage_sizes, bottleneck, image_size):
    """[(k, cin, cout, hout)] of the torchvision geometry
    (models/resnet.py: the 7x7/2 stem and 3x3/2 max pool, stages at
    strides 1, 2, 2, 2, a projection on each stage's first block)."""
    convs = []
    h = image_size // 2                      # stem stride 2
    convs.append((7, 3, 64, h))
    h = -(-h // 2)                           # max pool stride 2 (SAME)
    cin = 64
    for si, n_blocks in enumerate(stage_sizes):
        f = 64 * 2 ** si
        for b in range(n_blocks):
            s = 2 if (si > 0 and b == 0) else 1
            hout = -(-h // s)
            if bottleneck:
                convs += [(1, cin, f, h), (3, f, f, hout),
                          (1, f, 4 * f, hout)]
                cout = 4 * f
            else:
                convs += [(3, cin, f, hout), (3, f, f, hout)]
                cout = f
            if b == 0 and (s != 1 or cin != cout):
                convs.append((1, cin, cout, hout))
            cin, h = cout, hout
    return convs


def resnet_train_flops_per_image(arch: str, image_size: int,
                                 num_classes: int) -> float:
    stage_sizes, bottleneck = _RESNET_CFG[arch]
    convs = _resnet_convs(stage_sizes, bottleneck, image_size)
    fwd = sum(2.0 * k * k * cin * cout * hout * hout
              for k, cin, cout, hout in convs)
    fwd += 2.0 * 512 * (4 if bottleneck else 1) * num_classes   # fc
    return 3.0 * fwd


def transformer_train_flops_per_token(*, num_layers: int, d_model: int,
                                      d_ff: int, vocab_size: int,
                                      attn_span: int,
                                      extra_proj_per_layer: int = 0) -> float:
    """``attn_span``: the keys a query attends over (the sequence for BERT
    and GPT; sequence + mem_len for Transformer-XL).
    ``extra_proj_per_layer``: matmul parameters a layer beyond Q, K, V, O
    and the FFN (Transformer-XL's relative-position projection, d x d)."""
    per_layer_params = 4 * d_model * d_model + 2 * d_model * d_ff \
        + extra_proj_per_layer
    n_matmul = num_layers * per_layer_params + d_model * vocab_size
    attn = 12.0 * num_layers * attn_span * d_model
    return 6.0 * n_matmul + attn


def model_train_flops_per_token(model, seq_len: int) -> float:
    """FLOPs a trained token of a port model (models/bert.py, gpt.py,
    transformer_xl.py), read off its modules."""
    if hasattr(model, "mem_len"):            # TransformerXL
        return transformer_train_flops_per_token(
            num_layers=model.num_layers, d_model=model.d_model,
            d_ff=model.layers[0].ff1.out_features,
            vocab_size=model.vocab_size, attn_span=seq_len + model.mem_len,
            extra_proj_per_layer=model.d_model * model.d_model)
    return transformer_train_flops_per_token(
        num_layers=model.num_layers, d_model=model.hidden_size,
        d_ff=model.layers[0].intermediate.out_features,
        vocab_size=model.vocab_size, attn_span=seq_len)
