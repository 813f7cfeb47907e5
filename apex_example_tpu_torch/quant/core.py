"""Symmetric max-abs quantization: port of apex_example_tpu/quant/core.py
(``abs_max_scale`` :57, ``quantize_int8`` :67, ``dequantize`` :77,
``quantize_fp8`` :85).

``scale = max(amax / Q, SCALE_EPS)`` with Q = 127 (int8) or 448 (the
largest normal of float8 e4m3), the division taken as the product by
``1 / Q`` in fp32, which is what XLA compiles the JAX package's ``amax /
qmax`` into inside a jitted step such as its DDP step (a division by a
constant becomes a product by its reciprocal; 4.7% of uniform inputs
round an ulp apart from the true quotient, which eager JAX gives), so
that the scales, and the int8 grids on them, are the compiled JAX
package's bit for bit; ``q = round(x / scale)`` clipped into
[-Q, Q]; ``dequantize(q, scale) = q * scale``.  The rounding is to
nearest, ties to even (``torch.round``, as ``jnp.round``), so that sums of
the rounded values agree with the JAX package's bit for bit.  The clip
matters where a scale is stored narrower than fp32: a scale rounded down
puts ``amax / scale`` just above Q.  Error bound: ``|x - dq| <= scale / 2``
for a value inside the clip.

fp8: torch has ``float8_e4m3fn``, so ``quantize_fp8`` stores it natively
(the JAX package's bf16 emulation is for a jax without the dtype).
Everything here is elementwise torch on the tensor's device: the JAX
package leaves it to XLA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

INT8_QMAX = 127.0
FP8_QMAX = 448.0          # float8_e4m3fn: the largest normal, no inf
SCALE_EPS = 1e-30         # floor of a scale: an all-zero slice stays finite


def abs_max_scale(x: torch.Tensor, dim: Optional[int] = None,
                  qmax: float = INT8_QMAX,
                  keepdim: bool = True) -> torch.Tensor:
    """The symmetric max-abs scale of ``x`` over ``dim`` (None: the whole
    tensor), fp32, floored at ``SCALE_EPS``."""
    a = x.float().abs()
    if dim is None:
        amax = a.amax()
        if keepdim:
            amax = amax.reshape([1] * x.dim())
    else:
        amax = a.amax(dim=dim, keepdim=keepdim)
    return torch.clamp(amax * (1.0 / qmax), min=SCALE_EPS)


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x`` on the int8 grid of ``scale``: round to nearest even of
    ``x / scale`` in fp32, clipped into [-127, 127]."""
    q = torch.round(x.float() / scale.float())
    return torch.clamp(q, -INT8_QMAX, INT8_QMAX).to(torch.int8)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q * scale`` in fp32, cast to ``dtype``."""
    return (q.float() * scale.float()).to(dtype)


def quantize_fp8(x: torch.Tensor,
                 scale: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """``x / scale`` clipped into +-448 and cast to float8 e4m3.  Returns
    ``(q, emulated)``; ``emulated`` is always False here (torch stores the
    dtype), kept for the JAX function's signature."""
    scaled = torch.clamp(x.float() / scale.float(), -FP8_QMAX, FP8_QMAX)
    return scaled.to(torch.float8_e4m3fn), False
