"""Symmetric low-bit quantization numerics of the port (quant/core.py);
its one user so far is the int8 gradient exchange of
parallel/distributed.py."""

from apex_example_tpu_torch.quant.core import (FP8_QMAX, INT8_QMAX,
                                               SCALE_EPS, abs_max_scale,
                                               dequantize, quantize_fp8,
                                               quantize_int8)

__all__ = ["FP8_QMAX", "INT8_QMAX", "SCALE_EPS", "abs_max_scale",
           "dequantize", "quantize_fp8", "quantize_int8"]
