"""LayerNorm forward: the hand-written Hopper kernel and its plain version.

Port of the forward half of apex_example_tpu/ops/layer_norm.py.
``layer_norm_plain`` is the arithmetic of ``layer_norm_reference`` (:47)
and of the Pallas ``_fwd_kernel`` (:66) in plain torch; ``layer_norm_cuda``
launches csrc/layer_norm.cu, the kernel that replaces ``_fwd_kernel`` on
the card (its source note states the bound and the design).

``layer_norm_fwd`` chooses by where the tensor lies: a CPU tensor takes the
plain version, a CUDA tensor the kernel, and the kernel's wrapper raises on
anything it cannot take.  Nothing falls back from one to the other.

Forward only: the backward (``_bwd_kernel`` :82) waits for training.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from apex_example_tpu_torch.ops import _build

MAX_H = 8192            # the widest row the kernel takes (kMaxH)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARG_ERRORS = {-1: "unsupported dtype", -2: "hidden size out of range",
               -3: "row count out of range"}

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def layer_norm_plain(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, eps: float = 1e-5) -> Stats:
    """``(y, mean, rstd)`` over the last axis of a 2-D ``x``: the fp32
    mean, the fp32 variance of the centred row, ``rsqrt(var + eps)``; y in
    x's dtype, mean and rstd fp32 of shape (N,)."""
    xf = x.float()
    mean = xf.mean(-1)
    xc = xf - mean[:, None]
    rstd = torch.rsqrt((xc * xc).mean(-1) + eps)
    y = xc * rstd[:, None] * gamma.float() + beta.float()
    return y.to(x.dtype), mean, rstd


def _check_args(x: torch.Tensor, gamma: torch.Tensor,
                beta: torch.Tensor) -> None:
    """Everything the kernel does not take raises here, before a build
    or a launch: shape, dtype and layout first, the device last."""
    if x.dim() != 2:
        raise ValueError(f"layer_norm_cuda takes (N, H) rows, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"layer_norm_cuda takes float32, bfloat16 or "
                        f"float16 x, got {x.dtype}")
    n, h = x.shape
    if not 1 <= h <= MAX_H:
        raise ValueError(f"layer_norm_cuda takes 1 <= H <= {MAX_H}, "
                         f"got H = {h}")
    if n >= 2 ** 31:
        raise ValueError(f"layer_norm_cuda takes fewer than 2**31 rows, "
                         f"got {n}")
    for pname, p in (("gamma", gamma), ("beta", beta)):
        if tuple(p.shape) != (h,) or p.dtype != torch.float32:
            raise ValueError(f"{pname} must be float32 of shape ({h},), got "
                             f"{p.dtype} {tuple(p.shape)}")
        if p.device != x.device:
            raise ValueError(f"{pname} lies on {p.device}, x on {x.device}")
    for tname, t in (("x", x), ("gamma", gamma), ("beta", beta)):
        if not t.is_contiguous():
            raise ValueError(f"layer_norm_cuda takes contiguous tensors; "
                             f"{tname} is not")
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_cuda launches a CUDA kernel; x lies "
                         f"on {x.device}")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("layer_norm")
    lib.apex_layer_norm_fwd.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    lib.apex_layer_norm_fwd.restype = ctypes.c_int
    lib.apex_cuda_error_string.argtypes = [ctypes.c_int]
    lib.apex_cuda_error_string.restype = ctypes.c_char_p
    return lib


def layer_norm_cuda(x: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor, eps: float = 1e-5) -> Stats:
    """``(y, mean, rstd)`` like :func:`layer_norm_plain`, computed by the
    CUDA kernel on PyTorch's current stream.  ``layer_norm_cuda.launches``
    counts the kernel's launches."""
    _check_args(x, gamma, beta)
    n, h = x.shape
    y = torch.empty_like(x)
    mean = torch.empty(n, dtype=torch.float32, device=x.device)
    rstd = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return y, mean, rstd
    lib = _library()
    with torch.cuda.device(x.device):
        rc = lib.apex_layer_norm_fwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), n, h, float(eps),
            _DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        why = _ARG_ERRORS.get(rc) or lib.apex_cuda_error_string(rc).decode()
        raise RuntimeError(f"layer_norm kernel launch failed ({rc}): {why}")
    layer_norm_cuda.launches += 1
    return y, mean, rstd


layer_norm_cuda.launches = 0


def layer_norm_fwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-5) -> Stats:
    """LayerNorm over the last axis of ``x`` (..., H): ``(y, mean, rstd)``
    with y shaped like x and the fp32 stats flattened to (N,), as
    ``_layer_norm_fwd`` (:218) returns them."""
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    if x2d.device.type == "cpu":
        y, mean, rstd = layer_norm_plain(x2d, gamma, beta, eps)
    else:
        y, mean, rstd = layer_norm_cuda(x2d, gamma, beta, eps)
    return y.reshape(shape), mean, rstd


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Fused LayerNorm over the last axis; x (..., H), gamma/beta (H,)."""
    return layer_norm_fwd(x, gamma, beta, eps)[0]
