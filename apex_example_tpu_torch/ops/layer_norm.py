"""LayerNorm and RMSNorm, forward and backward: the hand-written Hopper
kernels and their plain versions.

Port of apex_example_tpu/ops/layer_norm.py.  ``layer_norm_plain`` is the
arithmetic of ``layer_norm_reference`` (:47) and of the Pallas
``_fwd_kernel`` (:66) in plain torch; ``layer_norm_bwd_plain`` that of the
backward (:250-259, the Pallas ``_bwd_kernel`` :82).  ``layer_norm_cuda``
and ``layer_norm_bwd_cuda`` launch csrc/layer_norm.cu, the kernels that
replace them on the card (the source notes state the bounds and designs).

``layer_norm_fwd`` / ``layer_norm_bwd`` choose by where the tensor lies: a
CPU tensor takes the plain version, a CUDA tensor the kernel, and the
kernel's wrapper raises on anything it cannot take.  Nothing falls back
from one to the other.

``LayerNormFunction`` is the ``torch.autograd.Function`` of the JAX
``custom_vjp`` (:211-268): the forward saves ``(x, gamma, mean, rstd)``,
the backward recomputes x_hat from them.  ``layer_norm`` goes through it,
so gradients reach x, gamma and beta on either device.

RMSNorm (:271-343) follows the same shape name for name: ``rms_norm_plain``
is ``rms_norm_reference`` (:56) and the Pallas ``_rms_fwd_kernel`` (:278),
``rms_norm_bwd_plain`` the backward (:332-338, ``_rms_bwd_kernel`` :285),
``rms_norm_cuda`` / ``rms_norm_bwd_cuda`` launch the RMSNorm kernels of
csrc/layer_norm.cu, ``rms_norm_fwd`` / ``rms_norm_bwd`` dispatch on the
device and ``RMSNormFunction`` saves ``(x, gamma, rstd)``.

The kernels take fp32 gamma (and beta).  The JAX ops take parameters of
any float dtype, read them as fp32 and return their gradients in the
parameters' dtype; the dispatchers do the same: gamma and beta cast to
fp32 on the way in (exact from bf16 or fp16), dgamma and dbeta summed in
fp32 and rounded once to the parameters' dtype on the way out.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from apex_example_tpu_torch.ops import _build

MAX_H = 8192            # the widest row the kernel takes (kMaxH)
_ARG_ERRORS = {-1: "unsupported dtype", -2: "hidden size out of range",
               -3: "row count out of range", -4: "blocks out of range",
               -5: "pack width off", -6: "unknown layout"}
BWD_WARP_H = 1024       # rows up to this long take a warp each
BWD_WARPS = 8           # warps a block of the persistent grid (kBwdWarps)
BWD_TREE_GROUP = 16     # blocks whose rows one block adds first
BWD_FEW_ROWS = 256      # wide rows: up to this many, a block a row
BWD_ROWS_PER_GROUP = 4  # wide rows: rows one block takes above that
BWD_MAX_GROUPS = 1024   # wide rows: most blocks
BWD_WIDE, BWD_PERSIST = 0, 1    # the kernel's layouts

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the plain versions' arithmetic type: fp32, or fp64 for an
    fp64 tensor (what gradcheck feeds them)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def layer_norm_plain(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, eps: float = 1e-5) -> Stats:
    """``(y, mean, rstd)`` over the last axis of a 2-D ``x``: the fp32
    mean, the fp32 variance of the centred row, ``rsqrt(var + eps)``; y in
    x's dtype, mean and rstd fp32 of shape (N,)."""
    xf = _acc(x)
    mean = xf.mean(-1)
    xc = xf - mean[:, None]
    rstd = torch.rsqrt((xc * xc).mean(-1) + eps)
    y = xc * rstd[:, None] * gamma.to(xf.dtype) + beta.to(xf.dtype)
    return y.to(x.dtype), mean, rstd


def _check_args(x: torch.Tensor, gamma: torch.Tensor,
                beta: Optional[torch.Tensor],
                what: str = "layer_norm_cuda") -> None:
    """Everything the kernel does not take raises here, before a build
    or a launch: shape, dtype and layout first, the device last.  RMSNorm
    has no ``beta`` (None)."""
    if x.dim() != 2:
        raise ValueError(f"{what} takes (N, H) rows, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what} takes float32, bfloat16 or float16 x, "
                        f"got {x.dtype}")
    n, h = x.shape
    if not 1 <= h <= MAX_H:
        raise ValueError(f"{what} takes 1 <= H <= {MAX_H}, got H = {h}")
    if n >= 2 ** 31:
        raise ValueError(f"{what} takes fewer than 2**31 rows, got {n}")
    params = (("gamma", gamma),) + (() if beta is None else
                                    (("beta", beta),))
    for pname, p in params:
        if tuple(p.shape) != (h,) or p.dtype != torch.float32:
            raise ValueError(f"{pname} must be float32 of shape ({h},), got "
                             f"{p.dtype} {tuple(p.shape)}")
        if p.device != x.device:
            raise ValueError(f"{pname} lies on {p.device}, x on {x.device}")
    for tname, t in (("x", x),) + params:
        if not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors; {tname} is "
                             f"not")
    if x.device.type != "cuda":
        raise ValueError(f"{what} launches a CUDA kernel; x lies on "
                         f"{x.device}")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("layer_norm")
    lib.apex_layer_norm_fwd.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    lib.apex_layer_norm_fwd.restype = ctypes.c_int
    # n, h, blocks, tree rows, layout, vec, dtype, stream
    bwd_geo = [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
               ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.apex_layer_norm_bwd.argtypes = [ctypes.c_void_p] * 10 + bwd_geo
    lib.apex_layer_norm_bwd.restype = ctypes.c_int
    lib.apex_rms_norm_fwd.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    lib.apex_rms_norm_fwd.restype = ctypes.c_int
    lib.apex_rms_norm_bwd.argtypes = [ctypes.c_void_p] * 8 + bwd_geo
    lib.apex_rms_norm_bwd.restype = ctypes.c_int
    lib.apex_norm_bwd_resident.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.apex_norm_bwd_resident.restype = ctypes.c_int
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
            _build.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, lib, "layer_norm", _ARG_ERRORS)
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
        y, mean, rstd = layer_norm_cuda(x2d, gamma.float(), beta.float(),
                                        eps)
    return y.reshape(shape), mean, rstd


Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def layer_norm_bwd_plain(x: torch.Tensor, gamma: torch.Tensor,
                         mean: torch.Tensor, rstd: torch.Tensor,
                         dy: torch.Tensor) -> Grads:
    """``(dx, dgamma, dbeta)`` for a 2-D ``x`` and ``dy`` from the saved
    fp32 stats: dx in x's dtype, dgamma and dbeta fp32 of shape (H,)."""
    xf = _acc(x)
    dyf = dy.to(xf.dtype)
    xhat = (xf - mean[:, None]) * rstd[:, None]
    dg = (dyf * xhat).sum(0)
    db = dyf.sum(0)
    wdy = dyf * gamma.to(xf.dtype)
    c1 = wdy.mean(-1, keepdim=True)
    c2 = (wdy * xhat).mean(-1, keepdim=True)
    dx = (rstd[:, None] * (wdy - c1 - xhat * c2)).to(x.dtype)
    return dx, dg, db


def _check_bwd_args(x: torch.Tensor, gamma: torch.Tensor,
                    mean: Optional[torch.Tensor], rstd: torch.Tensor,
                    dy: torch.Tensor,
                    what: str = "layer_norm_bwd_cuda") -> None:
    """dy like x, the stats fp32 (N,), all on x's device and contiguous;
    then the forward's checks on x and gamma, the device last.  RMSNorm
    has no ``mean`` (None)."""
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must match x ({x.dtype} {tuple(x.shape)}), "
                         f"got {dy.dtype} {tuple(dy.shape)}")
    stats = (() if mean is None else (("mean", mean),)) + (("rstd", rstd),)
    for sname, st in stats:
        if x.dim() != 2 or tuple(st.shape) != (x.shape[0],) \
                or st.dtype != torch.float32:
            raise ValueError(f"{sname} must be float32 of shape "
                             f"(N,) for N = x.shape[0], got {st.dtype} "
                             f"{tuple(st.shape)}")
    for tname, t in (("dy", dy),) + stats:
        if t.device != x.device:
            raise ValueError(f"{tname} lies on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors; {tname} is "
                             f"not")
    _check_args(x, gamma, None, what)


def bwd_groups(n: int) -> int:
    """Wide rows: how many blocks the rows are dealt to (block g takes rows
    g, g + blocks, ...): one per ``BWD_ROWS_PER_GROUP`` rows, at most
    ``BWD_MAX_GROUPS``."""
    return max(1, min(-(-n // BWD_ROWS_PER_GROUP), BWD_MAX_GROUPS))


class BwdGeometry(NamedTuple):
    """The backward's launch: ``layout`` (BWD_WIDE or BWD_PERSIST),
    ``blocks`` (each writes one row of per-block partials)
    and ``tree_rows`` (the persistent grid's second-level partials, after
    the blocks' rows in the workspace)."""
    layout: int
    blocks: int
    tree_rows: int


def bwd_geometry(n: int, h: int, sms: int, resident: int) -> BwdGeometry:
    """How the backward takes ``n`` rows of ``h`` elements on a card of
    ``sms`` SMs that holds ``resident`` blocks of the persistent kernel
    each.  Rows over ``BWD_WARP_H`` elements: blocks of 512 threads, a
    row each up to ``BWD_FEW_ROWS`` rows, else ``bwd_groups``, and a
    column pass.  Shorter rows: the persistent grid, every block resident
    at once (``sms * resident`` at most), no more blocks than give each
    warp a row (few rows: a warp a row); warp w of W takes rows
    [w n / W, (w + 1) n / W)."""
    if h > BWD_WARP_H:
        return BwdGeometry(BWD_WIDE,
                           n if n <= BWD_FEW_ROWS else bwd_groups(n), 0)
    blocks = max(1, min(sms * resident, -(-n // BWD_WARPS)))
    return BwdGeometry(BWD_PERSIST, blocks, -(-blocks // BWD_TREE_GROUP))


def _pack_width(h: int, tensors, params=()) -> int:
    """The widest power of two up to 16 bytes of elements that divides
    ``h`` with every tensor aligned to its packs and every fp32 parameter
    to packs of up to four floats (csrc/layer_norm.cu ``vec_width``, the
    forward's rule)."""
    esize = tensors[0].element_size()
    v = 16 // esize
    while v > 1:
        if (h % v == 0
                and all(t.data_ptr() % (v * esize) == 0 for t in tensors)
                and all(p.data_ptr() % (4 * min(v, 4)) == 0
                        for p in params)):
            return v
        v //= 2
    return 1


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(lib: ctypes.CDLL, device: torch.device, kmean: int,
                   dtype: int, vec: int, h: int) -> Tuple[int, int]:
    """``(sms, resident)``: the SMs of ``device`` and how many blocks of
    the persistent backward for these arguments one SM holds."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.apex_norm_bwd_resident(kmean, dtype, vec, h,
                                        ctypes.byref(blocks))
    _build.raise_on(rc, lib, "norm backward occupancy", _ARG_ERRORS)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms, max(1, blocks.value)


def _launch_bwd(what: str, entry: str, kmean: bool, x: torch.Tensor,
                dy: torch.Tensor, gamma: torch.Tensor, dx: torch.Tensor,
                ptrs, outs) -> None:
    """Picks the layout, the grid and the pack width, then launches
    ``entry`` with ``ptrs`` (inputs, dx, then ``outs``, the fp32 sums) and
    a fresh workspace, on PyTorch's current stream."""
    n, h = x.shape
    lib = _library()
    dtype = _build.DTYPE_CODES[x.dtype]
    if h > BWD_WARP_H:
        geo = bwd_geometry(n, h, 1, 1)
        # wide rows take 16-byte packs or single elements, and gamma
        # element by element
        vec = _pack_width(h, (x, dy, dx))
        if vec * x.element_size() != 16:
            vec = 1
    else:
        vec = _pack_width(h, (x, dy, dx), (gamma,))
        geo = bwd_geometry(n, h, *_blocks_per_sm(lib, x.device, int(kmean),
                                                 dtype, vec, h))
    planes = 2 if kmean else 1
    ws = torch.empty(planes * (geo.blocks + geo.tree_rows) * h,
                     dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        tickets = _build.tickets(x.device, stream, 1 + geo.tree_rows)
        rc = getattr(lib, entry)(
            *ptrs, *(o.data_ptr() for o in outs), ws.data_ptr(),
            tickets.data_ptr(), n, h, geo.blocks, geo.tree_rows, geo.layout,
            vec, dtype, stream)
    _build.raise_on(rc, lib, what, _ARG_ERRORS)


def layer_norm_bwd_cuda(x: torch.Tensor, gamma: torch.Tensor,
                        mean: torch.Tensor, rstd: torch.Tensor,
                        dy: torch.Tensor) -> Grads:
    """``(dx, dgamma, dbeta)`` like :func:`layer_norm_bwd_plain`, computed
    by the CUDA kernel on PyTorch's current stream.
    ``layer_norm_bwd_cuda.launches`` counts the calls that launched it."""
    _check_bwd_args(x, gamma, mean, rstd, dy)
    n, h = x.shape
    dx = torch.empty_like(x)
    dg = torch.empty(h, dtype=torch.float32, device=x.device)
    db = torch.empty(h, dtype=torch.float32, device=x.device)
    if n == 0:
        return dx, dg.zero_(), db.zero_()
    _launch_bwd("layer_norm backward", "apex_layer_norm_bwd", True, x, dy,
                gamma, dx, (x.data_ptr(), dy.data_ptr(), gamma.data_ptr(),
                            mean.data_ptr(), rstd.data_ptr(), dx.data_ptr()),
                (dg, db))
    layer_norm_bwd_cuda.launches += 1
    return dx, dg, db


layer_norm_bwd_cuda.launches = 0


def layer_norm_bwd(x: torch.Tensor, gamma: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor, dy: torch.Tensor) -> Grads:
    """The backward of :func:`layer_norm_fwd` (``_layer_norm_bwd_vjp``
    :240): dx shaped like x, dgamma and dbeta cast to gamma's dtype."""
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    dy2d = dy.reshape(-1, shape[-1])
    if x2d.device.type == "cpu":
        dx, dg, db = layer_norm_bwd_plain(x2d, gamma, mean, rstd, dy2d)
    else:
        dx, dg, db = layer_norm_bwd_cuda(x2d, gamma.float(), mean, rstd,
                                         dy2d.contiguous())
    return dx.reshape(shape), dg.to(gamma.dtype), db.to(gamma.dtype)


class LayerNormFunction(torch.autograd.Function):
    """LayerNorm with its backward kernel: the JAX ``custom_vjp``
    (:211-268).  Saves ``(x, gamma, mean, rstd)``; x_hat is recomputed in
    the backward, never stored."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, mean, rstd = layer_norm_fwd(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mean, rstd = ctx.saved_tensors
        dx, dg, db = layer_norm_bwd(x, gamma, mean, rstd, dy)
        return dx, dg, db, None


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Fused LayerNorm over the last axis; x (..., H), gamma/beta (H,).
    Differentiable in x, gamma and beta through :class:`LayerNormFunction`."""
    return LayerNormFunction.apply(x, gamma, beta, eps)


RmsStats = Tuple[torch.Tensor, torch.Tensor]


def rms_norm_plain(x: torch.Tensor, gamma: torch.Tensor,
                   eps: float = 1e-5) -> RmsStats:
    """``(y, rstd)`` over the last axis of a 2-D ``x``:
    ``rstd = rsqrt(mean(x²) + eps)`` in fp32, ``y = x · rstd · gamma`` in
    x's dtype, rstd fp32 of shape (N,)."""
    xf = _acc(x)
    rstd = torch.rsqrt((xf * xf).mean(-1) + eps)
    y = xf * rstd[:, None] * gamma.to(xf.dtype)
    return y.to(x.dtype), rstd


def rms_norm_cuda(x: torch.Tensor, gamma: torch.Tensor,
                  eps: float = 1e-5) -> RmsStats:
    """``(y, rstd)`` like :func:`rms_norm_plain`, computed by the CUDA
    kernel on PyTorch's current stream.  ``rms_norm_cuda.launches`` counts
    the kernel's launches."""
    _check_args(x, gamma, None, "rms_norm_cuda")
    n, h = x.shape
    y = torch.empty_like(x)
    rstd = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return y, rstd
    lib = _library()
    with torch.cuda.device(x.device):
        rc = lib.apex_rms_norm_fwd(
            x.data_ptr(), gamma.data_ptr(), y.data_ptr(), rstd.data_ptr(),
            n, h, float(eps), _build.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, lib, "rms_norm", _ARG_ERRORS)
    rms_norm_cuda.launches += 1
    return y, rstd


rms_norm_cuda.launches = 0


def rms_norm_fwd(x: torch.Tensor, gamma: torch.Tensor,
                 eps: float = 1e-5) -> RmsStats:
    """RMSNorm over the last axis of ``x`` (..., H): ``(y, rstd)`` with y
    shaped like x and the fp32 rstd flattened to (N,), as
    ``_rms_norm_fwd`` (:304) returns them."""
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    if x2d.device.type == "cpu":
        y, rstd = rms_norm_plain(x2d, gamma, eps)
    else:
        y, rstd = rms_norm_cuda(x2d, gamma.float(), eps)
    return y.reshape(shape), rstd


RmsGrads = Tuple[torch.Tensor, torch.Tensor]


def rms_norm_bwd_plain(x: torch.Tensor, gamma: torch.Tensor,
                       rstd: torch.Tensor, dy: torch.Tensor) -> RmsGrads:
    """``(dx, dgamma)`` for a 2-D ``x`` and ``dy`` from the saved fp32
    rstd: dx in x's dtype, dgamma fp32 of shape (H,)."""
    xf = _acc(x)
    dyf = dy.to(xf.dtype)
    xhat = xf * rstd[:, None]
    wdy = dyf * gamma.to(xf.dtype)
    dg = (dyf * xhat).sum(0)
    c2 = (wdy * xhat).mean(-1, keepdim=True)
    dx = (rstd[:, None] * (wdy - xhat * c2)).to(x.dtype)
    return dx, dg


def rms_norm_bwd_cuda(x: torch.Tensor, gamma: torch.Tensor,
                      rstd: torch.Tensor, dy: torch.Tensor) -> RmsGrads:
    """``(dx, dgamma)`` like :func:`rms_norm_bwd_plain`, computed by the
    CUDA kernel on PyTorch's current stream.
    ``rms_norm_bwd_cuda.launches`` counts the calls that launched it."""
    _check_bwd_args(x, gamma, None, rstd, dy, "rms_norm_bwd_cuda")
    n, h = x.shape
    dx = torch.empty_like(x)
    dg = torch.empty(h, dtype=torch.float32, device=x.device)
    if n == 0:
        return dx, dg.zero_()
    _launch_bwd("rms_norm backward", "apex_rms_norm_bwd", False, x, dy,
                gamma, dx, (x.data_ptr(), dy.data_ptr(), gamma.data_ptr(),
                            rstd.data_ptr(), dx.data_ptr()), (dg,))
    rms_norm_bwd_cuda.launches += 1
    return dx, dg


rms_norm_bwd_cuda.launches = 0


def rms_norm_bwd(x: torch.Tensor, gamma: torch.Tensor, rstd: torch.Tensor,
                 dy: torch.Tensor) -> RmsGrads:
    """The backward of :func:`rms_norm_fwd` (``_rms_norm_bwd_vjp`` :322):
    dx shaped like x, dgamma cast to gamma's dtype."""
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    dy2d = dy.reshape(-1, shape[-1])
    if x2d.device.type == "cpu":
        dx, dg = rms_norm_bwd_plain(x2d, gamma, rstd, dy2d)
    else:
        dx, dg = rms_norm_bwd_cuda(x2d, gamma.float(), rstd,
                                   dy2d.contiguous())
    return dx.reshape(shape), dg.to(gamma.dtype)


class RMSNormFunction(torch.autograd.Function):
    """RMSNorm with its backward kernel: the JAX ``custom_vjp``
    (:297-343).  Saves ``(x, gamma, rstd)``; x_hat is recomputed in the
    backward, never stored."""

    @staticmethod
    def forward(ctx, x, gamma, eps):
        y, rstd = rms_norm_fwd(x, gamma, eps)
        ctx.save_for_backward(x, gamma, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, rstd = ctx.saved_tensors
        dx, dg = rms_norm_bwd(x, gamma, rstd, dy)
        return dx, dg, None


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """Fused RMSNorm over the last axis; x (..., H), gamma (H,).
    Differentiable in x and gamma through :class:`RMSNormFunction`."""
    return RMSNormFunction.apply(x, gamma, eps)
