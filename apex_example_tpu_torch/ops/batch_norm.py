"""Training-mode BatchNorm: the hand-written Hopper statistics and
backward-sum kernels, their plain versions, and the autograd function
around them.

Port of apex_example_tpu/ops/batch_norm.py.  ``bn_stats_plain`` is the
arithmetic of ``bn_stats`` (:103, the Pallas ``_stats_kernel`` :74): per
channel of a (rows, C) view, ``(sum(x - c), sum((x - c)^2))`` in fp32.
``bn_bwd_sums_plain`` is that of ``bn_bwd_sums`` (:128, ``_bwd_sums_kernel``
:88): ``(sum(dy), sum(dy * x_hat))`` with ``x_hat = (x - mean) * inv``.
``bn_stats_cuda`` and ``bn_bwd_sums_cuda`` launch csrc/batch_norm.cu (its
source note states the bound and the design): any row count and any C,
where the Pallas kernels need the rows to tile by 8 (:55-67).

``bn_stats`` / ``bn_bwd_sums`` choose by where the tensor lies: a CPU
tensor takes the plain version, a CUDA tensor the kernel, and the kernel's
wrapper raises on anything it cannot take.  Nothing falls back.

``BatchNormFunction`` is the JAX ``custom_vjp`` ``batch_norm_train``
(:188-246): the forward is the statistics kernel, then the elementwise
apply in plain torch (the JAX package leaves it to XLA); it saves only
``(x, scale, mean, inv)`` and the row count, and its backward is the sums
kernel, then the dx formula.  It returns ``(y, mean, var)``; mean and var
feed the running statistics only, and their cotangents are ignored.

Across processes (``axis_name``, parallel/mesh.py) the forward sums the
kernel's ``(s, ss)`` over the group and counts ``n`` times the world size
before the mean and variance (:171-175), and the backward sums ``(sdy,
sdyx)`` over the group before dx (:229-231): each process's dx is then the
full batch's.  dscale and dbias are this process's own ``sdyx`` and
``sdy``: the data-parallel step averages every grad over the processes
afterwards, which makes them the full batch's.  (The JAX function returns
the summed ones, and its shard_map step divides those by the world size
without summing them again: the same result.)
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from apex_example_tpu_torch.ops import _build

THREADS = 256            # threads per block (kThreads)
_ARG_ERRORS = {-1: "unsupported dtype or mode", -2: "bad launch geometry"}

Sums = Tuple[torch.Tensor, torch.Tensor]


def bn_stats_plain(x2: torch.Tensor, c: torch.Tensor) -> Sums:
    """``(sum(x - c), sum((x - c)^2))`` over the rows of a (rows, C) ``x2``,
    fp32 (C,) each."""
    xc = x2.float() - c
    return xc.sum(0), (xc * xc).sum(0)


def bn_bwd_sums_plain(x2: torch.Tensor, dy2: torch.Tensor,
                      mean: torch.Tensor, inv: torch.Tensor) -> Sums:
    """``(sum(dy), sum(dy * (x - mean) * inv))`` over the rows, fp32
    (C,) each."""
    xhat = (x2.float() - mean) * inv
    dyf = dy2.float()
    return dyf.sum(0), (dyf * xhat).sum(0)


def _pow2_at_most_32(n: int) -> int:
    return min(32, 1 << max(n - 1, 0).bit_length())


def geometry(rows: int, C: int, vec: int, sms: int,
             resident: int) -> Tuple[int, int]:
    """``(tx, n_rb)``: channel groups per block row and row blocks.  The
    grid holds ``sms * resident`` blocks (``resident``: the kernel's
    blocks on one SM), dealt over the channel slabs, so every block is
    resident at once; never more row blocks than block rows, so that each
    row block's share (csrc/batch_norm.cu ``share``) holds one at least."""
    tx = _pow2_at_most_32(-(-C // vec))
    slabs = -(-C // (tx * vec))
    n_rb = max(1, min(sms * resident // slabs, -(-rows // (THREADS // tx)),
                      65535))
    return tx, n_rb


def _vec(C: int, *tensors: torch.Tensor) -> int:
    """4 channels a thread where C is a multiple of 4 and every row starts
    on a 4-element boundary, else 1."""
    if C % 4:
        return 1
    return 4 if all(t.data_ptr() % (4 * t.element_size()) == 0
                    for t in tensors) else 1


def _check(who: str, x2: torch.Tensor, vecs, others=()) -> None:
    """What the kernels take: contiguous (rows, C) of a float dtype, fp32
    (C,) vectors and tensors like x on x's device; raises before anything
    is built, the device last."""
    if x2.dim() != 2:
        raise ValueError(f"{who} takes a (rows, C) view, got shape "
                         f"{tuple(x2.shape)}")
    if x2.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{who} takes float32, bfloat16 or float16 x, got "
                        f"{x2.dtype}")
    C = x2.shape[1]
    for name, v in vecs:
        if v.dtype != torch.float32 or tuple(v.shape) != (C,):
            raise ValueError(f"{name} must be float32 of shape ({C},), got "
                             f"{v.dtype} {tuple(v.shape)}")
    for name, t in others:
        if t.shape != x2.shape or t.dtype != x2.dtype:
            raise ValueError(f"{name} must match x ({x2.dtype} "
                             f"{tuple(x2.shape)}), got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in [("x", x2)] + list(vecs) + list(others):
        if t.device != x2.device:
            raise ValueError(f"{name} lies on {t.device}, x on {x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"{who} takes contiguous tensors; {name} is "
                             f"not")
    if x2.device.type != "cuda":
        raise ValueError(f"{who} launches a CUDA kernel; x lies on "
                         f"{x2.device}")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("batch_norm")
    geo = [ctypes.c_int] * 5       # C, dtype, vec, tx_n, n_rb
    lib.apex_bn_stats.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_longlong] + geo + [ctypes.c_void_p] * 4
    lib.apex_bn_stats.restype = ctypes.c_int
    lib.apex_bn_bwd_sums.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong] + geo + [ctypes.c_void_p] * 4
    lib.apex_bn_bwd_sums.restype = ctypes.c_int
    lib.apex_bn_resident.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.apex_bn_resident.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(lib: ctypes.CDLL, device: torch.device, mode: int,
                   dtype: int, vec: int) -> Tuple[int, int]:
    """``(sms, resident)``: the SMs of ``device`` and how many blocks of the
    kernel that ``lib`` launches for these arguments one SM holds (mode 0
    the statistics, 1 the backward sums)."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.apex_bn_resident(mode, dtype, vec, ctypes.byref(blocks))
    _build.raise_on(rc, lib, "batch_norm occupancy", _ARG_ERRORS)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms, max(1, blocks.value)


def _launch(who: str, entry: str, mode: int, ptrs, x2: torch.Tensor,
            vec: int) -> Sums:
    rows, C = x2.shape
    dtype = _build.DTYPE_CODES[x2.dtype]
    lib = _library()
    tx, n_rb = geometry(rows, C, vec,
                        *_blocks_per_sm(lib, x2.device, mode, dtype, vec))
    out = torch.empty(2, C, dtype=torch.float32, device=x2.device)
    partial = torch.empty(n_rb * 2 * C, dtype=torch.float32,
                          device=x2.device)
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream().cuda_stream
        tickets = _build.tickets(x2.device, stream, -(-C // (tx * vec)))
        rc = getattr(lib, entry)(
            *ptrs, rows, C, dtype, vec, tx, n_rb, partial.data_ptr(),
            out.data_ptr(), tickets.data_ptr(), stream)
    _build.raise_on(rc, lib, who, _ARG_ERRORS)
    return out[0], out[1]


def bn_stats_cuda(x2: torch.Tensor, c: torch.Tensor) -> Sums:
    """:func:`bn_stats_plain` by the CUDA kernel on PyTorch's current
    stream.  ``bn_stats_cuda.launches`` counts the calls that launched
    it."""
    _check("bn_stats_cuda", x2, [("c", c)])
    if x2.shape[0] == 0:
        z = torch.zeros(x2.shape[1], dtype=torch.float32, device=x2.device)
        return z, z.clone()
    sums = _launch("bn_stats", "apex_bn_stats", 0,
                   (x2.data_ptr(), c.data_ptr()), x2, _vec(x2.shape[1], x2))
    bn_stats_cuda.launches += 1
    return sums


bn_stats_cuda.launches = 0


def bn_bwd_sums_cuda(x2: torch.Tensor, dy2: torch.Tensor, mean: torch.Tensor,
                     inv: torch.Tensor) -> Sums:
    """:func:`bn_bwd_sums_plain` by the CUDA kernel on PyTorch's current
    stream.  ``bn_bwd_sums_cuda.launches`` counts the calls that launched
    it."""
    _check("bn_bwd_sums_cuda", x2, [("mean", mean), ("inv", inv)],
           [("dy", dy2)])
    if x2.shape[0] == 0:
        z = torch.zeros(x2.shape[1], dtype=torch.float32, device=x2.device)
        return z, z.clone()
    sums = _launch("bn_bwd_sums", "apex_bn_bwd_sums", 1,
                   (x2.data_ptr(), dy2.data_ptr(), mean.data_ptr(),
                    inv.data_ptr()), x2, _vec(x2.shape[1], x2, dy2))
    bn_bwd_sums_cuda.launches += 1
    return sums


bn_bwd_sums_cuda.launches = 0


def bn_stats(x2: torch.Tensor, c: torch.Tensor) -> Sums:
    """The statistics of a (rows, C) view: the plain version for a CPU
    tensor, the kernel otherwise."""
    if x2.device.type == "cpu":
        return bn_stats_plain(x2, c)
    return bn_stats_cuda(x2, c)


def bn_bwd_sums(x2: torch.Tensor, dy2: torch.Tensor, mean: torch.Tensor,
                inv: torch.Tensor) -> Sums:
    """The backward sums of (rows, C) views: the plain version for CPU
    tensors, the kernel otherwise."""
    if x2.device.type == "cpu":
        return bn_bwd_sums_plain(x2, dy2, mean, inv)
    return bn_bwd_sums_cuda(x2, dy2.contiguous(), mean, inv)


class BatchNormFunction(torch.autograd.Function):
    """Training-mode BatchNorm over the last axis of ``x`` (..., C):
    ``(y, mean, var)`` (:166-246).  ``c`` is the centring constant of the
    one-pass moments (the running mean); ``apply_dtype`` that of the
    elementwise apply and dx (``keep_batchnorm_fp32``); y in
    ``out_dtype``; ``axis_name`` None, or the group whose processes'
    rows the statistics cover (see the module docstring).  mean and var
    (fp32, biased) are not differentiable."""

    @staticmethod
    def forward(ctx, x, scale, bias, c, eps, apply_dtype, out_dtype,
                axis_name=None):
        C = x.shape[-1]
        rows = x.numel() // C
        s, ss = bn_stats(x.reshape(rows, C), c)
        n = float(rows)
        if axis_name is not None:
            from apex_example_tpu_torch.parallel.mesh import axis_size
            s, ss = _sum_over(axis_name, s, ss)
            n *= axis_size(axis_name)
        mean_c = s / n
        # Var[x] = E[(x-c)^2] - (E[x-c])^2, exact for any constant shift c.
        var = torch.clamp(ss / n - mean_c * mean_c, min=0.0)
        mean = c + mean_c
        inv = torch.rsqrt(var + eps)
        md = apply_dtype
        y = ((x.to(md) - mean.to(md)) * (inv * scale).to(md)
             + bias.to(md)).to(out_dtype)
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.n, ctx.md, ctx.axis_name = n, md, axis_name
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, inv = ctx.saved_tensors
        C = x.shape[-1]
        rows = x.numel() // C
        local = bn_bwd_sums(x.reshape(rows, C), dy.reshape(rows, C),
                            mean, inv)
        sdy, sdyx = local
        if ctx.axis_name is not None:
            sdy, sdyx = _sum_over(ctx.axis_name, sdy, sdyx)
        # dx = scale * inv * (dy - sum(dy)/n - x_hat * sum(dy x_hat)/n)
        md, n = ctx.md, ctx.n
        g = (scale * inv).to(md)
        mdy = (sdy / n).to(md)
        mdyx = (sdyx / n).to(md)
        xhat = (x.to(md) - mean.to(md)) * inv.to(md)
        dx = (g * (dy.to(md) - mdy - xhat * mdyx)).to(x.dtype)
        # this process's sums: the step's average over the processes
        return dx, local[1], local[0], None, None, None, None, None


def _sum_over(axis_name, a: torch.Tensor, b: torch.Tensor) -> Sums:
    """``(psum(a), psum(b))`` over ``axis_name``'s group, in one
    all-reduce."""
    # (parallel/ imports this module: the group is looked up here)
    from apex_example_tpu_torch.parallel.mesh import group_of
    both = torch.stack([a, b])
    torch.distributed.all_reduce(both, group=group_of(axis_name))
    return both[0], both[1]


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, c: torch.Tensor, eps: float,
                     apply_dtype: torch.dtype, out_dtype: torch.dtype,
                     axis_name=None):
    """``(y, mean, var)`` of training-mode BatchNorm through
    :class:`BatchNormFunction`: differentiable in x, scale and bias;
    ``axis_name`` the group the statistics cross, or None."""
    return BatchNormFunction.apply(x, scale, bias, c, eps, apply_dtype,
                                   out_dtype, axis_name)
