"""Multi-tensor L2 norm, scale and global-norm clip: the hand-written
Hopper kernels and their plain versions.

Port of apex_example_tpu/ops/multi_tensor.py.  ``sqsum_plain`` is the
arithmetic of ``_sqsum_leaf`` (:235, the Pallas ``_sqsum_kernel`` :203) in
plain torch, and ``multi_tensor_l2norm_plain`` that of
``multi_tensor_l2norm`` (:248): ``sqrt`` of the sum of the per-tensor sums
of squares.  ``multi_tensor_scale_plain`` is ``multi_tensor_scale`` (:125,
the Pallas ``_scale_kernel`` :79): ``y = (x.float() * s).to(x.dtype)`` and
a flag that no INPUT element is inf or nan, whatever the scale.
``clip_grad_norm_plain`` is ``clip_grad_norm`` (:265): the global norm,
then every grad scaled by ``min(1, max_norm / (norm + eps))`` in fp32.
``multi_tensor_axpby_plain`` is ``multi_tensor_axpby`` (:188, the Pallas
``_axpby_kernel`` :151): ``a x + b y`` in fp32, in y's dtype, for any pair
of float dtypes.

``multi_tensor_l2norm_cuda`` and ``multi_tensor_scale_cuda`` launch
csrc/multi_tensor.cu over a whole :class:`TensorTable` in one call each,
where the JAX package launches one kernel per leaf: from Python one call
costs tens of microseconds, and an optimizer step over 241 tensors would
pay it hundreds of times.  ``clip_grad_norm_cuda`` is the two of them over
one table: the scale kernel reads the norm on the card, so nothing between
them waits for the host.  ``multi_tensor_axpby_cuda`` launches the axpby
kernel over a table of (x, y, out) in one call, and ``multi_tensor_axpby``
is the public op: new tensors from the plain version for CPU tensors, from
the kernel (over a table built for the call) for CUDA tensors.

``TensorTable`` is the device-side chunk table of
csrc/multi_tensor_apply.cuh, built on the host once for lists of tensors
whose storage stays put (an optimizer's params, grads and moments); it is
rebuilt only when an address changes.

Which one runs is the caller's choice by device (optim/fused.py): CPU
tensors take the plain version, CUDA tensors the kernel, and the kernel's
wrapper raises on anything it cannot take.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_example_tpu_torch.ops import _build

CHUNK = 65536           # elements per chunk (mta::kChunk)
ARG_ERRORS = {-1: "unsupported dtype", -2: "bad table"}


def chunk_table(numels: Sequence[int], chunk: int = CHUNK
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host arrays of the chunk table: ``offsets`` [T+1] (prefix sums of
    numel), ``chunk_tensor`` [C], ``chunk_start`` [C] (first element inside
    the tensor) and ``tensor_chunk0`` [T+1] (first chunk of each tensor),
    all int64.  Tensor t's chunks are ``tensor_chunk0[t]:tensor_chunk0[t+1]``
    and cover its elements once, in order."""
    numels = np.asarray(numels, np.int64)
    per = -(-numels // chunk)
    offsets = np.concatenate([[0], np.cumsum(numels)]).astype(np.int64)
    tensor_chunk0 = np.concatenate([[0], np.cumsum(per)]).astype(np.int64)
    chunk_tensor = np.repeat(np.arange(len(numels), dtype=np.int64), per)
    chunk_start = (np.arange(int(tensor_chunk0[-1]), dtype=np.int64)
                   - np.repeat(tensor_chunk0[:-1], per)) * chunk
    return offsets, chunk_tensor, chunk_start, tensor_chunk0


class TensorTable:
    """Lists of tensors (each list T long, tensor t of every list with the
    same number of elements, the tensors of one list of one dtype) and their
    chunk table in one int64 device buffer: the addresses of every list,
    then the four arrays of :func:`chunk_table`."""

    def __init__(self, lists: Sequence[Sequence[torch.Tensor]]):
        self.lists = [list(lst) for lst in lists]
        if not self.lists or not self.lists[0]:
            raise ValueError("TensorTable needs at least one tensor")
        n = len(self.lists[0])
        first = self.lists[0][0]
        for lst in self.lists:
            if len(lst) != n:
                raise ValueError(f"every list must hold {n} tensors, one "
                                 f"holds {len(lst)}")
            if len({t.dtype for t in lst}) != 1:
                raise TypeError("the tensors of one list must share a "
                                "dtype")
            for t, ref in zip(lst, self.lists[0]):
                if t.numel() != ref.numel():
                    raise ValueError("tensor t of every list must have the "
                                     "same number of elements")
                if t.device != first.device:
                    raise ValueError(f"a tensor lies on {t.device}, another "
                                     f"on {first.device}")
                if not t.is_contiguous():
                    raise ValueError("TensorTable takes contiguous tensors")
        self.n_tensors = n
        self.device = first.device
        (self.offsets, chunk_tensor, chunk_start,
         self.tensor_chunk0) = chunk_table([t.numel() for t in self.lists[0]])
        self.n_chunks = len(chunk_tensor)
        self.total = int(self.offsets[-1])
        self._tail = np.concatenate([self.offsets, chunk_tensor, chunk_start,
                                     self.tensor_chunk0])
        self._ptrs: List[int] = []
        self.buffer: Optional[torch.Tensor] = None
        self.refresh()

    def refresh(self) -> None:
        """Rebuild the device buffer if any tensor's storage moved.  (The
        old buffer may still be read by queued kernels: PyTorch's caching
        allocator hands it out again only in stream order.)"""
        ptrs = [t.data_ptr() for lst in self.lists for t in lst]
        if ptrs == self._ptrs:
            return
        host = np.concatenate([np.asarray(ptrs, np.uint64).view(np.int64),
                               self._tail])
        self.buffer = torch.from_numpy(host).to(self.device)
        self._ptrs = ptrs

    def dtype(self, index: int) -> torch.dtype:
        return self.lists[index][0].dtype

    def args(self) -> list:
        """The five table pointers of the C interface (the addresses of
        every list, then the four arrays), then n_tensors and n_chunks."""
        base = self.buffer.data_ptr()
        n = self.n_tensors
        at = len(self.lists) * n
        starts = (0, at, at + n + 1, at + n + 1 + self.n_chunks,
                  at + n + 1 + 2 * self.n_chunks)
        return [base + 8 * s for s in starts] + [n, self.n_chunks]


def sqsum_plain(x: torch.Tensor) -> torch.Tensor:
    """fp32 sum of squares of one tensor (0-d)."""
    xf = x.float()
    return (xf * xf).sum()


def multi_tensor_l2norm_plain(tensors: Sequence[torch.Tensor]
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(norm, sq)``: the global L2 norm (0-d fp32) and the per-tensor
    sums of squares (fp32 [T])."""
    sq = torch.stack([sqsum_plain(t) for t in tensors])
    return torch.sqrt(sq.sum()), sq


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("multi_tensor")
    lib.apex_multi_tensor_sqsum.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
    lib.apex_multi_tensor_sqsum.restype = ctypes.c_int
    lib.apex_multi_tensor_scale.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_float,
                             ctypes.c_float, ctypes.c_int,
                             ctypes.c_void_p, ctypes.c_void_p]
    lib.apex_multi_tensor_scale.restype = ctypes.c_int
    lib.apex_multi_tensor_axpby.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    lib.apex_multi_tensor_axpby.restype = ctypes.c_int
    return lib


def check_table(table: TensorTable, index: int, who: str) -> None:
    """What every tensor-list kernel needs of its table: CUDA tensors of a
    dtype the kernels take.  Raises before anything is built."""
    if table.dtype(index) not in _build.DTYPE_CODES:
        raise TypeError(f"{who} takes float32, bfloat16 or float16 "
                        f"tensors, got {table.dtype(index)}")
    if table.device.type != "cuda":
        raise ValueError(f"{who} launches a CUDA kernel; the tensors lie on "
                         f"{table.device}")


def multi_tensor_l2norm_cuda(table: TensorTable, index: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(norm, sq)`` like :func:`multi_tensor_l2norm_plain` over list
    ``index`` of ``table``, in one call of the CUDA kernel on PyTorch's
    current stream.  ``multi_tensor_l2norm_cuda.launches`` counts them."""
    check_table(table, index, "multi_tensor_l2norm_cuda")
    table.refresh()
    dev = table.device
    partial = torch.empty(max(table.n_chunks, 1), dtype=torch.float32,
                          device=dev)
    sq = torch.empty(table.n_tensors, dtype=torch.float32, device=dev)
    norm = torch.empty((), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.apex_multi_tensor_sqsum(
            *table.args(), index, _build.DTYPE_CODES[table.dtype(index)],
            partial.data_ptr(), sq.data_ptr(), norm.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, lib, "multi_tensor_l2norm", ARG_ERRORS)
    multi_tensor_l2norm_cuda.launches += 1
    return norm, sq


multi_tensor_l2norm_cuda.launches = 0


def multi_tensor_scale_plain(tensors: Sequence[torch.Tensor], scale,
                             flag_output: bool = False
                             ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``(outs, all_finite)``: each tensor times ``scale`` (a float or a
    0-d tensor) in fp32, returned in its own dtype, and a 0-d bool that is
    True when no input element (``flag_output``: no output element) is inf
    or nan."""
    s = torch.as_tensor(scale, dtype=torch.float32)
    outs = [(t.float() * s).to(t.dtype) for t in tensors]
    if not tensors:
        return outs, torch.tensor(True)
    checked = outs if flag_output else tensors
    return outs, torch.stack([torch.isfinite(t).all() for t in checked]).all()


def clip_scale_plain(norm: torch.Tensor, max_norm: float,
                     eps: float = 1e-6) -> torch.Tensor:
    """``min(1, max_norm / (norm + eps))`` in fp32 (0-d), NaN propagating
    as in ``jnp.minimum``."""
    ratio = torch.full_like(norm, max_norm) / (norm + eps)
    return torch.minimum(ratio, torch.ones_like(ratio))


def clip_grad_norm_plain(grads: Sequence[torch.Tensor], max_norm: float,
                         eps: float = 1e-6) -> torch.Tensor:
    """Clip ``grads`` in place to the global norm ``max_norm``; returns the
    norm before the clip (0-d fp32)."""
    total, _ = multi_tensor_l2norm_plain(grads)
    outs, _ = multi_tensor_scale_plain(grads,
                                       clip_scale_plain(total, max_norm, eps))
    with torch.no_grad():
        for g, out in zip(grads, outs):
            g.copy_(out)
    return total


def multi_tensor_scale_cuda(table: TensorTable, in_index: int,
                            out_index: int, scale: Optional[float] = None,
                            *, scale_t: Optional[torch.Tensor] = None,
                            norm: Optional[torch.Tensor] = None,
                            max_norm: float = 0.0, eps: float = 1e-6,
                            flag_output: bool = False) -> torch.Tensor:
    """List ``out_index`` of ``table`` = list ``in_index`` times s, in one
    call of the CUDA kernel (the same index: in place).  s is the host
    float ``scale``, or the 0-d device tensor ``scale_t`` read on the card,
    or, given the 0-d device tensor ``norm``, the clip scale
    ``min(1, max_norm / (norm + eps))`` that the kernel computes on the
    card.  Returns a 0-d int32 on the card: 1 when some input element
    (``flag_output``: some output element) is inf or nan, else 0.
    ``multi_tensor_scale_cuda.launches`` counts the calls."""
    who = "multi_tensor_scale_cuda"
    if sum(v is not None for v in (scale, scale_t, norm)) != 1:
        raise ValueError(f"{who} takes one of a host scale, a device scale "
                         f"and a device norm: not both or neither")
    if table.dtype(out_index) != table.dtype(in_index):
        raise TypeError(f"{who}: the in and out lists must share a dtype")
    for name, t in (("scale_t", scale_t), ("norm", norm)):
        if t is not None and (t.dtype != torch.float32 or t.numel() != 1
                              or t.device != table.device):
            raise ValueError(f"{name} must be one float32 on the tensors' "
                             f"device")
    check_table(table, in_index, who)
    table.refresh()
    flag = torch.empty((), dtype=torch.int32, device=table.device)
    lib = _library()
    with torch.cuda.device(table.device):
        rc = lib.apex_multi_tensor_scale(
            *table.args(), in_index, out_index,
            _build.DTYPE_CODES[table.dtype(in_index)],
            0.0 if scale is None else float(scale),
            None if scale_t is None else scale_t.data_ptr(),
            None if norm is None else norm.data_ptr(), float(max_norm),
            float(eps), int(flag_output), flag.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, lib, "multi_tensor_scale", ARG_ERRORS)
    multi_tensor_scale_cuda.launches += 1
    return flag


multi_tensor_scale_cuda.launches = 0


def clip_grad_norm_cuda(table: TensorTable, max_norm: float,
                        index: int = 1, eps: float = 1e-6) -> torch.Tensor:
    """Clip list ``index`` of ``table`` in place to the global norm
    ``max_norm``: one L2-norm call, then one scale call that reads the norm
    on the card.  Returns the norm before the clip (0-d fp32, on the
    card)."""
    total, _ = multi_tensor_l2norm_cuda(table, index)
    multi_tensor_scale_cuda(table, index, index, norm=total,
                            max_norm=max_norm, eps=eps)
    return total


def multi_tensor_axpby_plain(a: float, xs: Sequence[torch.Tensor], b: float,
                             ys: Sequence[torch.Tensor]
                             ) -> List[torch.Tensor]:
    """``a x + b y`` for each pair, in fp32 with fp32 scalars, returned in
    y's dtype as new tensors."""
    a, b = float(np.float32(a)), float(np.float32(b))
    return [(a * x.float() + b * y.float()).to(y.dtype)
            for x, y in zip(xs, ys)]


def multi_tensor_axpby_cuda(table: TensorTable, a: float, b: float) -> None:
    """List 2 (out) of ``table`` = a * list 0 (x) + b * list 1 (y), in one
    call of the CUDA kernel: fp32 arithmetic, out in y's dtype, x of any
    float dtype.  ``multi_tensor_axpby_cuda.launches`` counts the calls."""
    who = "multi_tensor_axpby_cuda"
    if len(table.lists) != 3:
        raise ValueError(f"{who} takes a table of 3 lists (x, y, out), got "
                         f"{len(table.lists)}")
    if table.dtype(2) != table.dtype(1):
        raise TypeError(f"{who}: out must have y's dtype")
    check_table(table, 0, who)
    check_table(table, 1, who)
    table.refresh()
    lib = _library()
    with torch.cuda.device(table.device):
        rc = lib.apex_multi_tensor_axpby(
            *table.args(), _build.DTYPE_CODES[table.dtype(0)],
            _build.DTYPE_CODES[table.dtype(1)], float(a), float(b),
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, lib, "multi_tensor_axpby", ARG_ERRORS)
    multi_tensor_axpby_cuda.launches += 1


multi_tensor_axpby_cuda.launches = 0


def multi_tensor_axpby(a: float, xs: Sequence[torch.Tensor], b: float,
                       ys: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``[a x + b y]`` for the pairs of ``xs`` and ``ys`` (the JAX
    package's ``multi_tensor_axpby`` over lists), each in y's dtype: the
    plain version for CPU tensors, else one kernel launch."""
    xs, ys = list(xs), list(ys)
    if len(xs) != len(ys):
        raise ValueError(f"{len(xs)} x tensors against {len(ys)} y tensors")
    if not xs:
        return []
    if xs[0].device.type == "cpu":
        return multi_tensor_axpby_plain(a, xs, b, ys)
    outs = [torch.empty_like(y) for y in ys]
    multi_tensor_axpby_cuda(TensorTable([xs, ys, outs]), a, b)
    return outs
