"""LAMB stage 1 and stage 2, and Adam: the hand-written Hopper kernels and
their plain versions.

Port of the LAMB and Adam parts of apex_example_tpu/ops/fused_optim.py.
``lamb_stage1_plain`` is the arithmetic of ``lamb_stage1_leaf`` (:167,
plain branch :170-177; the Pallas ``_lamb1_kernel`` :137) and
``lamb_stage2_plain`` that of ``lamb_stage2_leaf`` (:225, ``_lamb2_kernel``
:219), one tensor at a time and returning new tensors, as in JAX.

``lamb_stage1_cuda`` and ``lamb_stage2_cuda`` launch csrc/fused_optim.cu
over a whole :class:`~apex_example_tpu_torch.ops.multi_tensor.TensorTable`
of four lists (p, g, m, v) in one call each, updating in place: m and v in
stage 1 (the JAX kernel aliases them, :207), p in stage 2 (:249).  Stage 1
also leaves the per-tensor trust ratios on the card for stage 2
(optim/fused.py:135-136), and takes the global-norm clip's scale from the
grad norm on the card, so nothing between the two stages waits for the
host.  u is fp32 whatever p's dtype (:203), in one flat buffer that the
caller allocates once.  The step's (lr, c1, c2) are a row on the card,
``scalars_t`` (stage 1 reads c1 and c2, stage 2 lr), and both stages skip
on apex's ``noop_flag``: every kernel returns before it writes.

``adam_update_plain`` is the arithmetic of the Pallas ``_adam_kernel``
(:53; ``adam_update_leaf_reference`` :117 with its scalars in fp32, as the
kernel receives them, :95-97).  ``adam_cuda`` launches csrc/fused_optim.cu
over a table of (p, g, m, v) in one call and updates p, m and v in place,
reading (lr, c1, c2) from the row ``scalars_t`` on the card and skipping on
the noop flag; the JAX package launches one kernel per leaf
(optim/fused.py:86-91).  The plain versions take their scalars as floats or
as 0-d fp32 tensors; a caller that skips a step masks their results
(optim/fused.py).

``sgd_update_plain`` is the arithmetic of the Pallas ``_sgd_kernel`` (:259;
``sgd_update_leaf`` :331 with its scalars in fp32, as the kernel receives
them, :352-353).  ``sgd_cuda`` launches csrc/fused_optim.cu over a table of
(p, g, buf) in one call and updates p and buf in place; it can read the
learning rate from the card and skip the whole step on apex's
``noop_flag``, an int32 on the card (the loss scaler's non-finite flag).

``novograd_moment_plain`` is NovoGrad's per-tensor scalar work
(apex_example_tpu/optim/fused.py:252-259): the second moment v, one fp32
per tensor, from the squared grad norm, and ``inv_denom``;
``novograd_update_plain`` is the arithmetic of the Pallas
``_novograd_kernel`` (:274; ``novograd_update_leaf`` :285).
``novograd_cuda`` launches csrc/fused_optim.cu over a table of (p, g, m):
a per-tensor kernel (v in place, inv_denom out), then the chunk kernel (p
and m in place), in one call; the step's scalars and its first-step
branch come from the card, and it skips on the noop flag.

``adagrad_update_plain`` is the arithmetic of the Pallas ``_adagrad_kernel``
(:380; ``adagrad_update_leaf_reference`` :432 with its scalars in fp32, as the
kernel receives them, :414-415).  ``adagrad_cuda`` launches csrc/fused_optim.cu
over a table of (p, g, h) in one call, p and h in place, with the learning
rate and the noop flag as ``sgd_cuda``'s.

Which one runs is the caller's choice by device (optim/fused.py): CPU
tensors take the plain versions, CUDA tensors the kernels, and the kernels'
wrappers raise on anything they cannot take.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from apex_example_tpu_torch.ops import _build
from apex_example_tpu_torch.ops.multi_tensor import (ARG_ERRORS,
                                                     TensorTable,
                                                     check_table)


def lamb_stage1_plain(p, g, m, v, *, beta1, beta2, eps, weight_decay,
                      bias_c1, bias_c2, grad_scale=1.0):
    """``(u, m', v', ||p||^2, ||u||^2)`` for one tensor, fp32 arithmetic;
    u fp32, m' and v' in m's and v's dtypes.  ``1 - beta`` is taken in
    fp32 too, as the kernels take it (at beta2 = 0.999 that differs from
    the rounded exact value by 1.3e-5 relative)."""
    pf, gf = p.float(), g.float() * grad_scale
    mf, vf = m.float(), v.float()
    b1, b2 = np.float32(beta1), np.float32(beta2)
    mf = float(b1) * mf + float(np.float32(1.0) - b1) * gf
    vf = float(b2) * vf + float(np.float32(1.0) - b2) * gf * gf
    u = (mf * bias_c1) / (torch.sqrt(vf * bias_c2) + eps) + weight_decay * pf
    return (u, mf.to(m.dtype), vf.to(v.dtype), (pf * pf).sum(),
            (u * u).sum())


def lamb_stage2_plain(p, update, scaled_lr):
    """``p - scaled_lr * update`` in fp32, returned in p's dtype."""
    return (p.float() - scaled_lr * update.float()).to(p.dtype)


def adam_update_plain(p, g, m, v, *, lr, beta1, beta2, eps, weight_decay,
                      bias_c1, bias_c2, adam_w_mode: bool = True):
    """``(p', m', v')`` for one tensor, fp32 arithmetic, in the dtypes of p,
    m and v.  ``adam_w_mode`` True is AdamW (decay added to the update),
    False classic Adam (decay folded into the gradient).  ``1 - beta`` is
    taken in fp32, as in the kernels."""
    pf, gf = p.float(), g.float()
    mf, vf = m.float(), v.float()
    b1, b2 = np.float32(beta1), np.float32(beta2)
    if not adam_w_mode:
        gf = gf + weight_decay * pf
    mf = float(b1) * mf + float(np.float32(1.0) - b1) * gf
    vf = float(b2) * vf + float(np.float32(1.0) - b2) * gf * gf
    upd = (mf * bias_c1) / (torch.sqrt(vf * bias_c2) + eps)
    if adam_w_mode:
        upd = upd + weight_decay * pf
    pf = pf - lr * upd
    return pf.to(p.dtype), mf.to(m.dtype), vf.to(v.dtype)


def sgd_update_plain(p, g, buf, *, lr, momentum, weight_decay,
                     dampening=0.0, nesterov=False, first_step=False):
    """``(p', buf')`` for one tensor, fp32 arithmetic with fp32 scalars, in
    the dtypes of p and buf: ``g += wd p``; ``buf = g`` on the first step,
    else ``momentum buf + (1 - dampening) g``; ``p -= lr (g + momentum buf)``
    with Nesterov, else ``p -= lr buf``.  ``lr`` is a float or a
    one-element fp32 tensor."""
    pf, gf = p.float(), g.float()
    mom, wd = float(np.float32(momentum)), float(np.float32(weight_decay))
    gf = gf + wd * pf
    if first_step:
        nb = gf
    else:
        damp = float(np.float32(1.0) - np.float32(dampening))
        nb = mom * buf.float() + damp * gf
    step_dir = gf + mom * nb if nesterov else nb
    lr = lr if torch.is_tensor(lr) else float(np.float32(lr))
    return (pf - lr * step_dir).to(p.dtype), nb.to(buf.dtype)


def novograd_moment_plain(sq, v, *, beta2, eps, c2=1.0, first_step=False,
                          init_zero=False):
    """``(v', inv_denom)``, fp32 [T], from the squared grad norms ``sq``
    and the second moments ``v`` (fp32 [T]): ``v' = sq`` on the first step
    (unless ``init_zero``), else ``beta2 v + (1 - beta2) sq``, and
    ``inv_denom = 1 / (sqrt(v' c2) + eps)``.  ``1 - beta2`` is rounded to
    fp32 from the exact value, as the JAX optimizer's Python float is.
    ``c2`` is a float or a 0-d fp32 tensor, ``first_step`` a bool or a 0-d
    bool tensor."""
    sq, v = sq.float(), v.float()
    ema = (float(np.float32(beta2)) * v
           + float(np.float32(1.0 - beta2)) * sq)
    vn = ema if init_zero else torch.where(torch.as_tensor(first_step), sq,
                                           ema)
    c2 = c2 if torch.is_tensor(c2) else float(np.float32(c2))
    return vn, 1.0 / (torch.sqrt(vn * c2) + float(np.float32(eps)))


def novograd_update_plain(p, g, m, *, inv_denom, lr_c1, beta1, weight_decay,
                          grad_avg_coeff):
    """``(p', m')`` for one tensor, fp32 arithmetic, in the dtypes of p and
    m: ``g^ = g inv_denom + wd p``, ``m' = beta1 m + ga g^``,
    ``p' = p - lr_c1 m'``.  ``inv_denom`` and ``lr_c1`` are floats or 0-d
    fp32 tensors."""
    pf, gf, mf = p.float(), g.float(), m.float()
    f32 = lambda x: x if torch.is_tensor(x) else float(np.float32(x))  # noqa
    g_hat = gf * f32(inv_denom) + f32(weight_decay) * pf
    mf = f32(beta1) * mf + f32(grad_avg_coeff) * g_hat
    return (pf - f32(lr_c1) * mf).to(p.dtype), mf.to(m.dtype)


def adagrad_update_plain(p, g, h, *, lr, eps, weight_decay,
                         adagrad_w_mode: bool = False):
    """``(p', h')`` for one tensor, fp32 arithmetic with fp32 scalars, in
    the dtypes of p and h: in L2 mode ``g += wd p`` first; ``h' = h + g^2``,
    ``u = g / (sqrt(h') + eps)``; under ``adagrad_w_mode`` ``u += wd p``;
    ``p' = p - lr u``.  ``lr`` is a float or a one-element fp32 tensor."""
    pf, gf, hf = p.float(), g.float(), h.float()
    wd = float(np.float32(weight_decay))
    if not adagrad_w_mode:
        gf = gf + wd * pf
    hf = hf + gf * gf
    upd = gf / (torch.sqrt(hf) + float(np.float32(eps)))
    if adagrad_w_mode:
        upd = upd + wd * pf
    lr = lr if torch.is_tensor(lr) else float(np.float32(lr))
    return (pf - lr * upd).to(p.dtype), hf.to(h.dtype)


def trust_ratio_plain(p_sq: torch.Tensor, u_sq: torch.Tensor
                      ) -> torch.Tensor:
    """``||p|| / ||u||`` where both are positive, else 1 (optim/fused.py
    :135-136; apex's lamb_stage_2)."""
    w, u = torch.sqrt(p_sq), torch.sqrt(u_sq)
    return torch.where((w > 0) & (u > 0), w / u, torch.ones_like(w))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("fused_optim")
    lib.apex_lamb_stage1.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 3 + [ctypes.c_float] * 5 + [ctypes.c_void_p] * 8
    lib.apex_lamb_stage1.restype = ctypes.c_int
    lib.apex_lamb_stage2.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
    lib.apex_lamb_stage2.restype = ctypes.c_int
    lib.apex_adam.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_float] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 3
    lib.apex_adam.restype = ctypes.c_int
    lib.apex_sgd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_float] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    lib.apex_sgd.restype = ctypes.c_int
    lib.apex_novograd.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 3 + [ctypes.c_float] * 6 + [ctypes.c_int] + [
        ctypes.c_void_p] * 7
    lib.apex_novograd.restype = ctypes.c_int
    lib.apex_adagrad.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_float] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
    lib.apex_adagrad.restype = ctypes.c_int
    return lib


def _check_optim_table(table: TensorTable, who: str, n_lists: int) -> None:
    """A table of ``n_lists`` lists (p, g, m, v or a prefix): p and g of
    one dtype, m and v float32."""
    if len(table.lists) != n_lists:
        raise ValueError(f"{who} takes a table of {n_lists} lists, got "
                         f"{len(table.lists)}")
    if table.dtype(1 if n_lists > 1 else 0) != table.dtype(0):
        raise TypeError(f"{who}: p and g must share a dtype")
    for index in range(2, n_lists):
        if table.dtype(index) != torch.float32:
            raise TypeError(f"{who}: m and v must be float32")


def _check_lamb_table(table: TensorTable, u: torch.Tensor, who: str,
                      n_lists: int) -> None:
    _check_optim_table(table, who, n_lists)
    if (u.dtype != torch.float32 or u.dim() != 1 or u.numel() != table.total
            or not u.is_contiguous()):
        raise ValueError(f"{who}: u must be a contiguous float32 buffer of "
                         f"{table.total} elements")
    if u.device != table.device:
        raise ValueError(f"{who}: u lies on {u.device}, the tensors on "
                         f"{table.device}")
    check_table(table, 0, who)


def _check_scalars(scalars_t: torch.Tensor, table: TensorTable) -> None:
    if (scalars_t.dtype != torch.float32 or scalars_t.numel() != 3
            or not scalars_t.is_contiguous()
            or scalars_t.device != table.device):
        raise ValueError("scalars_t must be three contiguous float32 (lr, "
                         "c1, c2) on the tensors' device")


def step_scalars(lr: float, bias_c1: float = 1.0, bias_c2: float = 1.0,
                 device="cpu") -> torch.Tensor:
    """The row ``scalars_t`` of one step: fp32 [3] (lr, c1, c2) on
    ``device``."""
    return torch.tensor([lr, bias_c1, bias_c2], dtype=torch.float32,
                        device=device)


def lamb_stage1_cuda(table: TensorTable, u: torch.Tensor,
                     gnorm: Optional[torch.Tensor], *, beta1: float,
                     beta2: float, eps: float, weight_decay: float,
                     scalars_t: torch.Tensor, max_grad_norm: float = 0.0,
                     noop_flag: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 1 over a table of lists (p, g, m, v): m and v updated in place,
    u filled, and ``(sums, ratio)`` returned: ``sums`` fp32 [2, T] holds
    ||p||^2 and ||u||^2 per tensor, ``ratio`` fp32 [T] the trust ratios.
    The gradient is scaled by where(gnorm > max_grad_norm,
    max_grad_norm / (gnorm + 1e-6), 1), read from the 0-d device tensor
    ``gnorm`` by the kernel; ``gnorm`` None means no clip.  ``scalars_t``:
    the step's (lr, c1, c2), fp32 [3] on the card (c1 and c2 read here);
    ``noop_flag``: a 0-d int32 on the card, nonzero to leave m, v and u
    untouched and ``sums`` and ``ratio`` unwritten.
    ``lamb_stage1_cuda.launches`` counts the calls."""
    _check_scalars(scalars_t, table)
    _check_device_scalar(noop_flag, "noop_flag", torch.int32, table)
    _check_lamb_table(table, u, "lamb_stage1_cuda", 4)
    if gnorm is not None and (gnorm.dtype != torch.float32
                              or gnorm.numel() != 1
                              or gnorm.device != table.device):
        raise ValueError("gnorm must be one float32 on the tensors' device")
    table.refresh()
    dev = table.device
    partial = torch.empty(2 * max(table.n_chunks, 1), dtype=torch.float32,
                          device=dev)
    sums = torch.empty(2, table.n_tensors, dtype=torch.float32, device=dev)
    ratio = torch.empty(table.n_tensors, dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.apex_lamb_stage1(
            *table.args(), _build.DTYPE_CODES[table.dtype(0)], beta1, beta2,
            eps, weight_decay, max_grad_norm,
            None if gnorm is None else gnorm.data_ptr(),
            scalars_t.data_ptr(),
            None if noop_flag is None else noop_flag.data_ptr(),
            u.data_ptr(), partial.data_ptr(), sums.data_ptr(),
            ratio.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, lib, "lamb_stage1", ARG_ERRORS)
    lamb_stage1_cuda.launches += 1
    return sums, ratio


lamb_stage1_cuda.launches = 0


def lamb_stage2_cuda(table: TensorTable, u: torch.Tensor,
                     ratio: torch.Tensor, scalars_t: torch.Tensor,
                     noop_flag: Optional[torch.Tensor] = None) -> None:
    """Stage 2 over list 0 (p) of ``table``: p -= (lr * ratio[t]) * u, in
    place, lr read on the card from ``scalars_t`` (the step's (lr, c1, c2),
    fp32 [3]); ``noop_flag`` (0-d int32 on the card) nonzero leaves p
    untouched.  ``lamb_stage2_cuda.launches`` counts the calls."""
    _check_scalars(scalars_t, table)
    _check_device_scalar(noop_flag, "noop_flag", torch.int32, table)
    _check_lamb_table(table, u, "lamb_stage2_cuda", len(table.lists))
    if (ratio.dtype != torch.float32 or ratio.numel() != table.n_tensors
            or ratio.device != table.device):
        raise ValueError(f"ratio must be float32 [{table.n_tensors}] on the "
                         f"tensors' device")
    table.refresh()
    lib = _library()
    with torch.cuda.device(table.device):
        rc = lib.apex_lamb_stage2(
            *table.args(), _build.DTYPE_CODES[table.dtype(0)], u.data_ptr(),
            ratio.data_ptr(), scalars_t.data_ptr(),
            None if noop_flag is None else noop_flag.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, lib, "lamb_stage2", ARG_ERRORS)
    lamb_stage2_cuda.launches += 1


lamb_stage2_cuda.launches = 0


def adam_cuda(table: TensorTable, *, beta1: float, beta2: float, eps: float,
              weight_decay: float, scalars_t: torch.Tensor,
              adam_w_mode: bool = True,
              noop_flag: Optional[torch.Tensor] = None) -> None:
    """Adam over a table of four lists (p, g, m, v), p, m and v updated in
    place, in one call of the CUDA kernel.  ``scalars_t``: the step's (lr,
    c1, c2), fp32 [3] on the card; ``noop_flag``: a 0-d int32 on the card,
    nonzero to leave p, m and v untouched.  ``adam_cuda.launches`` counts
    the calls."""
    _check_optim_table(table, "adam_cuda", 4)
    _check_scalars(scalars_t, table)
    _check_device_scalar(noop_flag, "noop_flag", torch.int32, table)
    check_table(table, 0, "adam_cuda")
    table.refresh()
    lib = _library()
    with torch.cuda.device(table.device):
        rc = lib.apex_adam(
            *table.args(), _build.DTYPE_CODES[table.dtype(0)], beta1, beta2,
            eps, weight_decay, int(bool(adam_w_mode)), scalars_t.data_ptr(),
            None if noop_flag is None else noop_flag.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, lib, "adam", ARG_ERRORS)
    adam_cuda.launches += 1


adam_cuda.launches = 0


def _check_device_scalar(t: Optional[torch.Tensor], name: str, dtype,
                         table: TensorTable) -> None:
    if t is not None and (t.dtype != dtype or t.numel() != 1
                          or t.device != table.device):
        raise ValueError(f"{name} must be one {dtype} on the tensors' "
                         f"device")


def _check_three_lists(table: TensorTable, who: str, state: str) -> None:
    """A table of (p, g, state): p and g of one dtype, the state float32."""
    if len(table.lists) != 3:
        raise ValueError(f"{who} takes a table of 3 lists, got "
                         f"{len(table.lists)}")
    if table.dtype(1) != table.dtype(0):
        raise TypeError(f"{who}: p and g must share a dtype")
    if table.dtype(2) != torch.float32:
        raise TypeError(f"{who}: {state} must be float32")


def sgd_cuda(table: TensorTable, *, lr: float, momentum: float,
             weight_decay: float, dampening: float = 0.0,
             nesterov: bool = False, first_step: bool = False,
             lr_t: Optional[torch.Tensor] = None,
             noop_flag: Optional[torch.Tensor] = None) -> None:
    """Momentum SGD over a table of three lists (p, g, buf), p and buf
    updated in place, in one call of the CUDA kernel.  ``lr_t``: a
    one-element fp32 tensor on the card read in place of ``lr``;
    ``noop_flag``: a one-element int32 on the card, nonzero to leave p and
    buf untouched.  ``sgd_cuda.launches`` counts the calls."""
    _check_three_lists(table, "sgd_cuda", "the momentum buffers")
    _check_device_scalar(lr_t, "lr_t", torch.float32, table)
    _check_device_scalar(noop_flag, "noop_flag", torch.int32, table)
    check_table(table, 0, "sgd_cuda")
    table.refresh()
    lib = _library()
    with torch.cuda.device(table.device):
        rc = lib.apex_sgd(
            *table.args(), _build.DTYPE_CODES[table.dtype(0)], float(lr),
            momentum, weight_decay, dampening, int(bool(nesterov)),
            int(bool(first_step)), None if lr_t is None else lr_t.data_ptr(),
            None if noop_flag is None else noop_flag.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, lib, "sgd", ARG_ERRORS)
    sgd_cuda.launches += 1


sgd_cuda.launches = 0


def _check_per_tensor(t: torch.Tensor, name: str, table: TensorTable) -> None:
    if (t.dtype != torch.float32 or t.dim() != 1
            or t.numel() != table.n_tensors or not t.is_contiguous()
            or t.device != table.device):
        raise ValueError(f"{name} must be a contiguous float32 "
                         f"[{table.n_tensors}] on the tensors' device")


def novograd_cuda(table: TensorTable, sq: torch.Tensor, v: torch.Tensor,
                  scalars_t: torch.Tensor, step_t: torch.Tensor, *,
                  beta1: float, beta2: float, eps: float,
                  weight_decay: float, grad_avg_coeff: float,
                  init_zero: bool = False,
                  noop_flag: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NovoGrad over a table of three lists (p, g, m) in one call: the
    per-tensor kernel turns the squared grad norms ``sq`` (fp32 [T]) into
    the second moments ``v`` (fp32 [T], in place) and ``inv_denom``, then
    the chunk kernel updates p and m in place.  ``scalars_t``: the step's
    (lr_c1, c2), fp32 [2] on the card; ``step_t``: a 0-d int32 on the card,
    the steps taken so far (the first step when 0); ``noop_flag``: a 0-d
    int32 on the card, nonzero to leave p, m and v untouched.  Returns
    ``inv_denom`` (fp32 [T]).  ``novograd_cuda.launches`` counts the
    calls."""
    who = "novograd_cuda"
    _check_three_lists(table, who, "m")
    _check_per_tensor(sq, "sq", table)
    _check_per_tensor(v, "v", table)
    if (scalars_t.dtype != torch.float32 or scalars_t.numel() != 2
            or not scalars_t.is_contiguous()
            or scalars_t.device != table.device):
        raise ValueError("scalars_t must be two contiguous float32 (lr_c1, "
                         "c2) on the tensors' device")
    _check_device_scalar(step_t, "step_t", torch.int32, table)
    _check_device_scalar(noop_flag, "noop_flag", torch.int32, table)
    check_table(table, 0, who)
    table.refresh()
    inv_denom = torch.empty(table.n_tensors, dtype=torch.float32,
                            device=table.device)
    lib = _library()
    with torch.cuda.device(table.device):
        rc = lib.apex_novograd(
            *table.args(), _build.DTYPE_CODES[table.dtype(0)], beta1, beta2,
            float(np.float32(1.0 - beta2)), eps, weight_decay,
            grad_avg_coeff, int(bool(init_zero)), sq.data_ptr(),
            v.data_ptr(), inv_denom.data_ptr(), scalars_t.data_ptr(),
            step_t.data_ptr(),
            None if noop_flag is None else noop_flag.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, lib, "novograd", ARG_ERRORS)
    novograd_cuda.launches += 1
    return inv_denom


novograd_cuda.launches = 0


def adagrad_cuda(table: TensorTable, *, lr: float, eps: float,
                 weight_decay: float, adagrad_w_mode: bool = False,
                 lr_t: Optional[torch.Tensor] = None,
                 noop_flag: Optional[torch.Tensor] = None) -> None:
    """Adagrad over a table of three lists (p, g, h), p and h updated in
    place, in one call of the CUDA kernel.  ``lr_t`` and ``noop_flag`` as
    :func:`sgd_cuda`'s.  ``adagrad_cuda.launches`` counts the calls."""
    _check_three_lists(table, "adagrad_cuda", "the sums of squares")
    _check_device_scalar(lr_t, "lr_t", torch.float32, table)
    _check_device_scalar(noop_flag, "noop_flag", torch.int32, table)
    check_table(table, 0, "adagrad_cuda")
    table.refresh()
    lib = _library()
    with torch.cuda.device(table.device):
        rc = lib.apex_adagrad(
            *table.args(), _build.DTYPE_CODES[table.dtype(0)], float(lr),
            eps, weight_decay, int(bool(adagrad_w_mode)),
            None if lr_t is None else lr_t.data_ptr(),
            None if noop_flag is None else noop_flag.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, lib, "adagrad", ARG_ERRORS)
    adagrad_cuda.launches += 1


adagrad_cuda.launches = 0
