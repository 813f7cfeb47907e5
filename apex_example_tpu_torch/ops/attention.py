"""Flash attention: the hand-written Hopper kernels and their plain versions.

Port of apex_example_tpu/ops/attention.py.  The public layout is JAX's:
q (B, Sq, H, D), k and v (B, Sk, H, D), an optional additive key bias
(B, Sk) (finite, ~-1e9 for a masked key), the output (B, Sq, H, D) in q's
dtype and the row logsumexp lse (B, H, Sq) in fp32.

``attention_plain`` / ``attention_pair_plain`` are the arithmetic of
``_scores_reference``, ``attention_reference`` and ``_reference_pair``
(:74-118): fp32 scores scaled by a multiplication, the bias added in fp32,
the causal mask bottom-right aligned (``off = Sk - Sq``) as the finite
``_MASK`` (:60), P = softmax(S) cast to the input dtype before P V.
``attention_bwd_plain`` is the backward by the kernels' equations
(:183-236, :349-361): P = exp(S - lse), Delta = rowsum(dO * O) - dlse with
O the rounded output, dS = P * (dP - Delta) * scale, P and dS cast to the
input dtype before their products; the CPU tests hold it, and through it
the kernels' math, against ``jax.vjp`` of the JAX op.

``flash_attention_cuda`` (the forward), ``flash_attention_dkdv_cuda`` and
``flash_attention_dq_cuda`` launch csrc/attention.cu, the kernels that
replace the Pallas bodies on the card (the source notes state the bounds
and designs): the dtype alone picks the kernel, the tensor cores' for
bf16 and fp16, the CUDA cores' for fp32; every kernel reads q, k, v and
dO through their strides, so no view is copied.
Delta is computed between them in PyTorch, as JAX leaves it to XLA.  Each
validates its arguments, builds the library at first use, launches and
counts its launches in ``.launches``.

The limits the card checks hold the kernels to live here, once:
``ATTN_FWD_TOL`` / ``ATTN_BWD_TOL`` for fp32 results, and
``half_result_check`` for a half (bf16, fp16) O, dQ, dK or dV, which the
tensor cores sum in another order than the plain version: every element
within about two ulps, a bounded share of elements off at all, and in a
batch element whose key bias masks every key (``dead_batch``) a per-row
floor of 3 x the plain version's own distance from correctly rounded
sums (``attention_exact_sums``).

``attention_fwd`` / ``attention_bwd`` choose by where the tensors lie: a
CPU tensor takes the plain version, a CUDA tensor the kernels, whose
wrappers raise on anything they cannot take.  Nothing falls back from one
to the other.  ``FlashAttentionFunction`` is the ``torch.autograd.Function``
of both JAX ``custom_vjp``s (:466-532): its forward returns (o, lse) and
saves (q, k, v, bias, o, lse); its backward takes (dO, dlse).  The bias is
a constant mask and gets no gradient (``stop_gradient`` in JAX).
``flash_attention`` drops lse; ``flash_attention_with_lse`` returns it and
lets it carry a cotangent.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from apex_example_tpu_torch.ops import _build

MASK = -0.7 * float(torch.finfo(torch.float32).max)   # attention.py:60
# csrc/attention.cu's kMaxD and kTile, checked here before a build or a
# launch (tests/test_torch_attention.py holds the copies equal)
MAX_D = 128             # the widest head the kernels take
TILE = 64               # rows of a q tile and of a k/v tile
_ARG_ERRORS = {-1: "unsupported dtype", -2: "head dim out of range",
               -3: "sequence length out of range",
               -4: "batch x heads out of range",
               -5: "causal attention needs Sq <= Sk"}

Pair = Tuple[torch.Tensor, torch.Tensor]
Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# The limits of the card checks (chip_smoke.py, tests/test_torch_cuda.py).
# fp32: lse, O, dQ, dK and dV, atol = rtol (sums in another order).
ATTN_FWD_TOL, ATTN_BWD_TOL = 2e-5, 5e-5
# A half O against the reference's arithmetic (``attention_pair_plain``),
# which rounds the normalised P and so moves ~half of O's roundings by an
# ulp: atol = rtol.
ATTN_HALF_TOL = 2e-2
# A half O against ``attention_pair_tiled_plain`` and a half dQ, dK and dV
# against ``attention_bwd_plain``: within about two bf16 ulps (rtol,
# atol), and at most ATTN_HALF_FLIPS (bf16) or ATTN_HALF_FLIPS_FP16 of the
# elements not bitwise equal.  The tensor cores add the same fp32 products
# in another order; a sum that moves by a few fp32 ulps crosses a rounding
# boundary of the output dtype with a chance that scales with its
# precision, and fp16 keeps 3 more mantissa bits than bf16 (2^3 = 8 x the
# flips).  A rounding point of P or dS skipped or moved flips 39-55%.
ATTN_HALF_O_RTOL, ATTN_HALF_O_ATOL = 1e-2, 1e-3
ATTN_HALF_FLIPS, ATTN_HALF_FLIPS_FP16 = 1e-2, 8e-2
# A batch element is dead when its key bias masks every key (every bias
# at or below DEAD_BIAS): lse = -1e9 + log Sk rounds to -1e9 in fp32, so
# P = exp(S - lse) is 1 at every pair and its gradients are sums of
# unnormalised terms that cancel.  Each row of a dead element's dQ, dK or
# dV may be off by DEAD_FLOOR_X x that row's max |plain - exact sums|.
DEAD_BIAS = -1e8
DEAD_FLOOR_X = 3


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the plain versions' arithmetic type: fp32, or fp64 for an
    fp64 tensor."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return 1.0 / (q.shape[-1] ** 0.5) if scale is None else float(scale)


def check_causal(q: torch.Tensor, k: torch.Tensor, causal: bool) -> None:
    """The ``causal and Sq > Sk`` refusal (:419-427): bottom-right
    alignment would leave the first Sq - Sk queries no key at all."""
    if causal and q.shape[1] > k.shape[1]:
        raise ValueError(
            f"causal attention needs Sq <= Sk (bottom-right alignment), got "
            f"Sq={q.shape[1]} > Sk={k.shape[1]}")


def scores_plain(q: torch.Tensor, k: torch.Tensor,
                 bias: Optional[torch.Tensor], causal: bool,
                 scale: float) -> torch.Tensor:
    """fp32 (B, H, Sq, Sk) scores: (Q K^T) * scale, + bias, causal mask
    (``_scores_reference`` :74)."""
    return _scores(torch.einsum("bqhd,bkhd->bhqk", _acc(q), _acc(k)), q, k,
                   bias, causal, scale)


def _scores(dots: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
            bias: Optional[torch.Tensor], causal: bool,
            scale: float) -> torch.Tensor:
    """The scores from the (B, H, Sq, Sk) Q K^T dot products."""
    s = dots * scale
    if bias is not None:
        s = s + bias[:, None, None, :].to(s.dtype)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        live = rows >= torch.arange(sk, device=q.device)[None, :]
        s = torch.where(live, s, torch.full_like(s, MASK))
    return s


def attention_pair_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         causal: bool = False,
                         scale: Optional[float] = None) -> Pair:
    """The output and its (B, H, Sq) fp32 logsumexp from one score tensor
    (``_reference_pair`` :104).  The output is ``attention_reference``'s
    (:93): P = softmax(S), normalised by its row sum as the kernel's
    acc / l is, cast to the input dtype, times V with fp32 sums; not
    exp(S - lse), which for a row whose keys are all masked at -1e9 would
    sum to Sk (lse = -1e9 + log Sk rounds to -1e9 in fp32)."""
    s = scores_plain(q, k, bias, causal, _scale(q, scale))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", _acc(p), _acc(v)).to(q.dtype)
    return o, lse


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """``attention_reference`` (:93): (B, Sq, H, D) in q's dtype."""
    return attention_pair_plain(q, k, v, bias, causal, scale)[0]


def attention_pair_tiled_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               bias: Optional[torch.Tensor] = None,
                               causal: bool = False,
                               scale: Optional[float] = None,
                               tile: int = TILE) -> Pair:
    """``(o, lse)`` by the forward kernel's arithmetic (``_fwd_kernel``
    :147) in plain PyTorch: over k/v tiles of ``tile`` keys, the running
    row max m, P = exp(S - m) cast to the input dtype before P V, l = l *
    alpha + rowsum(P) of the unrounded P, O = acc / l (l = 0 taken as 1).
    A half O rounds where the kernels' does; ``attention_pair_plain``, the
    reference's arithmetic, rounds the normalised P, which moves about
    half of a bf16 O's roundings by an ulp.  The card checks hold the
    kernel's half O to this one."""
    s = scores_plain(q, k, bias, causal, _scale(q, scale))
    b, sq, h, d = q.shape
    m = torch.full((b, h, sq, 1), MASK, dtype=s.dtype, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, h, sq, d, dtype=s.dtype, device=q.device)
    for j in range(0, k.shape[1], tile):
        sj = s[..., j:j + tile]
        m_new = torch.maximum(m, sj.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sj - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhqk,bkhd->bhqd", _acc(p.to(q.dtype)), _acc(v[:, j:j + tile]))
        m = m_new
    lsafe = torch.where(l == 0, torch.ones_like(l), l)
    o = (acc / lsafe).transpose(1, 2).to(q.dtype)
    return o, (m + torch.log(lsafe))[..., 0]


def attention_exact_sums(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: Optional[torch.Tensor], causal: bool,
                         scale: float, do: torch.Tensor, dl: torch.Tensor,
                         lse: torch.Tensor) -> Grads:
    """(dq, dk, dv) of :func:`attention_bwd_plain` with every dot product
    summed in fp64 and rounded once to fp32 (the scores, dP, dV, dK, dQ),
    at the plain version's rounding points: P and dS rounded to the input
    dtype, each output once.  ``dl`` and ``lse`` are the Delta and
    logsumexp the kernels read.  The half checks measure the plain
    version's own distance from it in dead batch elements; call it on
    their slices, it holds (B, H, Sq, Sk) fp64 products."""
    dt = q.dtype
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    s = _scores(torch.einsum("bqhd,bkhd->bhqk", q64, k64).float(), q, k,
                bias, causal, scale)
    p = torch.exp(s - lse.float()[..., None])
    del s
    dp = torch.einsum("bqhd,bkhd->bhqk", do64, v64).float()
    ds = (p * (dp - dl.float()[..., None]) * scale).to(dt).double()
    del dp
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).double(), do64).float()
    del p
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q64).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k64).float()
    return dq.to(dt), dk.to(dt), dv.to(dt)


def dead_batch(bias: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(B,) bool: the batch elements whose key bias masks every key (every
    bias <= DEAD_BIAS); None without a bias."""
    return None if bias is None else (bias <= DEAD_BIAS).all(dim=1)


class HalfCheck(NamedTuple):
    err: float     # max |got - ref| over every element
    share: float   # elements not bitwise equal, of the live batch elements
    ok: bool       # within the limit
    floor: float   # the largest dead-row floor (0 without a dead element)


def half_result_check(name: str, got: torch.Tensor, ref: torch.Tensor,
                      dead: Optional[torch.Tensor] = None,
                      exact: Optional[torch.Tensor] = None) -> HalfCheck:
    """Hold a half (bf16, fp16) result ``got`` of a kernel to ``ref``, the
    plain version's: a half O ("o") to ``attention_pair_tiled_plain``, a
    dQ, dK or dV ("dq", "dk", "dv") to ``attention_bwd_plain`` fed the
    plain forward's lse and Delta; all (B, S, H, D).

    1. Every element within ATTN_HALF_O_ATOL + ATTN_HALF_O_RTOL |ref|.
    2. At most ATTN_HALF_FLIPS (bf16) or ATTN_HALF_FLIPS_FP16 (fp16) of the
       elements of the live batch elements not bitwise equal.
    3. In the gradients' dead batch elements (``dead``, (B,) bool, from
       :func:`dead_batch`), each row (the last dim: one (b, key, h) of dK
       or dV, one (b, query, h) of dQ) within the larger of 1.'s bound and
       DEAD_FLOOR_X x that row's max |ref - exact|; ``exact`` is
       :func:`attention_exact_sums`'s result on those elements' slices.
       No other row, and no O, takes a floor.
    The dtypes and shapes must be equal."""
    if name not in ("o", "dq", "dk", "dv"):
        raise ValueError(f"no half limit for {name!r}")
    if got.dtype != ref.dtype or got.shape != ref.shape:
        return HalfCheck(float("inf"), 1.0, False, 0.0)
    gd, rd = got.double(), ref.double()
    err = (gd - rd).abs()
    bound = ATTN_HALF_O_ATOL + ATTN_HALF_O_RTOL * rd.abs()
    live, floor = slice(None), 0.0
    if dead is not None and bool(dead.any()):
        if name == "o":
            raise ValueError("a half O takes no dead-row floor")
        if exact is None or exact.shape != got[dead].shape:
            raise ValueError(f"{name}: the dead elements' exact sums must be "
                             f"shaped {tuple(got[dead].shape)}")
        rows = DEAD_FLOOR_X * (rd[dead] - exact.double()).abs().amax(
            -1, keepdim=True)
        bound[dead] = torch.maximum(bound[dead], rows)
        live, floor = ~dead, float(rows.max())
    flips = (ATTN_HALF_FLIPS_FP16 if got.dtype == torch.float16
             else ATTN_HALF_FLIPS)
    kept = got[live]
    share = (float((kept != ref[live]).float().mean()) if kept.numel()
             else 0.0)
    ok = bool((err <= bound).all()) and share <= flips
    return HalfCheck(float(err.max()), share, ok, floor)


def delta(o: torch.Tensor, do: torch.Tensor,
          dlse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Delta = rowsum(dO * O) - dlse, (B, H, Sq) fp32 contiguous (:356-361;
    left to PyTorch as JAX leaves it to XLA)."""
    d = (_acc(do) * _acc(o)).sum(-1).transpose(1, 2)
    if dlse is not None:
        d = d - dlse.to(d.dtype)
    return d.contiguous()


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor], causal: bool,
                        scale: float, o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor,
                        dlse: Optional[torch.Tensor] = None) -> Grads:
    """(dq, dk, dv) in the inputs' dtypes by the kernels' equations: P =
    exp(S - lse); dV = P^T dO with P cast to the input dtype; dP = dO V^T;
    dS = P * (dP - Delta) * scale cast to the input dtype; dK = dS^T Q;
    dQ = dS K."""
    s = scores_plain(q, k, bias, causal, scale)
    p = torch.exp(s - _acc(lse)[..., None])
    dl = delta(o, do, dlse)
    dof = _acc(do)
    dv = torch.einsum("bhqk,bqhd->bkhd", _acc(p.to(q.dtype)), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, _acc(v))
    ds = _acc((p * (dp - dl[..., None]) * scale).to(q.dtype))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, _acc(q))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _acc(k))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                bias: Optional[torch.Tensor], causal: bool,
                do: Optional[torch.Tensor] = None, rows=()) -> None:
    """Everything the kernels do not take raises here, before a build or
    a launch: shapes, dtypes and sizes first, the device last.  The
    backward's ``do`` is shaped and typed like q, ``rows`` (its lse and
    Delta) contiguous fp32 (B, H, Sq)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash attention takes (B, S, H, D) q, k and v, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"flash attention takes float32, bfloat16 or "
                        f"float16, got {q.dtype}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if (k.shape != (b, sk, h, d) or v.shape != k.shape
            or k.dtype != q.dtype or v.dtype != q.dtype):
        raise ValueError(f"k and v must be {q.dtype} (B={b}, Sk, H={h}, "
                         f"D={d}), got {k.dtype} {tuple(k.shape)} and "
                         f"{v.dtype} {tuple(v.shape)}")
    if do is not None and (do.shape != q.shape or do.dtype != q.dtype):
        raise ValueError(f"do must match q ({q.dtype} {tuple(q.shape)}), "
                         f"got {do.dtype} {tuple(do.shape)}")
    if d % 8 or not 8 <= d <= MAX_D:
        raise ValueError(f"flash attention takes a head dim that is a "
                         f"multiple of 8 up to {MAX_D}, got {d}")
    if min(sq, sk) < 1 or max(sq, sk) > 65535 * TILE:
        raise ValueError(f"flash attention takes 1 <= S <= {65535 * TILE}, "
                         f"got Sq={sq}, Sk={sk}")
    if b * h >= 2 ** 31:
        raise ValueError(f"flash attention takes B x H < 2**31, got {b * h}")
    check_causal(q, k, causal)
    if bias is not None and (tuple(bias.shape) != (b, sk)
                             or bias.dtype != torch.float32):
        raise ValueError(f"bias must be float32 of shape ({b}, {sk}), got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    for name, t in zip(("lse", "delta"), rows):
        if (tuple(t.shape) != (b, h, sq) or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 ({b}, {h}, "
                             f"{sq}), got {t.dtype} {tuple(t.shape)}")
    for name, t in (("k", k), ("v", v), ("bias", bias), ("do", do)) + tuple(
            zip(("lse", "delta"), rows)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
    if q.device.type != "cuda":
        raise ValueError(f"flash attention launches a CUDA kernel; q lies "
                         f"on {q.device}")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("attention")
    lib.apex_attn_fwd.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.apex_attn_fwd.restype = ctypes.c_int
    lib.apex_attn_dq.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.apex_attn_dq.restype = ctypes.c_int
    lib.apex_attn_dkdv.argtypes = [ctypes.c_void_p] * 11 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.apex_attn_dkdv.restype = ctypes.c_int
    return lib


def _geometry(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              do: Optional[torch.Tensor], bias: Optional[torch.Tensor],
              causal: bool):
    """The host arrays the C entry points read: dims (B, H, Sq, Sk, D,
    causal) and the strides (B, S, H, D) of q, k, v and dO, then (B, Sk)
    of the bias."""
    b, sq, h, d = q.shape
    dims = (ctypes.c_longlong * 6)(b, h, sq, k.shape[1], d, int(causal))
    strides = []
    for t in (q, k, v, do if do is not None else q):
        st = t.stride()
        strides += [st[0], st[1], st[2], st[3]]
    strides += list(bias.stride()) if bias is not None else [0, 0]
    return dims, (ctypes.c_longlong * 18)(*strides)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         causal: bool = False,
                         scale: Optional[float] = None) -> Pair:
    """``(o, lse)`` like :func:`attention_pair_plain`, computed by the
    forward kernel on PyTorch's current stream.
    ``flash_attention_cuda.launches`` counts its launches."""
    _check_args(q, k, v, bias, causal)
    b, sq, h, d = q.shape
    o = torch.empty(b, sq, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    dims, strides = _geometry(q, k, v, None, bias, causal)
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.apex_attn_fwd(
            dims, strides, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(bias), o.data_ptr(), lse.data_ptr(), _scale(q, scale),
            _build.DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, lib, "attention forward", _ARG_ERRORS)
    flash_attention_cuda.launches += 1
    return o, lse


flash_attention_cuda.launches = 0


def flash_attention_dkdv_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, bias: Optional[torch.Tensor],
                              causal: bool, scale: float, do: torch.Tensor,
                              lse: torch.Tensor, dl: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` from the saved lse and Delta ``dl`` (both (B, H, Sq)
    fp32), computed by the dK/dV kernel.
    ``flash_attention_dkdv_cuda.launches`` counts its launches."""
    _check_args(q, k, v, bias, causal, do, rows=(lse, dl))
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    dims, strides = _geometry(q, k, v, do, bias, causal)
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.apex_attn_dkdv(
            dims, strides, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), _ptr(bias), lse.data_ptr(), dl.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), float(scale),
            _build.DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, lib, "attention dK/dV", _ARG_ERRORS)
    flash_attention_dkdv_cuda.launches += 1
    return dk, dv


flash_attention_dkdv_cuda.launches = 0


def flash_attention_dq_cuda(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, bias: Optional[torch.Tensor],
                            causal: bool, scale: float, do: torch.Tensor,
                            lse: torch.Tensor, dl: torch.Tensor
                            ) -> torch.Tensor:
    """``dq`` from the saved lse and Delta, computed by the dQ kernel.
    ``flash_attention_dq_cuda.launches`` counts its launches."""
    _check_args(q, k, v, bias, causal, do, rows=(lse, dl))
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dims, strides = _geometry(q, k, v, do, bias, causal)
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.apex_attn_dq(
            dims, strides, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), _ptr(bias), lse.data_ptr(), dl.data_ptr(),
            dq.data_ptr(), float(scale), _build.DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, lib, "attention dQ", _ARG_ERRORS)
    flash_attention_dq_cuda.launches += 1
    return dq


flash_attention_dq_cuda.launches = 0


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor], causal: bool,
                  scale: float) -> Pair:
    """``(o, lse)``: the plain version for CPU tensors, the kernel
    otherwise (``_lse_fwd`` :401)."""
    check_causal(q, k, causal)
    if q.device.type == "cpu":
        return attention_pair_plain(q, k, v, bias, causal, scale)
    return flash_attention_cuda(q, k, v, bias, causal, scale)


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor], causal: bool, scale: float,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  dlse: Optional[torch.Tensor] = None) -> Grads:
    """(dq, dk, dv) (``_bwd_dispatch`` :431): the plain version for CPU
    tensors; otherwise Delta in PyTorch, then the dK/dV and dQ kernels."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, bias, causal, scale, o, lse, do,
                                   dlse)
    dl = delta(o, do, dlse)
    dk, dv = flash_attention_dkdv_cuda(q, k, v, bias, causal, scale, do,
                                       lse, dl)
    dq = flash_attention_dq_cuda(q, k, v, bias, causal, scale, do, lse, dl)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Both JAX ``custom_vjp``s (:466-532): forward ``(o, lse)``, saving
    ``(q, k, v, bias, o, lse)``; backward from ``(do, dlse)``, the bias
    getting none (a constant mask)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale):
        o, lse = attention_fwd(q, k, v, bias, causal, scale)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.causal, ctx.scale = causal, scale
        # An output the caller drops gets no cotangent (None), not zeros:
        # flash_attention's lse then adds nothing to Delta.
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, bias, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv = attention_bwd(q, k, v, bias, ctx.causal, ctx.scale, o,
                                   lse, do, dlse)
        return dq, dk, dv, None, None, None


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             bias: Optional[torch.Tensor] = None,
                             causal: bool = False,
                             scale: Optional[float] = None) -> Pair:
    """Memory-efficient attention that also returns the row logsumexp:
    ``(o, lse)``, o (B, Sq, H, D) in q's dtype, lse (B, H, Sq) fp32.  lse
    is differentiable (its cotangent folds into Delta: d lse_i / d S_ij =
    P_ij); the bias is a constant mask (detached, no gradient)."""
    if bias is not None:
        bias = bias.detach()
    return FlashAttentionFunction.apply(q, k, v, bias, causal,
                                        _scale(q, scale))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Memory-efficient multi-head attention: q (B, Sq, H, D), k and v
    (B, Sk, H, D), an optional (B, Sk) fp32 additive key bias (a constant
    mask), causal bottom-right aligned; (B, Sq, H, D) in q's dtype, softmax
    in fp32.  The (B, H, Sq, Sk) probabilities are never stored on the
    card: the backward recomputes them from the saved logsumexp."""
    return flash_attention_with_lse(q, k, v, bias, causal, scale)[0]
