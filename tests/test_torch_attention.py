"""The port's flash attention (apex_example_tpu_torch/ops/attention.py) held
against the JAX package's ``flash_attention`` / ``flash_attention_with_lse``
on the CPU.

The same numpy inputs from a seed go through both.  The JAX side runs its
Pallas kernels in interpret mode (tests/conftest.py) wherever Sq and Sk
are multiples of 128, and its XLA reference branch otherwise (the ragged
case); the port's CPU route is the plain version, whose backward uses the
CUDA kernels' equations.  Tolerances as tests/test_attention.py: the
forward O and lse atol = rtol = 2e-5 in fp32 (sums in another order, and
online against one-pass softmax); the grads of q, k and v 5e-5, 1e-4
where sums run over several 128-row blocks; bf16 2e-2 (P and dS are
rounded to bf16 at the kernels' points, the outputs once more).  The
kernels' forward arithmetic in plain PyTorch (``attention_pair_tiled_plain``,
which the card checks hold a half O to) rounds P where JAX's kernel does.

The CUDA wrappers' argument checks run on meta tensors: they raise before
anything is built, and a tensor that is not on the CPU never reaches the
plain version.  The card's route (the kernels replaced by fakes on meta
tensors) goes through ``FlashAttentionFunction``, so its output carries a
``grad_fn`` and its backward launches the dK/dV and dQ kernels.  The
kernels themselves run only on the card: tests/test_torch_cuda.py and
chip_smoke.py.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_example_tpu.ops.attention import attention_reference
from apex_example_tpu.ops.attention import flash_attention as jax_flash
from apex_example_tpu.ops.attention import \
    flash_attention_with_lse as jax_flash_lse
from apex_example_tpu_torch.ops import _build
from apex_example_tpu_torch.ops import attention as att

FWD_TOL = 2e-5
GRAD_TOL = 5e-5
BF16_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(b=2, sq=256, sk=256, h=2, d=64, seed=0, bias=False):
    """q, k, v (float32 numpy) and a (B, Sk) key bias masking a random
    suffix of each row's keys (row 0 keeps them all) at -1e9, or None."""
    rs = np.random.RandomState(seed)
    q = rs.randn(b, sq, h, d).astype(np.float32)
    k = rs.randn(b, sk, h, d).astype(np.float32)
    v = rs.randn(b, sk, h, d).astype(np.float32)
    mask = None
    if bias:
        keep = rs.randint(sk // 2, sk + 1, size=b)
        keep[0] = sk
        mask = np.where(np.arange(sk)[None, :] < keep[:, None], 0.0,
                        -1e9).astype(np.float32)
    return q, k, v, mask


def _jax(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


def _torch(a, dtype=torch.float32, grad=False):
    if a is None:
        return None
    return torch.from_numpy(a).to(dtype).requires_grad_(grad)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(
        np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                   np.float32),
        np.asarray(want, np.float32), atol=tol, rtol=tol, err_msg=what)


def _grads_both(q, k, v, bias, causal, do, dlse=None, dtype=np.float32):
    """(dq, dk, dv) of JAX's op and of the port's, for the cotangents do
    (and dlse: then through the with-lse forms)."""
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    if dlse is None:
        f = lambda q, k, v: jax_flash(q, k, v, _jax(bias), causal=causal)
        cts = _jax(do, jd)
    else:
        f = lambda q, k, v: jax_flash_lse(q, k, v, _jax(bias),
                                          causal=causal)
        cts = (_jax(do, jd), _jax(dlse))
    _, vjp = jax.vjp(f, _jax(q, jd), _jax(k, jd), _jax(v, jd))
    want = vjp(cts)
    tq, tk, tv = (_torch(a, td, grad=True) for a in (q, k, v))
    if dlse is None:
        o = att.flash_attention(tq, tk, tv, _torch(bias), causal)
        torch.autograd.backward(o, _torch(do, td))
    else:
        o, lse = att.flash_attention_with_lse(tq, tk, tv, _torch(bias),
                                              causal)
        torch.autograd.backward((o, lse), (_torch(do, td), _torch(dlse)))
    return want, (tq.grad, tk.grad, tv.grad)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_forward_and_lse_match_jax(causal, bias):
    q, k, v, b = _inputs(seed=1, bias=bias)
    want_o, want_lse = jax_flash_lse(_jax(q), _jax(k), _jax(v), _jax(b),
                                     causal=causal)
    got_o, got_lse = att.flash_attention_with_lse(
        _torch(q), _torch(k), _torch(v), _torch(b), causal)
    assert got_o.dtype == torch.float32 and got_o.shape == q.shape
    assert got_lse.dtype == torch.float32 and got_lse.shape == (2, 2, 256)
    _close(got_o, want_o, FWD_TOL, "o")
    _close(got_lse, want_lse, FWD_TOL, "lse")
    _close(att.flash_attention(_torch(q), _torch(k), _torch(v), _torch(b),
                               causal),
           jax_flash(_jax(q), _jax(k), _jax(v), _jax(b), causal=causal),
           FWD_TOL, "flash_attention")
    _close(att.attention_plain(_torch(q), _torch(k), _torch(v), _torch(b),
                               causal),
           attention_reference(_jax(q), _jax(k), _jax(v), _jax(b),
                               causal=causal), FWD_TOL, "attention_plain")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_grads_match_jax(causal, bias):
    q, k, v, b = _inputs(sq=128, sk=128, seed=2, bias=bias)
    do = np.random.RandomState(3).randn(*q.shape).astype(np.float32)
    want, got = _grads_both(q, k, v, b, causal, do)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, GRAD_TOL, f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_matches_jax(causal):
    q, k, v, _ = _inputs(sq=128, sk=128, seed=4)
    do = np.random.RandomState(5).randn(*q.shape).astype(np.float32)
    want_o = jax_flash(_jax(q, jnp.bfloat16), _jax(k, jnp.bfloat16),
                       _jax(v, jnp.bfloat16), causal=causal)
    got_o = att.flash_attention(_torch(q, torch.bfloat16),
                                _torch(k, torch.bfloat16),
                                _torch(v, torch.bfloat16), None, causal)
    assert got_o.dtype == torch.bfloat16
    _close(got_o, want_o.astype(jnp.float32), BF16_TOL, "o")
    want, got = _grads_both(q, k, v, None, causal, do, dtype="bf16")
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16
        _close(g, w.astype(jnp.float32), BF16_TOL, f"d{name}")


@pytest.mark.parametrize("causal,bias", [(True, False), (False, True)])
def test_tiled_plain_rounds_where_jax_kernel_rounds(causal, bias):
    """bf16 O of the kernels' arithmetic in plain PyTorch (128-key tiles,
    JAX's block at S = 384) against JAX's Pallas kernel: at most 1e-2 of
    its elements an ulp off (sums in another order), where the
    reference's arithmetic, which rounds the normalised P, moves ~half."""
    q, k, v, mask = _inputs(sq=384, sk=384, seed=7, bias=bias)
    want_o, want_lse = jax_flash_lse(
        *(_jax(a, jnp.bfloat16) for a in (q, k, v)), _jax(mask),
        causal=causal)
    want_o = torch.from_numpy(np.array(want_o.astype(jnp.float32)))
    tq, tk, tv = (_torch(a, torch.bfloat16) for a in (q, k, v))
    o, lse = att.attention_pair_tiled_plain(tq, tk, tv, _torch(mask),
                                            causal, tile=128)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(), want_o.numpy(),
                               rtol=1e-2, atol=1e-3)
    _close(lse, want_lse, FWD_TOL, "lse")
    assert float((o.float() != want_o).float().mean()) <= 1e-2
    ref = att.attention_pair_plain(tq, tk, tv, _torch(mask), causal)[0]
    assert float((ref.float() != want_o).float().mean()) > 0.2


@pytest.mark.parametrize("sq,sk", [(384, 384), (128, 384)])
def test_multiblock_and_rectangular_bottom_right_causal(sq, sk):
    """Several 128-row blocks on the JAX side; Sq < Sk puts the queries
    at the end (query i sees keys 0 .. i + Sk - Sq)."""
    q, k, v, _ = _inputs(b=1, sq=sq, sk=sk, seed=6)
    want_o = jax_flash(_jax(q), _jax(k), _jax(v), causal=True)
    got_o = att.flash_attention(_torch(q), _torch(k), _torch(v), None, True)
    _close(got_o, want_o, FWD_TOL, "o")
    do = np.random.RandomState(7).randn(*q.shape).astype(np.float32)
    want, got = _grads_both(q, k, v, None, True, do)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, 1e-4, f"d{name}")
    if sq < sk:      # the last query sees every key, the first Sk - Sq + 1
        free = q.copy()
        kk = k.copy()
        kk[:, sk - sq + 1:] += 1.0
        a = att.flash_attention(_torch(free), _torch(kk), _torch(v), None,
                                True)
        torch.testing.assert_close(a[:, 0], got_o[:, 0].detach())
        assert not torch.allclose(a[:, -1], got_o[:, -1].detach())


@pytest.mark.parametrize("causal", [False, True])
def test_ragged_length_matches_jax_reference_branch(causal):
    """S = 100 is no multiple of 128: JAX takes its XLA reference branch
    (``_kernel_ok``); the card's kernels take it with masked tail tiles."""
    q, k, v, b = _inputs(sq=100, sk=100, d=16, seed=8, bias=not causal)
    want_o, want_lse = jax_flash_lse(_jax(q), _jax(k), _jax(v), _jax(b),
                                     causal=causal)
    got_o, got_lse = att.flash_attention_with_lse(
        _torch(q), _torch(k), _torch(v), _torch(b), causal)
    _close(got_o, want_o, FWD_TOL, "o")
    _close(got_lse, want_lse, FWD_TOL, "lse")
    do = np.random.RandomState(9).randn(*q.shape).astype(np.float32)
    want, got = _grads_both(q, k, v, b, causal, do)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, GRAD_TOL, f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_lse_cotangent_folds_into_delta(causal):
    """A non-zero dlse (the ring combine differentiates through lse):
    Delta := rowsum(dO * O) - dlse in both."""
    q, k, v, _ = _inputs(b=1, sq=128, sk=128, seed=10)
    rs = np.random.RandomState(11)
    do = rs.randn(*q.shape).astype(np.float32)
    dlse = rs.randn(1, 2, 128).astype(np.float32)
    want, got = _grads_both(q, k, v, None, causal, do, dlse)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, GRAD_TOL, f"d{name}")
    # and it matters: without it the grads differ
    _, plain = _grads_both(q, k, v, None, causal, do)
    assert not np.allclose(plain[0].numpy(), got[0].numpy(), atol=1e-3)


def test_bias_gets_no_gradient():
    q, k, v, b = _inputs(b=2, sq=128, sk=128, seed=12, bias=True)
    jg = jax.grad(lambda bb: jnp.sum(jax_flash(
        _jax(q), _jax(k), _jax(v), bb) ** 2))(_jax(b))
    assert not np.any(np.asarray(jg))
    tb = _torch(b, grad=True)
    tq = _torch(q, grad=True)
    (att.flash_attention(tq, _torch(k), _torch(v), tb) ** 2).sum().backward()
    assert tb.grad is None and tq.grad is not None


def test_fully_masked_row_matches_jax():
    """Every key of row 1 at -1e9: a uniform average of the values, as in
    JAX (its softmax over equal logits)."""
    q, k, v, _ = _inputs(b=2, sq=128, sk=128, seed=13)
    b = np.zeros((2, 128), np.float32)
    b[1] = -1e9
    want = jax_flash(_jax(q), _jax(k), _jax(v), _jax(b))
    got = att.flash_attention(_torch(q), _torch(k), _torch(v), _torch(b))
    _close(got, want, FWD_TOL, "o")
    np.testing.assert_allclose(got[1].numpy(),
                               np.broadcast_to(v[1].mean(0), got[1].shape),
                               atol=1e-5)


def test_causal_with_more_queries_than_keys_is_refused():
    q, k, v, _ = _inputs(sq=256, sk=128, seed=14)
    with pytest.raises(ValueError, match="Sq <= Sk"):
        jax_flash(_jax(q), _jax(k), _jax(v), causal=True)
    with pytest.raises(ValueError, match="Sq <= Sk"):
        att.flash_attention(_torch(q), _torch(k), _torch(v), causal=True)


def test_plain_backward_is_the_gradient_of_the_plain_pair():
    """The kernels' equations, in fp64, equal autograd through
    ``attention_pair_plain`` with both cotangents (bias and a causal
    rectangle included)."""
    q, k, v, b = _inputs(b=2, sq=24, sk=40, d=8, seed=15, bias=True)
    t = [torch.from_numpy(a).double().requires_grad_() for a in (q, k, v)]
    rs = np.random.RandomState(16)
    do = torch.from_numpy(rs.randn(*q.shape))
    dlse = torch.from_numpy(rs.randn(2, 2, 24))
    bias = torch.from_numpy(b).double()
    o, lse = att.attention_pair_plain(*t, bias, True)
    want = torch.autograd.grad((o * do).sum() + (lse * dlse).sum(), t)
    got = att.attention_bwd_plain(*(x.detach() for x in t), bias, True,
                                  8 ** -0.5, o.detach(), lse.detach(), do,
                                  dlse)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


QKV = (_meta(2, 64, 4, 64), _meta(2, 64, 4, 64), _meta(2, 64, 4, 64))


def test_wrapper_limits_are_the_kernel_sources():
    """MAX_D and TILE, which the wrappers check before a build, are the
    kMaxD and kTile that csrc/attention.cu compiles with; and the
    tensor-core forward's key tile kTcKeys is TILE too, the tile to whose
    rounding ``attention_pair_tiled_plain`` holds a half O."""
    src = pathlib.Path(att.__file__).parent.parent / "csrc" / "attention.cu"
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);",
                             src.read_text()))
    assert int(consts["kMaxD"]) == att.MAX_D
    assert int(consts["kTile"]) == att.TILE
    assert int(consts["kTcKeys"]) == att.TILE


@pytest.mark.parametrize("args,kw,err,match", [
    ((_meta(2, 64, 4, 64, dtype=torch.float64),) * 3, {}, TypeError,
     "float32"),
    ((_meta(2, 64, 256), _meta(2, 64, 256), _meta(2, 64, 256)), {},
     ValueError, "B, S, H, D"),
    ((QKV[0], _meta(2, 64, 4, 32), QKV[2]), {}, ValueError, "k and v"),
    ((QKV[0], QKV[1], _meta(2, 64, 4, 64, dtype=torch.bfloat16)), {},
     ValueError, "k and v"),
    ((_meta(2, 64, 4, 60),) * 3, {}, ValueError, "multiple of 8"),
    ((_meta(2, 64, 4, 256),) * 3, {}, ValueError, "multiple of 8"),
    ((_meta(2, 128, 4, 64), QKV[1], QKV[2]), {"causal": True}, ValueError,
     "Sq <= Sk"),
    (QKV, {"bias": _meta(2, 32)}, ValueError, "bias must be"),
    (QKV, {"bias": _meta(2, 64, dtype=torch.bfloat16)}, ValueError,
     "bias must be"),
    (QKV, {}, ValueError, "CUDA"),                  # meta: not CUDA
])
def test_cuda_wrapper_raises_on_what_it_cannot_take(monkeypatch, args, kw,
                                                    err, match):
    def no_build(name):
        raise AssertionError(f"argument checks must raise before {name} "
                             "is built")
    monkeypatch.setattr(_build, "load", no_build)
    before = att.flash_attention_cuda.launches
    with pytest.raises(err, match=match):
        att.flash_attention_cuda(*args, **kw)
    assert att.flash_attention_cuda.launches == before


@pytest.mark.parametrize("wrapper", ["flash_attention_cuda",
                                     "flash_attention_dkdv_cuda",
                                     "flash_attention_dq_cuda"])
def test_wrappers_take_any_strides_up_to_the_device_check(monkeypatch,
                                                          wrapper):
    """bf16 q, k, v and dO whose head dim is not contiguous (every second
    element of a wider tensor), as the kernels took them before the
    tensor-core forward: each wrapper passes every argument check and
    raises only at the last, the device check."""
    monkeypatch.setattr(_build, "load", lambda name: None)
    q, k, v, do = (_meta(2, 64, 4, 128, dtype=torch.bfloat16)[..., ::2]
                   for _ in range(4))
    assert q.stride(-1) == 2 and not q.is_contiguous()
    rows = _meta(2, 4, 64)
    fn = getattr(att, wrapper)
    args = (q, k, v, None, True, 0.125) + (
        () if wrapper == "flash_attention_cuda" else (do, rows, rows))
    before = fn.launches
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        fn(*args)
    assert fn.launches == before


def test_backward_wrappers_check_their_row_tensors(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: None)
    q, k, v = QKV
    good = _meta(2, 4, 64)
    for fn in (att.flash_attention_dkdv_cuda, att.flash_attention_dq_cuda):
        with pytest.raises(ValueError, match="do must match"):
            fn(q, k, v, None, False, 0.125, _meta(2, 64, 4, 32), good, good)
        with pytest.raises(ValueError, match="lse must be"):
            fn(q, k, v, None, False, 0.125, q, _meta(2, 64, 4), good)
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, k, v, None, False, 0.125, q, good, good)


def test_dispatch_raises_instead_of_falling_back(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel's wrapper, which
    raises: the plain version is never a quiet stand-in."""
    def no_plain(*a, **k):
        raise AssertionError("plain version ran for a non-CPU tensor")
    monkeypatch.setattr(att, "attention_pair_plain", no_plain)
    monkeypatch.setattr(att, "attention_bwd_plain", no_plain)
    with pytest.raises(ValueError, match="CUDA"):
        att.flash_attention(*QKV)


def _fake_kernels(monkeypatch, calls):
    """The three wrappers replaced by shape-true stand-ins on meta
    tensors, recording what they were given."""
    def fwd(q, k, v, bias, causal, scale):
        calls.append(("fwd", torch.is_grad_enabled(), causal))
        b, sq, h, _ = q.shape
        return (torch.empty_like(q), torch.empty(b, h, sq, device=q.device))

    def dkdv(q, k, v, bias, causal, scale, do, lse, dl):
        calls.append(("dkdv", tuple(dl.shape)))
        return torch.empty_like(k), torch.empty_like(v)

    def dq(q, k, v, bias, causal, scale, do, lse, dl):
        calls.append(("dq", tuple(do.shape)))
        return torch.empty_like(q)

    monkeypatch.setattr(att, "flash_attention_cuda", fwd)
    monkeypatch.setattr(att, "flash_attention_dkdv_cuda", dkdv)
    monkeypatch.setattr(att, "flash_attention_dq_cuda", dq)


def test_card_route_output_carries_the_gradient(monkeypatch):
    """A bare ctypes launch leaves no grad_fn (the LayerNorm fault of the
    first slice): through FlashAttentionFunction the card's output carries
    one, and its backward runs the dK/dV and the dQ kernels once each."""
    calls = []
    _fake_kernels(monkeypatch, calls)
    q, k, v = (_meta(2, 64, 4, 64).requires_grad_() for _ in range(3))
    o = att.flash_attention(q, k, v, causal=True)
    assert o.requires_grad and o.grad_fn is not None
    assert o.shape == q.shape
    o.sum().backward()
    assert calls == [("fwd", False, True), ("dkdv", (2, 4, 64)),
                     ("dq", (2, 64, 4, 64))]
    for t in (q, k, v):
        assert t.grad is not None and t.grad.shape == t.shape


def test_no_grad_route_launches_no_backward(monkeypatch):
    calls = []
    _fake_kernels(monkeypatch, calls)
    with torch.no_grad():
        o = att.flash_attention(*QKV)
    assert not o.requires_grad
    assert calls == [("fwd", False, False)]
