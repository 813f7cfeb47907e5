"""The port's LayerNorm forward held against the JAX package's.

``layer_norm_plain`` (what a CPU tensor runs, and what the CUDA kernel is
compared with on the card) against the JAX ``layer_norm`` — the Pallas
``_fwd_kernel`` through the interpreter, as tests/conftest.py sets it up —
and against ``layer_norm_reference``; mean and rstd against
``_layer_norm_fwd``.  Inputs come from numpy with a fixed seed and go to
both sides.  Tolerances: fp32 1e-5 (both sides compute in fp32; only the
summation order differs), bf16 one bf16 ulp of the output (the fp32 value
before the final rounding may differ in its last bits and round the other
way) plus 1e-5 (near zero the fp32 error of the cancelling affine step is
larger than a bf16 ulp).

The CUDA wrapper's argument checks run here on meta tensors: it must raise,
never hand a tensor to the plain version, and build nothing.  The kernel
itself runs only on the card: tests/test_torch_cuda.py and chip_smoke.py.

The backward: ``LayerNormFunction`` on the CPU (``layer_norm_bwd_plain``)
against ``jax.vjp`` of the JAX ``layer_norm``, whose backward runs the
Pallas ``_bwd_kernel`` through the interpreter.  Tolerances: dx fp32 1e-5;
dgamma and dbeta rtol 1e-4 with atol 1e-4 (sums over the rows in another
order, and sums of O(1) terms that cancel near zero); bf16 dx one bf16 ulp
plus 1e-5, as the forward.  ``gradcheck`` holds the plain backward against
finite differences in float64.  And the repaired fault: on the card's
route (meta tensors standing in for CUDA ones) the output carries a
``grad_fn``, and the backward reaches x, gamma and beta.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_example_tpu.ops.layer_norm import (_layer_norm_fwd,
                                             layer_norm as jax_layer_norm,
                                             layer_norm_reference)
from apex_example_tpu_torch.ops import _build
from apex_example_tpu_torch.ops import layer_norm as port_ln

FP32_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: these tiny shapes gain
    nothing from intra-op threads, and the JAX package's wall-clock tests
    running beside them lose from the contention."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(n, h, seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(n, h) * 2.0 + 0.5).astype(np.float32)
    g = (rs.randn(h) * 0.2 + 1.0).astype(np.float32)
    b = (rs.randn(h) * 0.2).astype(np.float32)
    return x, g, b


def _bf16_round(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _bf16_tol(a, b):
    """One bf16 ulp at the larger magnitude of each pair (8 bits of
    significand: ulp = 2**(exponent - 7)), plus the fp32 tolerance: where
    (x - mean) * rstd * gamma + beta cancels to near zero, its fp32
    rounding error (~1e-7 of the operands) is larger than that ulp."""
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7) + FP32_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [64, 128, 768])
@pytest.mark.parametrize("n", [16, 37])
def test_plain_matches_jax_kernel_and_reference(dtype, h, n):
    x, g, b = _inputs(n, h, seed=h + n)
    if dtype == "bfloat16":
        x = _bf16_round(x)          # exactly representable on both sides
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    y_kernel = jax_layer_norm(jx, jnp.asarray(g), jnp.asarray(b))
    y_ref = layer_norm_reference(jx, jnp.asarray(g), jnp.asarray(b))
    _, mean_j, rstd_j = _layer_norm_fwd(jx, jnp.asarray(g), jnp.asarray(b),
                                        1e-5)
    y, mean, rstd = port_ln.layer_norm_plain(tx, torch.from_numpy(g),
                                             torch.from_numpy(b))
    assert y.dtype == tx.dtype and y.shape == (n, h)
    assert mean.dtype == rstd.dtype == torch.float32
    y = y.float().numpy()
    for want in (y_kernel, y_ref):
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(y, want, rtol=FP32_TOL,
                                       atol=FP32_TOL)
        else:
            assert np.all(np.abs(y - want) <= _bf16_tol(y, want))
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j),
                               rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(rstd_j),
                               rtol=FP32_TOL, atol=FP32_TOL)


def test_layer_norm_fwd_keeps_shape_and_flattens_stats():
    x, g, b = _inputs(6, 64, seed=1)
    x3 = torch.from_numpy(x).reshape(2, 3, 64)
    y, mean, rstd = port_ln.layer_norm_fwd(x3, torch.from_numpy(g),
                                           torch.from_numpy(b))
    assert y.shape == (2, 3, 64) and mean.shape == rstd.shape == (6,)
    want = jax_layer_norm(jnp.asarray(x.reshape(2, 3, 64)),
                          jnp.asarray(g), jnp.asarray(b))
    np.testing.assert_allclose(y.numpy(), np.asarray(want),
                               rtol=FP32_TOL, atol=FP32_TOL)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("args,err", [
    ((_meta(8, 64, dtype=torch.float64), _meta(64), _meta(64)), TypeError),
    ((_meta(2, 4, 64), _meta(64), _meta(64)), ValueError),
    ((_meta(64, 8).t(), _meta(64), _meta(64)), ValueError),
    ((_meta(8, 64), _meta(32), _meta(64)), ValueError),
    ((_meta(8, 64), _meta(64), _meta(64, dtype=torch.bfloat16)),
     ValueError),
    ((_meta(8, port_ln.MAX_H + 1), _meta(port_ln.MAX_H + 1),
      _meta(port_ln.MAX_H + 1)), ValueError),
    ((_meta(8, 64), _meta(64), _meta(64)), ValueError),     # not CUDA
])
def test_cuda_wrapper_raises_on_what_it_cannot_take(monkeypatch, args, err):
    def no_build(name):
        raise AssertionError(f"argument checks must raise before {name} "
                             "is built")
    monkeypatch.setattr(_build, "load", no_build)
    before = port_ln.layer_norm_cuda.launches
    with pytest.raises(err):
        port_ln.layer_norm_cuda(*args)
    assert port_ln.layer_norm_cuda.launches == before


def test_dispatch_raises_instead_of_falling_back(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel's wrapper, which
    raises: the plain version is never a quiet stand-in."""
    def no_plain(*a, **k):
        raise AssertionError("plain version ran for a non-CPU tensor")
    monkeypatch.setattr(port_ln, "layer_norm_plain", no_plain)
    with pytest.raises(ValueError, match="CUDA"):
        port_ln.layer_norm_fwd(_meta(4, 64), _meta(64), _meta(64))


SUM_TOL = 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [64, 128, 768])
@pytest.mark.parametrize("n", [16, 37])
def test_backward_matches_jax_vjp(dtype, h, n):
    x, g, b = _inputs(n, h, seed=3 * h + n)
    dy = np.random.RandomState(h - n).randn(n, h).astype(np.float32)
    if dtype == "bfloat16":
        x, dy = _bf16_round(x), _bf16_round(dy)
    jx, jdy = (jnp.asarray(a).astype(dtype) for a in (x, dy))
    _, vjp = jax.vjp(jax_layer_norm, jx, jnp.asarray(g), jnp.asarray(b))
    want_dx, want_dg, want_db = vjp(jdy)

    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    tg = torch.from_numpy(g).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    y = port_ln.layer_norm(tx, tg, tb)
    assert y.grad_fn is not None
    y.backward(torch.from_numpy(dy).to(tx.dtype))
    assert tx.grad.dtype == tx.dtype and tg.grad.dtype == torch.float32
    dx = tx.grad.float().numpy()
    want_dx = np.asarray(want_dx.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(dx, want_dx, rtol=FP32_TOL, atol=FP32_TOL)
    else:
        assert np.all(np.abs(dx - want_dx) <= _bf16_tol(dx, want_dx))
    for got, want in ((tg.grad, want_dg), (tb.grad, want_db)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=SUM_TOL, atol=SUM_TOL)


def test_backward_keeps_shape_through_3d_input():
    x, g, b = _inputs(6, 64, seed=2)
    tx = torch.from_numpy(x).reshape(2, 3, 64).requires_grad_()
    tg = torch.from_numpy(g).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    (port_ln.layer_norm(tx, tg, tb) ** 2).sum().backward()
    _, vjp = jax.vjp(lambda a, c, d: (jax_layer_norm(a, c, d) ** 2).sum(),
                     jnp.asarray(x.reshape(2, 3, 64)), jnp.asarray(g),
                     jnp.asarray(b))
    for got, want in zip((tx.grad, tg.grad, tb.grad), vjp(1.0)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=SUM_TOL, atol=SUM_TOL)


def test_gradcheck_plain_function_in_float64():
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(5, 12)).requires_grad_()
    g = torch.from_numpy(rs.randn(12) * 0.3 + 1).requires_grad_()
    b = torch.from_numpy(rs.randn(12) * 0.3).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, c, d: port_ln.LayerNormFunction.apply(a, c, d, 1e-5),
        (x, g, b), eps=1e-6, atol=1e-5, rtol=1e-4)


def _fake_kernels(monkeypatch, calls):
    """Meta-tensor stand-ins for the two kernel wrappers: what the card's
    route returns, without a card."""
    def fwd(x, g, b, eps=1e-5):
        calls.append(("fwd", torch.is_grad_enabled()))
        n = x.shape[0]
        return (torch.empty_like(x), torch.empty(n, device=x.device),
                torch.empty(n, device=x.device))

    def bwd(x, g, mean, rstd, dy):
        calls.append(("bwd", x.shape))
        return (torch.empty_like(x), torch.empty_like(g),
                torch.empty_like(g))
    monkeypatch.setattr(port_ln, "layer_norm_cuda", fwd)
    monkeypatch.setattr(port_ln, "layer_norm_bwd_cuda", bwd)


def test_card_route_output_carries_the_gradient(monkeypatch):
    """The fault repaired: the kernel's output had no grad_fn, so
    gradients stopped at every LayerNorm on the card.  Through
    LayerNormFunction they reach x, gamma and beta."""
    calls = []
    _fake_kernels(monkeypatch, calls)
    x = _meta(2, 3, 64).requires_grad_()
    g = _meta(64).requires_grad_()
    b = _meta(64).requires_grad_()
    y = port_ln.layer_norm(x, g, b)
    assert y.requires_grad and y.grad_fn is not None
    assert y.shape == x.shape
    y.sum().backward()
    assert calls == [("fwd", False), ("bwd", (6, 64))]
    for t in (x, g, b):
        assert t.grad is not None and t.grad.shape == t.shape


def test_no_grad_serving_route_launches_no_backward(monkeypatch):
    calls = []
    _fake_kernels(monkeypatch, calls)
    with torch.no_grad():
        y = port_ln.layer_norm(_meta(4, 64), _meta(64), _meta(64))
    assert not y.requires_grad
    assert calls == [("fwd", False)]


@pytest.mark.parametrize("args,err,match", [
    ((_meta(8, 64, dtype=torch.float64), _meta(64), _meta(8), _meta(8),
      _meta(8, 64, dtype=torch.float64)), TypeError, "float32"),
    ((_meta(8, 64), _meta(64), _meta(8), _meta(8),
      _meta(8, 64, dtype=torch.bfloat16)), ValueError, "dy must match"),
    ((_meta(8, 64), _meta(64), _meta(8), _meta(8), _meta(8, 32)),
     ValueError, "dy must match"),
    ((_meta(8, 64), _meta(64), _meta(7), _meta(8), _meta(8, 64)),
     ValueError, "mean must be"),
    ((_meta(8, 64), _meta(64), _meta(8), _meta(8, dtype=torch.float16),
      _meta(8, 64)), ValueError, "rstd must be"),
    ((_meta(8, 64), _meta(64), _meta(8), _meta(8), _meta(64, 8).t()),
     ValueError, "contiguous"),
    ((_meta(8, 64), _meta(32), _meta(8), _meta(8), _meta(8, 64)),
     ValueError, "gamma must be"),
    ((_meta(8, 64), _meta(64), _meta(8), _meta(8), _meta(8, 64)),
     ValueError, "CUDA"),
])
def test_bwd_wrapper_raises_on_what_it_cannot_take(monkeypatch, args, err,
                                                   match):
    def no_build(name):
        raise AssertionError(f"argument checks must raise before {name} "
                             "is built")
    monkeypatch.setattr(_build, "load", no_build)
    before = port_ln.layer_norm_bwd_cuda.launches
    with pytest.raises(err, match=match):
        port_ln.layer_norm_bwd_cuda(*args)
    assert port_ln.layer_norm_bwd_cuda.launches == before


def test_bwd_dispatch_raises_instead_of_falling_back(monkeypatch):
    def no_plain(*a, **k):
        raise AssertionError("plain backward ran for a non-CPU tensor")
    monkeypatch.setattr(port_ln, "layer_norm_bwd_plain", no_plain)
    with pytest.raises(ValueError, match="CUDA"):
        port_ln.layer_norm_bwd(_meta(4, 64), _meta(64), _meta(4), _meta(4),
                               _meta(4, 64))


def _share(n, warps, w):
    """Rows [r0, r1) of warp ``w`` of ``warps``: the split of
    csrc/layer_norm.cu ``ln_bwd_persist_kernel``."""
    return w * n // warps, (w + 1) * n // warps


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n,h", [(257, 768), (1000, 768), (4096, 768),
                                 (6144, 410), (8192, 768), (16384, 768),
                                 (50001, 777), (10 ** 6, 64)])
def test_bwd_row_groups_cover_the_rows(n, h, sms):
    """The persistent grid (rows of up to BWD_WARP_H elements): at most
    ``sms * resident`` blocks, never more than give each warp a row;
    every row in exactly one warp's share, shares differing by one row at
    most; one workspace row a block, and the tree's rows for every
    BWD_TREE_GROUP blocks (the kernel's split itself is checked on the
    card, test_torch_cuda.py::test_norm_bwd_counts_every_row_once)."""
    for resident in (1, 2, 3, 8):
        geo = port_ln.bwd_geometry(n, h, sms, resident)
        assert geo.layout == port_ln.BWD_PERSIST
        assert 1 <= geo.blocks <= min(sms * resident,
                                      -(-n // port_ln.BWD_WARPS))
        assert geo.tree_rows == -(-geo.blocks // port_ln.BWD_TREE_GROUP)
        warps = geo.blocks * port_ln.BWD_WARPS
        shares = [_share(n, warps, w) for w in range(warps)]
        assert shares[0][0] == 0 and shares[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
        sizes = [r1 - r0 for r0, r1 in shares]
        assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 0


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n,h,layout", [
    (1, 768, port_ln.BWD_PERSIST), (37, 777, port_ln.BWD_PERSIST),
    (128, 768, port_ln.BWD_PERSIST), (256, 1024, port_ln.BWD_PERSIST),
    (257, 768, port_ln.BWD_PERSIST), (4096, 768, port_ln.BWD_PERSIST),
    (64, 8192, port_ln.BWD_WIDE), (4096, 1025, port_ln.BWD_WIDE)])
def test_bwd_few_rows_take_a_group_a_row(n, h, layout, sms):
    """Rows of up to BWD_WARP_H elements take the persistent grid; up to
    256 of them (a card holds 32 of its blocks at once) a warp a row:
    eight rows a block, one workspace row a block, so every row has its
    own warp and no block is empty.  Wider rows take blocks of 512
    threads, a row each up to BWD_FEW_ROWS rows, bwd_groups' above, one
    workspace row a block and no tree rows."""
    for resident in (1, 2, 8):
        geo = port_ln.bwd_geometry(n, h, sms, resident)
        assert geo.layout == layout
        if layout == port_ln.BWD_PERSIST and n <= 256:
            assert geo.blocks == -(-n // port_ln.BWD_WARPS)
            warps = geo.blocks * port_ln.BWD_WARPS
            assert n <= warps < n + port_ln.BWD_WARPS
            assert all(r1 - r0 <= 1 for r0, r1 in
                       (_share(n, warps, w) for w in range(warps)))
        elif layout == port_ln.BWD_WIDE:
            assert geo.blocks == (
                n if n <= port_ln.BWD_FEW_ROWS else port_ln.bwd_groups(n))
            assert 1 <= geo.blocks <= min(n, port_ln.BWD_MAX_GROUPS)
        assert geo.tree_rows == (0 if layout != port_ln.BWD_PERSIST else
                                 -(-geo.blocks // port_ln.BWD_TREE_GROUP))


@pytest.mark.parametrize("n,groups", [(1, 1), (4, 1), (5, 2),
                                      (4096, 1024), (10 ** 6, 1024)])
def test_bwd_groups_of_wide_rows(n, groups):
    """Wide rows past BWD_FEW_ROWS: a block for every BWD_ROWS_PER_GROUP
    rows, at most BWD_MAX_GROUPS blocks."""
    assert port_ln.bwd_groups(n) == groups
