"""The port's RMSNorm, and its completed normalization module, held
against the JAX package's.

``rms_norm_plain`` (what a CPU tensor runs, and what the CUDA kernel is
compared with on the card) against the JAX ``rms_norm`` — the Pallas
``_rms_fwd_kernel`` through the interpreter, as tests/conftest.py sets it
up — and against ``rms_norm_reference``; rstd against ``_rms_norm_fwd``.
The backward: ``RMSNormFunction`` on the CPU (``rms_norm_bwd_plain``)
against ``jax.vjp`` of the JAX ``rms_norm``, whose backward runs the
Pallas ``_rms_bwd_kernel`` through the interpreter.  Inputs come from
numpy with a fixed seed and go to both sides.

Tolerances (those of tests/test_torch_layer_norm.py):
- fp32 y, rstd and dx: rtol = atol = 1e-5 (both sides compute in fp32;
  only the summation order differs);
- bf16 y and dx: one bf16 ulp of the larger magnitude plus 1e-5 (the fp32
  value before the final rounding may differ in its last bits and round
  the other way; near zero the fp32 error of a cancelling step is larger
  than the ulp);
- fp32 dgamma (and the LayerNorm module's dbeta): rtol = atol = 1e-4 (sums
  over the rows in another order, of O(1) terms that cancel near zero);
- a bf16 dgamma or dbeta (``param_dtype`` bf16): one bf16 ulp plus 1e-4
  (the fp32 sums, within 1e-4 of each other, are rounded once to bf16 and
  may straddle a rounding boundary).

The modules: ``FusedRMSNorm`` with and without ``use_scale``, with
``dtype`` given, ``MixedFusedRMSNorm`` with bf16 ``param_dtype``, and
``FusedLayerNorm`` with ``use_bias=False``, ``use_scale=False`` and bf16
``param_dtype``, each against the flax module with the same parameters
(through ``convert.norm_params_from_flax``): y, dx and each parameter's
gradient in its own dtype.

The CUDA wrappers' argument checks run here on meta tensors: they must
raise, never hand a tensor to the plain version, and build nothing.  On
the card's route (meta tensors standing in for CUDA ones, the kernels
faked) the output carries a ``grad_fn``, the backward reaches x and gamma,
the kernels see fp32 gamma and dgamma comes back in gamma's dtype.  The
kernels themselves run only on the card: tests/test_torch_cuda.py and
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_example_tpu import normalization as jax_norm
from apex_example_tpu.ops.layer_norm import (_rms_norm_fwd,
                                             rms_norm as jax_rms_norm,
                                             rms_norm_reference)
from apex_example_tpu_torch import normalization as port_norm
from apex_example_tpu_torch.convert import norm_params_from_flax
from apex_example_tpu_torch.ops import _build
from apex_example_tpu_torch.ops import layer_norm as port_ln

FP32_TOL = 1e-5
SUM_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several workers share one host: these tiny shapes gain nothing from
    intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(n, h, seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(n, h) * 2.0 + 0.5).astype(np.float32)
    g = (rs.randn(h) * 0.2 + 1.0).astype(np.float32)
    dy = rs.randn(n, h).astype(np.float32)
    return x, g, dy


def _bf16_round(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _bf16_tol(a, b, atol=FP32_TOL):
    """One bf16 ulp at the larger magnitude of each pair (8 bits of
    significand: ulp = 2**(exponent - 7)), plus ``atol``."""
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7) + atol


def _np(t):
    """A torch or jax array as fp32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.astype(jnp.float32))


def _assert_close(got, want, dtype, tol=FP32_TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype in ("float32", torch.float32, jnp.float32):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        assert np.all(np.abs(got - want) <= _bf16_tol(got, want, tol))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [64, 410, 768])
@pytest.mark.parametrize("n", [16, 37])
def test_plain_matches_jax_kernel_and_reference(dtype, h, n):
    x, g, _ = _inputs(n, h, seed=h + n)
    if dtype == "bfloat16":
        x = _bf16_round(x)          # exactly representable on both sides
    jx, jg = jnp.asarray(x).astype(dtype), jnp.asarray(g)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    y_kernel = jax_rms_norm(jx, jg)
    y_ref = rms_norm_reference(jx, jg)
    _, rstd_j = _rms_norm_fwd(jx, jg, 1e-5)
    y, rstd = port_ln.rms_norm_plain(tx, torch.from_numpy(g))
    assert y.dtype == tx.dtype and y.shape == (n, h)
    assert rstd.dtype == torch.float32 and rstd.shape == (n,)
    for want in (y_kernel, y_ref):
        _assert_close(y, want, dtype)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(rstd_j),
                               rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
def test_eps_where_it_counts(eps):
    """Rows with mean(x²) near eps, where eps moves y by ~half: forward
    and backward against JAX's at the given eps."""
    x, g, dy = _inputs(16, 64, seed=6)
    x = x * 1e-3
    _, vjp = jax.vjp(lambda a, c: jax_rms_norm(a, c, eps), jnp.asarray(x),
                     jnp.asarray(g))
    want_y = jax_rms_norm(jnp.asarray(x), jnp.asarray(g), eps)
    want_dx, want_dg = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_()
    tg = torch.from_numpy(g).requires_grad_()
    y = port_ln.rms_norm(tx, tg, eps)
    y.backward(torch.from_numpy(dy))
    _assert_close(y, want_y, "float32")
    _assert_close(tx.grad, want_dx, "float32", tol=SUM_TOL)
    _assert_close(tg.grad, want_dg, "float32", tol=SUM_TOL)


def test_rms_norm_fwd_keeps_shape_and_flattens_rstd():
    x, g, _ = _inputs(6, 64, seed=1)
    x3 = torch.from_numpy(x).reshape(2, 3, 64)
    y, rstd = port_ln.rms_norm_fwd(x3, torch.from_numpy(g))
    assert y.shape == (2, 3, 64) and rstd.shape == (6,)
    want = jax_rms_norm(jnp.asarray(x.reshape(2, 3, 64)), jnp.asarray(g))
    _assert_close(y, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [64, 410, 768])
@pytest.mark.parametrize("n", [16, 37])
def test_backward_matches_jax_vjp(dtype, h, n):
    x, g, dy = _inputs(n, h, seed=3 * h + n)
    if dtype == "bfloat16":
        x, dy = _bf16_round(x), _bf16_round(dy)
    jx, jdy = (jnp.asarray(a).astype(dtype) for a in (x, dy))
    _, vjp = jax.vjp(jax_rms_norm, jx, jnp.asarray(g))
    want_dx, want_dg = vjp(jdy)

    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    tg = torch.from_numpy(g).requires_grad_()
    y = port_ln.rms_norm(tx, tg)
    assert y.grad_fn is not None
    y.backward(torch.from_numpy(dy).to(tx.dtype))
    assert tx.grad.dtype == tx.dtype and tg.grad.dtype == torch.float32
    _assert_close(tx.grad, want_dx, dtype)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(want_dg),
                               rtol=SUM_TOL, atol=SUM_TOL)


def test_backward_keeps_shape_through_3d_input():
    x, g, _ = _inputs(6, 64, seed=2)
    tx = torch.from_numpy(x).reshape(2, 3, 64).requires_grad_()
    tg = torch.from_numpy(g).requires_grad_()
    (port_ln.rms_norm(tx, tg) ** 2).sum().backward()
    _, vjp = jax.vjp(lambda a, c: (jax_rms_norm(a, c) ** 2).sum(),
                     jnp.asarray(x.reshape(2, 3, 64)), jnp.asarray(g))
    for got, want in zip((tx.grad, tg.grad), vjp(1.0)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=SUM_TOL, atol=SUM_TOL)


def test_gradcheck_plain_function_in_float64():
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(5, 12)).requires_grad_()
    g = torch.from_numpy(rs.randn(12) * 0.3 + 1).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, c: port_ln.RMSNormFunction.apply(a, c, 1e-5),
        (x, g), eps=1e-6, atol=1e-5, rtol=1e-4)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _no_build(monkeypatch):
    def no_build(name):
        raise AssertionError(f"argument checks must raise before {name} "
                             "is built")
    monkeypatch.setattr(_build, "load", no_build)


@pytest.mark.parametrize("args,err,match", [
    ((_meta(8, 64, dtype=torch.float64), _meta(64)), TypeError, "float32"),
    ((_meta(2, 4, 64), _meta(64)), ValueError, r"\(N, H\)"),
    ((_meta(64, 8).t(), _meta(64)), ValueError, "contiguous"),
    ((_meta(8, 64), _meta(32)), ValueError, "gamma must be"),
    ((_meta(8, 64), _meta(64, dtype=torch.bfloat16)), ValueError,
     "gamma must be"),
    ((_meta(8, 64), _meta(128)[::2]), ValueError, "contiguous"),
    ((_meta(8, port_ln.MAX_H + 1), _meta(port_ln.MAX_H + 1)), ValueError,
     "H <="),
    ((_meta(8, 64), _meta(64)), ValueError, "CUDA"),        # not CUDA
])
def test_cuda_wrapper_raises_on_what_it_cannot_take(monkeypatch, args, err,
                                                    match):
    _no_build(monkeypatch)
    before = port_ln.rms_norm_cuda.launches
    with pytest.raises(err, match=match):
        port_ln.rms_norm_cuda(*args)
    assert port_ln.rms_norm_cuda.launches == before


@pytest.mark.parametrize("args,err,match", [
    ((_meta(8, 64, dtype=torch.float64), _meta(64), _meta(8),
      _meta(8, 64, dtype=torch.float64)), TypeError, "float32"),
    ((_meta(8, 64), _meta(64), _meta(8), _meta(8, 64, dtype=torch.bfloat16)),
     ValueError, "dy must match"),
    ((_meta(8, 64), _meta(64), _meta(8), _meta(8, 32)), ValueError,
     "dy must match"),
    ((_meta(8, 64), _meta(64), _meta(7), _meta(8, 64)), ValueError,
     "rstd must be"),
    ((_meta(8, 64), _meta(64), _meta(8, dtype=torch.float16), _meta(8, 64)),
     ValueError, "rstd must be"),
    ((_meta(8, 64), _meta(64), _meta(8), _meta(64, 8).t()), ValueError,
     "contiguous"),
    ((_meta(8, 64), _meta(32), _meta(8), _meta(8, 64)), ValueError,
     "gamma must be"),
    ((_meta(8, port_ln.MAX_H + 1), _meta(port_ln.MAX_H + 1), _meta(8),
      _meta(8, port_ln.MAX_H + 1)), ValueError, "H <="),
    ((_meta(8, 64), _meta(64), _meta(8), _meta(8, 64)), ValueError, "CUDA"),
])
def test_bwd_wrapper_raises_on_what_it_cannot_take(monkeypatch, args, err,
                                                   match):
    _no_build(monkeypatch)
    before = port_ln.rms_norm_bwd_cuda.launches
    with pytest.raises(err, match=match):
        port_ln.rms_norm_bwd_cuda(*args)
    assert port_ln.rms_norm_bwd_cuda.launches == before


def test_dispatch_raises_instead_of_falling_back(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel's wrapper, which
    raises: the plain version is never a quiet stand-in."""
    def no_plain(*a, **k):
        raise AssertionError("plain version ran for a non-CPU tensor")
    monkeypatch.setattr(port_ln, "rms_norm_plain", no_plain)
    monkeypatch.setattr(port_ln, "rms_norm_bwd_plain", no_plain)
    with pytest.raises(ValueError, match="CUDA"):
        port_ln.rms_norm_fwd(_meta(4, 64), _meta(64))
    with pytest.raises(ValueError, match="CUDA"):
        port_ln.rms_norm_bwd(_meta(4, 64), _meta(64), _meta(4), _meta(4, 64))


def _fake_kernels(monkeypatch, calls):
    """Meta-tensor stand-ins for the two kernel wrappers: what the card's
    route returns, without a card.  Each records the gamma dtype it got."""
    def fwd(x, g, eps=1e-5):
        calls.append(("fwd", torch.is_grad_enabled(), g.dtype))
        return torch.empty_like(x), torch.empty(x.shape[0], device=x.device)

    def bwd(x, g, rstd, dy):
        calls.append(("bwd", x.shape, g.dtype))
        return torch.empty_like(x), torch.empty(g.shape, device=x.device)
    monkeypatch.setattr(port_ln, "rms_norm_cuda", fwd)
    monkeypatch.setattr(port_ln, "rms_norm_bwd_cuda", bwd)


def test_card_route_output_carries_the_gradient(monkeypatch):
    """The fault once repaired for LayerNorm, held for RMSNorm: a ctypes
    launch leaves no grad_fn; through RMSNormFunction the gradient reaches
    x and gamma."""
    calls = []
    _fake_kernels(monkeypatch, calls)
    x = _meta(2, 3, 64).requires_grad_()
    g = _meta(64).requires_grad_()
    y = port_ln.rms_norm(x, g)
    assert y.requires_grad and y.grad_fn is not None
    assert y.shape == x.shape
    y.sum().backward()
    assert calls == [("fwd", False, torch.float32),
                     ("bwd", (6, 64), torch.float32)]
    for t in (x, g):
        assert t.grad is not None and t.grad.shape == t.shape


def test_no_grad_route_launches_no_backward(monkeypatch):
    calls = []
    _fake_kernels(monkeypatch, calls)
    with torch.no_grad():
        y = port_ln.rms_norm(_meta(4, 64), _meta(64))
    assert not y.requires_grad
    assert calls == [("fwd", False, torch.float32)]


@pytest.mark.parametrize("param_dtype", [torch.bfloat16, torch.float16])
def test_card_route_reads_half_gamma_as_fp32(monkeypatch, param_dtype):
    """JAX's ops take a gamma of any float dtype and return dgamma in it;
    the kernels take fp32 gamma: the dispatchers cast gamma (and beta) to
    fp32 on the way in and the gradients back on the way out."""
    calls = []
    _fake_kernels(monkeypatch, calls)
    x = _meta(4, 64).requires_grad_()
    g = _meta(64, dtype=param_dtype).requires_grad_()
    port_ln.rms_norm(x, g).sum().backward()
    assert [c[-1] for c in calls] == [torch.float32, torch.float32]
    assert g.grad.dtype == param_dtype

    seen = []

    def ln_fwd(x, g, b, eps=1e-5):
        seen.append((g.dtype, b.dtype))
        n = x.shape[0]
        return (torch.empty_like(x), torch.empty(n, device=x.device),
                torch.empty(n, device=x.device))

    def ln_bwd(x, g, mean, rstd, dy):
        seen.append((g.dtype,))
        h = g.shape
        return (torch.empty_like(x), torch.empty(h, device=x.device),
                torch.empty(h, device=x.device))
    monkeypatch.setattr(port_ln, "layer_norm_cuda", ln_fwd)
    monkeypatch.setattr(port_ln, "layer_norm_bwd_cuda", ln_bwd)
    b = _meta(64, dtype=param_dtype).requires_grad_()
    port_ln.layer_norm(x, g, b).sum().backward()
    assert seen == [(torch.float32, torch.float32), (torch.float32,)]
    assert b.grad.dtype == param_dtype


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
def test_backward_returns_param_grads_in_their_dtype(param_dtype):
    """dgamma (and dbeta) in gamma's dtype straight from the backward
    functions, as JAX's ops return them, and equal to the fp32 sums
    rounded once (autograd would cast a wrong dtype back silently)."""
    x, g, dy = (torch.from_numpy(a) for a in _inputs(8, 64, seed=4))
    gh = g.to(param_dtype)
    _, rstd = port_ln.rms_norm_fwd(x, gh)
    _, dg = port_ln.rms_norm_bwd(x, gh, rstd, dy)
    _, dg32 = port_ln.rms_norm_bwd_plain(x, gh.float(), rstd, dy)
    assert dg.dtype == param_dtype
    assert torch.equal(dg, dg32.to(param_dtype))
    _, mean, rstd = port_ln.layer_norm_fwd(x, gh, gh)
    _, dg, db = port_ln.layer_norm_bwd(x, gh, mean, rstd, dy)
    _, dg32, db32 = port_ln.layer_norm_bwd_plain(x, gh.float(), mean, rstd,
                                                 dy)
    assert dg.dtype == db.dtype == param_dtype
    assert torch.equal(dg, dg32.to(param_dtype))
    assert torch.equal(db, db32.to(param_dtype))


# --------------------------------------------------------------------------
# The modules against flax's.
# --------------------------------------------------------------------------

_JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _flax_variables(leaves, h, seed, param_dtype):
    """Random flax params for the named leaves, as the module stores
    them: numpy leaves in ``param_dtype``."""
    rs = np.random.RandomState(seed)
    init = {"scale": rs.randn(h) * 0.2 + 1.0, "bias": rs.randn(h) * 0.2}
    jdt = _JAX_DTYPES[param_dtype]
    return {"params": {k: np.asarray(jnp.asarray(init[k], jnp.float32)
                                     .astype(jdt)) for k in leaves}}


def _against_flax(flax_module, port_module, variables, x_dtype, n=37,
                  h=768, seed=0):
    """Forward and backward of both modules with the same parameters and
    inputs; returns (y, want_y), (dx, want_dx) and [(grad, want_grad)] per
    parameter leaf."""
    port_module.load_state_dict(norm_params_from_flax(variables))
    assert (sorted(k for k, _ in port_module.named_parameters())
            == sorted(variables["params"]))
    x, _, dy = _inputs(n, h, seed)
    if x_dtype == torch.bfloat16:
        x, dy = _bf16_round(x), _bf16_round(dy)
    jdt = _JAX_DTYPES[x_dtype]
    params = {k: jnp.asarray(v) for k, v in variables["params"].items()}
    want_y, vjp = jax.vjp(
        lambda a, p: flax_module.apply({"params": p}, a),
        jnp.asarray(x).astype(jdt), params)
    tx = torch.from_numpy(x).to(x_dtype).requires_grad_()
    y = port_module(tx)
    assert str(y.dtype)[6:] == str(want_y.dtype)
    want_dx, want_dp = vjp(jnp.asarray(dy).astype(want_y.dtype))
    y.backward(torch.from_numpy(dy).to(y.dtype))
    assert tx.grad.dtype == x_dtype
    grads = []
    for name, p in port_module.named_parameters():
        assert p.grad.dtype == p.dtype
        assert str(p.dtype)[6:] == str(want_dp[name].dtype)
        grads.append((name, p.grad, want_dp[name]))
    return (y, want_y), (tx.grad, want_dx), grads


def _check(pair, dtype, tol=FP32_TOL):
    got, want = pair
    _assert_close(got, want, dtype, tol)


def _check_grads(grads):
    for _, got, want in grads:
        _check((got, want), got.dtype, SUM_TOL)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_scale", [True, False])
def test_fused_rms_norm_matches_flax(x_dtype, use_scale):
    variables = _flax_variables(["scale"] if use_scale else [], 768, 11,
                                torch.float32)
    flax_m = jax_norm.FusedRMSNorm(use_scale=use_scale)
    port_m = port_norm.FusedRMSNorm(768, use_scale=use_scale)
    if not use_scale:
        assert "scale" not in port_m.state_dict()
        assert flax_m.init(jax.random.PRNGKey(0),
                           jnp.ones((2, 768))).get("params", {}) == {}
    y, dx, grads = _against_flax(flax_m, port_m, variables, x_dtype)
    _check(y, x_dtype)
    _check(dx, x_dtype)
    assert len(grads) == int(use_scale)
    _check_grads(grads)


def test_fused_rms_norm_casts_output_to_dtype():
    variables = _flax_variables(["scale"], 768, 12, torch.float32)
    flax_m = jax_norm.FusedRMSNorm(dtype=jnp.bfloat16)
    port_m = port_norm.FusedRMSNorm(768, dtype=torch.bfloat16)
    y, dx, grads = _against_flax(flax_m, port_m, variables, torch.float32)
    assert y[0].dtype == torch.bfloat16
    _check(y, torch.bfloat16)
    _check(dx, torch.float32)
    _check_grads(grads)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_mixed_fused_rms_norm_with_bf16_params_matches_flax(x_dtype):
    """y, dx and dscale in bf16 (dscale summed in fp32, rounded once)."""
    assert port_norm.MixedFusedRMSNorm is port_norm.FusedRMSNorm
    variables = _flax_variables(["scale"], 768, 13, torch.bfloat16)
    flax_m = jax_norm.MixedFusedRMSNorm(param_dtype=jnp.bfloat16)
    port_m = port_norm.MixedFusedRMSNorm(768, param_dtype=torch.bfloat16)
    assert port_m.scale.dtype == torch.bfloat16
    y, dx, grads = _against_flax(flax_m, port_m, variables, x_dtype)
    _check(y, x_dtype)
    _check(dx, x_dtype)
    assert [g.dtype for _, g, _ in grads] == [torch.bfloat16]
    _check_grads(grads)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("options", [
    dict(use_bias=False), dict(use_scale=False),
    dict(use_bias=False, use_scale=False),
    dict(param_dtype="bfloat16"),
    dict(param_dtype="bfloat16", use_bias=False)])
def test_fused_layer_norm_options_match_flax(x_dtype, options):
    param_dtype = getattr(torch, options.get("param_dtype", "float32"))
    use_scale = options.get("use_scale", True)
    use_bias = options.get("use_bias", True)
    leaves = [k for k, on in (("scale", use_scale), ("bias", use_bias)) if on]
    variables = _flax_variables(leaves, 768, 14, param_dtype)
    flax_m = jax_norm.FusedLayerNorm(param_dtype=_JAX_DTYPES[param_dtype],
                                     use_bias=use_bias, use_scale=use_scale)
    port_m = port_norm.MixedFusedLayerNorm(
        768, param_dtype=param_dtype, use_bias=use_bias, use_scale=use_scale)
    assert sorted(port_m.state_dict()) == sorted(leaves)
    y, dx, grads = _against_flax(flax_m, port_m, variables, x_dtype)
    _check(y, x_dtype)
    _check(dx, x_dtype)
    assert [g.dtype for _, g, _ in grads] == [param_dtype] * len(leaves)
    _check_grads(grads)


def test_fused_layer_norm_keeps_its_signature_and_defaults():
    """The models build FusedLayerNorm(hidden, eps, dtype, device): fp32
    scale and bias parameters, the keys the model converters fill."""
    m = port_norm.FusedLayerNorm(64, 1e-6, torch.bfloat16, "cpu")
    assert m.eps == 1e-6 and m.dtype == torch.bfloat16
    assert {k: (tuple(v.shape), v.dtype) for k, v in m.state_dict().items()} \
        == {"scale": ((64,), torch.float32), "bias": ((64,), torch.float32)}
    assert port_norm.MixedFusedLayerNorm is port_norm.FusedLayerNorm


def test_norm_params_from_flax_keeps_the_stored_dtype():
    variables = _flax_variables(["scale", "bias"], 16, 15, torch.bfloat16)
    sd = norm_params_from_flax(variables)
    assert {k: v.dtype for k, v in sd.items()} == {
        "scale": torch.bfloat16, "bias": torch.bfloat16}
    for k, v in sd.items():
        np.testing.assert_array_equal(
            v.float().numpy(), variables["params"][k].astype(np.float32))
    assert norm_params_from_flax({"params": {}}) == {}
    assert set(norm_params_from_flax(variables["params"])) == {"scale",
                                                              "bias"}
