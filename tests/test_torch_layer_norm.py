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
"""

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
