"""Kernels of the PyTorch port against their plain versions, on the card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips where
torch sees none.  The file imports no jax, so it runs on a machine that
has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up jax for the JAX package's
tests.)  Tolerances as in chip_smoke.py: fp32 1e-5; bf16 one bf16 ulp of
the output plus 1e-5, since a result that cancels to near zero carries
the fp32 rounding error of the affine step.
"""

import numpy as np
import pytest
import torch

from apex_example_tpu_torch.ops import layer_norm as port_ln

FP32_TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _bf16_tol(a, b):
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7) + FP32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n,h", [(128, 768), (1000, 768), (37, 64),
                                 (8, 8192), (5, 777), (3, 1)])
def test_layer_norm_kernel_matches_plain(cuda_device, dtype, n, h):
    gen = torch.Generator(device=cuda_device).manual_seed(n * h)
    x = (torch.randn(n, h, device=cuda_device, generator=gen) * 2 + 0.5)
    x = x.to(dtype)
    g = torch.randn(h, device=cuda_device, generator=gen) * 0.2 + 1
    b = torch.randn(h, device=cuda_device, generator=gen) * 0.2
    launches = port_ln.layer_norm_cuda.launches
    y_k, mean_k, rstd_k = port_ln.layer_norm_cuda(x, g, b)
    y_p, mean_p, rstd_p = port_ln.layer_norm_plain(x, g, b)
    torch.cuda.synchronize()
    assert port_ln.layer_norm_cuda.launches == launches + 1
    assert y_k.dtype == dtype
    y_k, y_p = y_k.float().cpu().numpy(), y_p.float().cpu().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(y_k, y_p, rtol=FP32_TOL, atol=FP32_TOL)
    else:
        assert np.all(np.abs(y_k - y_p) <= _bf16_tol(y_k, y_p))
    for got, want in ((mean_k, mean_p), (rstd_k, rstd_p)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.cuda
def test_layer_norm_dispatch_takes_the_kernel_on_the_card(cuda_device):
    x = torch.randn(4, 3, 64, device=cuda_device)
    g = torch.ones(64, device=cuda_device)
    b = torch.zeros(64, device=cuda_device)
    launches = port_ln.layer_norm_cuda.launches
    y = port_ln.layer_norm(x, g, b)
    assert y.shape == x.shape and y.device.type == "cuda"
    assert port_ln.layer_norm_cuda.launches == launches + 1
    with pytest.raises(ValueError, match="contiguous"):
        port_ln.layer_norm_cuda(x.reshape(12, 64).t().contiguous().t(), g,
                                b)
