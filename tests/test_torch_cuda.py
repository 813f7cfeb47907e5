"""Kernels of the PyTorch port against their plain versions, on the card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips where
torch sees none.  The file imports no jax, so it runs on a machine that
has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up jax for the JAX package's
tests.)  Tolerances as in chip_smoke.py: fp32 1e-5; bf16 one bf16 ulp of
the output plus 1e-5, since a result that cancels to near zero carries
the fp32 rounding error of the affine step; LayerNorm dgamma and dbeta
rtol = atol = 1e-4 (sums over the rows in another order, some cancelling
near zero), RMSNorm's y, rstd, dx and dgamma the same, and a bf16 dscale
of FusedRMSNorm one bf16 ulp plus 1e-4 (the same fp32 sums, rounded
once); L2 norms and per-tensor sums rtol 1e-5; LAMB's m, v, u and p
atol 1e-6, rtol 1e-5; Adam's p, m and v the same (fp32: the same
arithmetic, up to the compiler's fused multiply-adds; bf16 p: one bf16
ulp of p plus 1e-6); the scale kernel exactly (one fp32 product, then the
same rounding) and its non-finite flag exactly; SGD's p and buf rtol 1e-5
plus atol 1e-6 (bf16 p: one bf16 ulp plus 1e-6), and bitwise unchanged
under the noop flag; NovoGrad's and Adagrad's the same, NovoGrad's
per-tensor v and inv_denom rtol 1e-6 (one fp32 expression each), and
every one bitwise unchanged under the noop flag; axpby rtol 1e-5 plus atol
1e-6 in fp32, one ulp of its output dtype in bf16 and fp16; the
BatchNorm sums rtol 1e-4 plus 4e-6 of the sum of their terms' magnitudes
(sums over the rows in another order, which may cancel) and bitwise
repeatable; the fused BatchNorm's y and
dx against the CPU's 1e-4, its dscale and dbias rtol = atol 1e-4; the
flash-attention kernels by ops/attention.py's limits: lse, and O in fp32,
atol = rtol ATTN_FWD_TOL (2e-5), their dQ, dK and dV ATTN_BWD_TOL (5e-5)
in fp32 (tests/test_attention.py's limits: sums in another order); a half
O ATTN_HALF_TOL (2e-2) from the reference's arithmetic (which rounds the
normalised P); a half O against the kernels' own arithmetic
(``attention_pair_tiled_plain``) and the half dQ, dK and dV against the
plain backward by ``half_result_check``: rtol 1e-2 and atol 1e-3 (two
bf16 ulps), at most 1e-2 (bf16) or 8e-2 (fp16) of the elements off at
all (the tensor cores add the fp32 products in another order; a rounding
point of P or dS skipped or moved flips 39-55%), and in a batch element
whose key bias masks every key each gradient row within 3 x the plain
version's own distance from correctly rounded sums; every result bitwise
repeatable.  Across two processes on cuda:0 in a gloo group
(tests/torch_dist_cases.py): SyncBatchNorm in both branches against one
process with the whole batch on the card, 1e-5 (fp32 sums in another
order), and DistributedFusedAdam against FusedAdam with the mean grads,
rtol 1e-5 plus 1e-6 of each tensor's largest magnitude.
"""

import numpy as np
import pytest
import torch

from apex_example_tpu_torch import amp
from apex_example_tpu_torch.engine import create_train_state, make_train_step
from apex_example_tpu_torch.models.gpt import gpt_tiny
from apex_example_tpu_torch.models.resnet import resnet18
from apex_example_tpu_torch.ops import attention as att
from apex_example_tpu_torch.ops import batch_norm as bn
from apex_example_tpu_torch.ops import fused_optim as fo
from apex_example_tpu_torch.ops import layer_norm as port_ln
from apex_example_tpu_torch.ops import multi_tensor as mt
from apex_example_tpu_torch.optim.fused import (FusedAdagrad, FusedAdam,
                                                FusedLAMB, FusedNovoGrad,
                                                FusedSGD)
from apex_example_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm

FP32_TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _bf16_tol(a, b, atol=FP32_TOL):
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7) + atol


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n,h", [(128, 768), (1000, 768), (6144, 410),
                                 (37, 64), (8, 8192), (5, 777), (3, 1),
                                 (96, 514), (512, 1022), (64, 1026)])
def test_layer_norm_kernel_matches_plain(cuda_device, dtype, n, h,
                                         misaligned):
    """Every layout of the pack width and row length: 16-byte packs, pairs
    (410, 514, 1022) and single elements (odd H; or x only 4 (fp32) or 2
    (half) bytes past alignment) in the warp layout, and a block a row past
    it (1026 in pairs, 8192)."""
    gen = torch.Generator(device=cuda_device).manual_seed(n * h)
    x = (torch.randn(n, h, device=cuda_device, generator=gen) * 2 + 0.5)
    x = x.to(dtype)
    if misaligned:
        x = _misaligned(x)
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


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n,h", [(4096, 768), (1000, 768), (6144, 410),
                                 (8192, 768), (16384, 768), (512, 1022),
                                 (4096, 1024), (128, 768), (37, 64),
                                 (8, 8192), (5, 777), (3, 1)])
def test_layer_norm_bwd_kernel_matches_plain(cuda_device, dtype, n, h,
                                             misaligned):
    """dx, dgamma and dbeta against the plain version and bitwise on a
    second launch: the persistent grid with two row sets (768, 410) and
    one (1022 in pairs, 1024), at many rows and few, every pointer
    misaligned too (single elements); the wide rows' layout (8192)."""
    gen = torch.Generator(device=cuda_device).manual_seed(n + h)
    x = (torch.randn(n, h, device=cuda_device, generator=gen) * 2 + 0.5)
    x = x.to(dtype)
    g = torch.randn(h, device=cuda_device, generator=gen) * 0.2 + 1
    b = torch.randn(h, device=cuda_device, generator=gen) * 0.2
    dy = torch.randn(n, h, device=cuda_device, generator=gen).to(dtype)
    if misaligned:
        x, dy = _misaligned(x), _misaligned(dy)
    _, mean, rstd = port_ln.layer_norm_plain(x, g, b)
    launches = port_ln.layer_norm_bwd_cuda.launches
    dx, dg, db = port_ln.layer_norm_bwd_cuda(x, g, mean, rstd, dy)
    dx_p, dg_p, db_p = port_ln.layer_norm_bwd_plain(x, g, mean, rstd, dy)
    torch.cuda.synchronize()
    assert port_ln.layer_norm_bwd_cuda.launches == launches + 1
    assert dx.dtype == dtype and dg.dtype == db.dtype == torch.float32
    a, r = dx.float().cpu().numpy(), dx_p.float().cpu().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(a, r, rtol=FP32_TOL, atol=FP32_TOL)
    else:
        assert np.all(np.abs(a - r) <= _bf16_tol(a, r))
    for got, want in ((dg, dg_p), (db, db_p)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)
    again = port_ln.layer_norm_bwd_cuda(x, g, mean, rstd, dy)
    assert all(torch.equal(u, w) for u, w in zip(again, (dx, dg, db)))


@pytest.mark.cuda
def test_layer_norm_autograd_runs_both_kernels(cuda_device):
    x = torch.randn(2, 8, 64, device=cuda_device, requires_grad=True)
    g = torch.ones(64, device=cuda_device, requires_grad=True)
    b = torch.zeros(64, device=cuda_device, requires_grad=True)
    fwd, bwd = port_ln.layer_norm_cuda.launches, \
        port_ln.layer_norm_bwd_cuda.launches
    (port_ln.layer_norm(x, g, b) ** 2).sum().backward()
    assert port_ln.layer_norm_cuda.launches == fwd + 1
    assert port_ln.layer_norm_bwd_cuda.launches == bwd + 1
    xc, gc, bc = (t.detach().cpu().requires_grad_() for t in (x, g, b))
    (port_ln.layer_norm(xc, gc, bc) ** 2).sum().backward()
    for dev, cpu in ((x, xc), (g, gc), (b, bc)):
        np.testing.assert_allclose(dev.grad.cpu().numpy(),
                                   cpu.grad.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n,h", [(4096, 768), (6144, 410), (8192, 768),
                                 (16384, 768), (128, 768),
                                 (37, 777), (64, 8192), (1000, 64), (3, 1),
                                 (96, 514), (512, 1022), (64, 1026)])
def test_rms_norm_kernels_match_plain(cuda_device, dtype, n, h, misaligned):
    """Forward and backward against the plain versions, at the vector path
    (H a multiple of the vector width, 16-byte aligned), the forward's
    pairs (410, 514, 1022; 1026 a block a row), the scalar path (odd H, or
    every pointer 4 bytes past alignment) and the block layout (H = 8192);
    dgamma, and dx, bitwise on a second launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(3 * n + h)
    x = (torch.randn(n, h, device=cuda_device, generator=gen) * 2 + 0.5)
    x = x.to(dtype)
    g = torch.randn(h, device=cuda_device, generator=gen) * 0.2 + 1
    dy = torch.randn(n, h, device=cuda_device, generator=gen).to(dtype)
    if misaligned:
        x, dy = _misaligned(x), _misaligned(dy)
    fwd, bwd = port_ln.rms_norm_cuda.launches, \
        port_ln.rms_norm_bwd_cuda.launches
    y_k, rstd_k = port_ln.rms_norm_cuda(x, g)
    y_p, rstd_p = port_ln.rms_norm_plain(x, g)
    dx, dg = port_ln.rms_norm_bwd_cuda(x, g, rstd_p, dy)
    dx_p, dg_p = port_ln.rms_norm_bwd_plain(x, g, rstd_p, dy)
    torch.cuda.synchronize()
    assert port_ln.rms_norm_cuda.launches == fwd + 1
    assert port_ln.rms_norm_bwd_cuda.launches == bwd + 1
    assert y_k.dtype == dx.dtype == dtype and dg.dtype == torch.float32
    for got, want in ((y_k, y_p), (dx, dx_p)):
        a, r = got.float().cpu().numpy(), want.float().cpu().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(a, r, rtol=FP32_TOL, atol=FP32_TOL)
        else:
            assert np.all(np.abs(a - r) <= _bf16_tol(a, r))
    np.testing.assert_allclose(rstd_k.cpu().numpy(), rstd_p.cpu().numpy(),
                               rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_allclose(dg.cpu().numpy(), dg_p.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    again = port_ln.rms_norm_bwd_cuda(x, g, rstd_p, dy)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dg)


@pytest.mark.cuda
@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_autograd_runs_both_kernels(cuda_device, param_dtype):
    """FusedRMSNorm on the card: one forward and one backward launch, a
    no_grad forward no backward, and the CPU's y and gradients (dscale in
    the parameters' dtype: one bf16 ulp plus 1e-4 where that is bf16)."""
    from apex_example_tpu_torch.normalization import FusedRMSNorm
    gen = torch.Generator().manual_seed(7)
    m = FusedRMSNorm(64, param_dtype=param_dtype)
    with torch.no_grad():
        m.scale.copy_(torch.randn(64, generator=gen) * 0.2 + 1)
    mc = FusedRMSNorm(64, param_dtype=param_dtype).to(cuda_device)
    mc.load_state_dict(m.state_dict())
    x = torch.randn(2, 8, 64, generator=gen)
    xc = x.to(cuda_device).requires_grad_()
    x.requires_grad_()
    fwd, bwd = port_ln.rms_norm_cuda.launches, \
        port_ln.rms_norm_bwd_cuda.launches
    yc = mc(xc)
    (yc ** 2).sum().backward()
    assert port_ln.rms_norm_cuda.launches == fwd + 1
    assert port_ln.rms_norm_bwd_cuda.launches == bwd + 1
    with torch.no_grad():
        mc(xc)
    assert port_ln.rms_norm_cuda.launches == fwd + 2
    assert port_ln.rms_norm_bwd_cuda.launches == bwd + 1
    y = m(x)
    (y ** 2).sum().backward()
    assert mc.scale.grad.dtype == param_dtype
    np.testing.assert_allclose(yc.detach().cpu().numpy(), y.detach().numpy(),
                               rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_allclose(xc.grad.cpu().numpy(), x.grad.numpy(),
                               rtol=1e-4, atol=1e-4)
    a, r = mc.scale.grad.float().cpu().numpy(), m.scale.grad.float().numpy()
    tol = (_bf16_tol(a, r, atol=1e-4) if param_dtype == torch.bfloat16
           else 1e-4 + 1e-4 * np.abs(r))
    assert np.all(np.abs(a - r) <= tol)


@pytest.mark.cuda
def test_rms_norm_raises_on_a_card_tensor_it_cannot_take(cuda_device):
    """H above 8192 on the card raises; nothing falls back to the plain
    version."""
    launches = port_ln.rms_norm_cuda.launches
    x = torch.randn(2, port_ln.MAX_H + 1, device=cuda_device)
    g = torch.ones(port_ln.MAX_H + 1, device=cuda_device)
    with pytest.raises(ValueError, match="H <="):
        port_ln.rms_norm(x, g)
    assert port_ln.rms_norm_cuda.launches == launches


def _lists(device, shapes, dtype=torch.float32, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda s, std: (torch.randn(s, device=device,       # noqa: E731
                                      generator=gen) * std).to(dtype)
    p = [rnd(s, 0.05) for s in shapes]
    g = [rnd(s, 1e-2) for s in shapes]
    m = [rnd(s, 1e-3).float() for s in shapes]
    v = [torch.rand(s, device=device, generator=gen) * 1e-5
         for s in shapes]
    return p, g, m, v


SHAPES = [(3000, 768), (768,), (1,), (65536,), (65537,), (513, 129), (7,)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_multi_tensor_l2norm_kernel_matches_plain(cuda_device, dtype):
    p, _, _, _ = _lists(cuda_device, SHAPES, dtype)
    table = mt.TensorTable([p])
    launches = mt.multi_tensor_l2norm_cuda.launches
    norm, sq = mt.multi_tensor_l2norm_cuda(table)
    norm_p, sq_p = mt.multi_tensor_l2norm_plain(p)
    torch.cuda.synchronize()
    assert mt.multi_tensor_l2norm_cuda.launches == launches + 1
    np.testing.assert_allclose(float(norm), float(norm_p), rtol=1e-5)
    np.testing.assert_allclose(sq.cpu().numpy(), sq_p.cpu().numpy(),
                               rtol=1e-5)
    norm2, sq2 = mt.multi_tensor_l2norm_cuda(mt.TensorTable([p]))
    assert torch.equal(norm, norm2) and torch.equal(sq, sq2)


@pytest.mark.cuda
@pytest.mark.parametrize("gnorm_scale", [None, 1.0, 1e-4])
def test_lamb_stage_kernels_match_plain(cuda_device, gnorm_scale):
    p, g, m, v = _lists(cuda_device, SHAPES, seed=1)
    m0, v0, p0 = ([t.clone() for t in lst] for lst in (m, v, p))
    table = mt.TensorTable([p, g, m, v])
    u = torch.empty(table.total, device=cuda_device)
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01,
                 bias_c1=1.0 / (1 - 0.9 ** 4), bias_c2=1.0 / (1 - 0.999 ** 4))
    gnorm = None
    if gnorm_scale is not None:
        gnorm = mt.multi_tensor_l2norm_cuda(table, 1)[0] * gnorm_scale
    sums, ratio = fo.lamb_stage1_cuda(table, u, gnorm, max_grad_norm=1.0,
                                      **_on_the_card(hyper, cuda_device,
                                                     lr=2e-3))
    gscale = 1.0 if gnorm is None else torch.where(
        gnorm > 1.0, 1.0 / (gnorm + 1e-6), torch.ones_like(gnorm))
    views = torch.split(u, [t.numel() for t in p])
    psq, usq = [], []
    for i in range(len(p)):
        u_p, m_p, v_p, ps, us = fo.lamb_stage1_plain(
            p0[i], g[i], m0[i], v0[i], grad_scale=gscale, **hyper)
        psq.append(ps)
        usq.append(us)
        for got, want in ((m[i], m_p), (v[i], v_p),
                          (views[i].view_as(p[i]), u_p)):
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       rtol=1e-5, atol=1e-6)
    psq, usq = torch.stack(psq), torch.stack(usq)
    for got, want in ((sums[0], psq), (sums[1], usq),
                      (ratio, fo.trust_ratio_plain(psq, usq))):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5)
    fo.lamb_stage2_cuda(table, u, ratio, fo.step_scalars(
        2e-3, device=cuda_device))
    for i in range(len(p)):
        want = fo.lamb_stage2_plain(p0[i], views[i].view_as(p0[i]),
                                    2e-3 * ratio[i])
        np.testing.assert_allclose(p[i].cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_fused_lamb_on_the_card_matches_the_cpu(cuda_device):
    shapes = [(300, 64), (64,), (5,)]
    gen = torch.Generator().manual_seed(3)
    init = [torch.randn(s, generator=gen) for s in shapes]
    grads = [[torch.randn(s, generator=gen) for s in shapes]
             for _ in range(3)]
    result = []
    for device in ("cuda", "cpu"):
        ps = [torch.nn.Parameter(t.clone().to(device)) for t in init]
        opt = FusedLAMB(ps, lr=1e-2)
        counts = (mt.multi_tensor_l2norm_cuda.launches,
                  fo.lamb_stage1_cuda.launches, fo.lamb_stage2_cuda.launches)
        for step in grads:
            opt.zero_grad()
            for p, gr in zip(ps, step):
                p.grad.add_(gr.to(device))
            opt.step()
        now = (mt.multi_tensor_l2norm_cuda.launches,
               fo.lamb_stage1_cuda.launches, fo.lamb_stage2_cuda.launches)
        ran = [b - a for a, b in zip(counts, now)]
        assert ran == ([3, 3, 3] if device == "cuda" else [0, 0, 0])
        result.append([p.detach().cpu() for p in ps])
    for a, b in zip(*result):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def _on_the_card(hyper, device, lr=None):
    """The kernels' arguments for the plain versions' ``hyper``: lr, c1 and
    c2 as the step's row on the card."""
    kw = dict(hyper)
    lr = kw.pop("lr", lr)
    kw["scalars_t"] = fo.step_scalars(lr, kw.pop("bias_c1"),
                                      kw.pop("bias_c2"), device)
    return kw


def _misaligned(t):
    """A contiguous view of ``t`` whose address is 4 bytes past 16-byte
    alignment: the kernels' scalar path."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view_as(t)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("adam_w_mode", [True, False])
@pytest.mark.parametrize("misaligned", [False, True])
def test_adam_kernel_matches_plain(cuda_device, dtype, adam_w_mode,
                                   misaligned):
    p, g, m, v = _lists(cuda_device, SHAPES, dtype, seed=4)
    if misaligned:
        p, g, m, v = ([_misaligned(t) for t in lst] for lst in (p, g, m, v))
    p0, m0, v0 = ([t.clone() for t in lst] for lst in (p, m, v))
    hyper = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=0.01, bias_c1=1.0 / (1 - 0.9 ** 5),
                 bias_c2=1.0 / (1 - 0.999 ** 5), adam_w_mode=adam_w_mode)
    launches = fo.adam_cuda.launches
    fo.adam_cuda(mt.TensorTable([p, g, m, v]),
                 **_on_the_card(hyper, cuda_device))
    torch.cuda.synchronize()
    assert fo.adam_cuda.launches == launches + 1
    for i in range(len(p)):
        p_p, m_p, v_p = fo.adam_update_plain(p0[i], g[i], m0[i], v0[i],
                                             **hyper)
        assert p[i].dtype == dtype and m[i].dtype == torch.float32
        for got, want in ((m[i], m_p), (v[i], v_p)):
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       rtol=1e-5, atol=1e-6)
        a, r = p[i].float().cpu().numpy(), p_p.float().cpu().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(a, r, rtol=1e-5, atol=1e-6)
        else:
            assert np.all(np.abs(a - r) <= _bf16_tol(a, r) - FP32_TOL + 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("planted", [None, float("inf"), float("nan")])
@pytest.mark.parametrize("misaligned", [False, True])
def test_scale_kernel_matches_plain(cuda_device, dtype, planted,
                                    misaligned):
    x = _lists(cuda_device, SHAPES, dtype, seed=5)[1]
    if planted is not None:
        x[4][65536] = planted            # the second chunk of 65,537
    if misaligned:
        x = [_misaligned(t) for t in x]
    want, finite = mt.multi_tensor_scale_plain(x, 0.37)
    out = [torch.empty_like(t) for t in x]
    launches = mt.multi_tensor_scale_cuda.launches
    flag = mt.multi_tensor_scale_cuda(mt.TensorTable([x, out]), 0, 1, 0.37)
    torch.cuda.synchronize()
    assert mt.multi_tensor_scale_cuda.launches == launches + 1
    assert flag.dtype == torch.int32 and int(flag) == int(not bool(finite))
    assert int(flag) == (planted is not None)
    for got, w in zip(out, want):
        np.testing.assert_array_equal(got.float().cpu().numpy(),
                                      w.float().cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("max_norm", [1e-3, 1e3])
def test_clip_kernels_match_plain_in_place(cuda_device, max_norm):
    g = _lists(cuda_device, SHAPES, seed=6)[1]
    g_p = [t.clone() for t in g]
    l2, sc = mt.multi_tensor_l2norm_cuda.launches, \
        mt.multi_tensor_scale_cuda.launches
    norm = mt.clip_grad_norm_cuda(mt.TensorTable([g]), max_norm, index=0)
    norm_p = mt.clip_grad_norm_plain(g_p, max_norm)
    torch.cuda.synchronize()
    assert (mt.multi_tensor_l2norm_cuda.launches - l2,
            mt.multi_tensor_scale_cuda.launches - sc) == (1, 1)
    np.testing.assert_allclose(float(norm), float(norm_p), rtol=1e-5)
    assert (float(norm) > max_norm) == (max_norm == 1e-3)
    for got, want in zip(g, g_p):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_fused_adam_with_clip_on_the_card_matches_the_cpu(cuda_device,
                                                          adam_w_mode):
    shapes = [(300, 64), (64,), (5,)]
    gen = torch.Generator().manual_seed(7)
    init = [torch.randn(s, generator=gen) for s in shapes]
    grads = [[torch.randn(s, generator=gen) for s in shapes]
             for _ in range(3)]
    result = []
    for device in ("cuda", "cpu"):
        ps = [torch.nn.Parameter(t.clone().to(device)) for t in init]
        opt = FusedAdam(ps, lr=1e-2, weight_decay=0.01,
                        adam_w_mode=adam_w_mode)
        counted = (mt.multi_tensor_l2norm_cuda, mt.multi_tensor_scale_cuda,
                   fo.adam_cuda)
        before = [fn.launches for fn in counted]
        norms = []
        for step in grads:
            opt.zero_grad()
            for p, gr in zip(ps, step):
                p.grad.add_(gr.to(device))
            norms.append(float(opt.clip_grad_norm(1.0)))
            assert opt.step() is None
        ran = [fn.launches - b for fn, b in zip(counted, before)]
        assert ran == ([3, 3, 3] if device == "cuda" else [0, 0, 0])
        result.append(([p.detach().cpu() for p in ps], norms))
    (p_gpu, n_gpu), (p_cpu, n_cpu) = result
    np.testing.assert_allclose(n_gpu, n_cpu, rtol=1e-5)
    for a, b in zip(p_gpu, p_cpu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def _sgd_lists(device, shapes, dtype=torch.float32, seed=8):
    gen = torch.Generator(device=device).manual_seed(seed)
    p = [(torch.randn(s, device=device, generator=gen) * 0.1).to(dtype)
         for s in shapes]
    g = [(torch.randn(s, device=device, generator=gen) * 1e-2).to(dtype)
         for s in shapes]
    b = [torch.randn(s, device=device, generator=gen) * 1e-2 for s in shapes]
    return p, g, b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adam_and_lamb_kernels_skip_on_the_flag(cuda_device, dtype):
    """Flag set: Adam's p, m, v, stage 1's m, v, u and stage 2's p bitwise
    unchanged.  Flag clear: bitwise the results without a flag."""
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01)
    scal = fo.step_scalars(1e-3, 1.0 / (1 - 0.9 ** 3),
                           1.0 / (1 - 0.999 ** 3), cuda_device)
    flags = {v: torch.full((), v, dtype=torch.int32, device=cuda_device)
             for v in (0, 1)}
    results = {}
    for flag in (None, 0, 1):
        nf = None if flag is None else flags[flag]
        p, g, m, v = _lists(cuda_device, SHAPES, dtype, seed=8)
        before = [t.clone() for t in p + m + v]
        fo.adam_cuda(mt.TensorTable([p, g, m, v]), scalars_t=scal,
                     noop_flag=nf, **hyper)
        adam = [t.clone() for t in p + m + v]
        p, g, m, v = _lists(cuda_device, SHAPES, dtype, seed=8)
        table = mt.TensorTable([p, g, m, v])
        u = torch.full((table.total,), float("nan"), device=cuda_device)
        gnorm = mt.multi_tensor_l2norm_cuda(table, 1)[0]
        _, ratio = fo.lamb_stage1_cuda(table, u, gnorm, scalars_t=scal,
                                       max_grad_norm=1.0, noop_flag=nf,
                                       **hyper)
        lamb1 = [t.clone() for t in m + v + [u]]
        fo.lamb_stage2_cuda(table, u, ratio, scal, noop_flag=nf)
        torch.cuda.synchronize()
        results[flag] = adam + lamb1 + [t.clone() for t in p]
        if flag == 1:
            assert all(torch.equal(a, b) for a, b in zip(adam, before))
            assert all(torch.equal(a, b) for a, b in zip(
                lamb1[:-1], before[len(p):]))
            assert bool(u.isnan().all())
            assert all(torch.equal(a, b) for a, b in zip(p, before))
    assert all(torch.equal(a, b) for a, b in zip(results[0], results[None]))


@pytest.mark.cuda
@pytest.mark.parametrize("cls", [FusedAdam, FusedLAMB])
def test_fused_adam_and_lamb_take_mixed_dtypes_on_the_card(cuda_device, cls):
    """bf16 and fp32 parameters (amp O3's mix): one table per dtype, each
    kernel launched once per table a step (LAMB's L2 norm too); three steps
    with a flagged one between them against the CPU: fp32 parameters and
    the moments rtol 1e-5 plus atol 1e-6, bf16 parameters one bf16 ulp
    plus 1e-6; the step counts equal."""
    shapes = [(300, 64), (64,), (5,), (7, 9)]
    dtypes = [torch.bfloat16, torch.float32, torch.float32, torch.bfloat16]
    gen = torch.Generator().manual_seed(9)
    init = [torch.randn(s, generator=gen).to(d)
            for s, d in zip(shapes, dtypes)]
    grads = [[torch.randn(s, generator=gen).to(d)
              for s, d in zip(shapes, dtypes)] for _ in range(3)]
    kernels = ((fo.adam_cuda,) if cls is FusedAdam else
               (mt.multi_tensor_l2norm_cuda, fo.lamb_stage1_cuda,
                fo.lamb_stage2_cuda))
    result = []
    for device in ("cuda", "cpu"):
        ps = [torch.nn.Parameter(t.clone().to(device)) for t in init]
        opt = cls(ps, lr=1e-2, weight_decay=0.01)
        assert opt.groups == [[0, 3], [1, 2]]
        before = [k.launches for k in kernels]
        for step, flag in zip(grads, (0, 1, 0)):
            opt.zero_grad()
            for p, gr in zip(ps, step):
                p.grad.add_(gr.to(device))
            opt.step(noop_flag=torch.tensor(flag, dtype=torch.int32,
                                            device=device))
        ran = [k.launches - b for k, b in zip(kernels, before)]
        assert ran == [6 if device == "cuda" else 0] * len(kernels)
        assert opt.step_count == 2
        result.append([t.detach().cpu() for t in ps + opt.mu + opt.nu])
    for got, want in zip(*result):
        a, r = got.float().numpy(), want.float().numpy()
        if got.dtype == torch.bfloat16:
            assert np.all(np.abs(a - r) <= _bf16_tol(a, r, 1e-6))
        else:
            np.testing.assert_allclose(a, r, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("branch", [{}, {"nesterov": True},
                                    {"first_step": True},
                                    {"dampening": 0.25}])
@pytest.mark.parametrize("misaligned", [False, True])
def test_sgd_kernel_matches_plain(cuda_device, dtype, branch, misaligned):
    p, g, b = _sgd_lists(cuda_device, SHAPES, dtype)
    if misaligned:
        p, g, b = ([_misaligned(t) for t in lst] for lst in (p, g, b))
    p0, b0 = [t.clone() for t in p], [t.clone() for t in b]
    hyper = dict(lr=0.1, momentum=0.9, weight_decay=1e-4, **branch)
    launches = fo.sgd_cuda.launches
    fo.sgd_cuda(mt.TensorTable([p, g, b]), **hyper)
    torch.cuda.synchronize()
    assert fo.sgd_cuda.launches == launches + 1
    for i in range(len(p)):
        p_p, b_p = fo.sgd_update_plain(p0[i], g[i], b0[i], **hyper)
        np.testing.assert_allclose(b[i].cpu().numpy(), b_p.cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)
        a, r = p[i].float().cpu().numpy(), p_p.float().cpu().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(a, r, rtol=1e-5, atol=1e-6)
        else:
            tol = 2.0 ** (np.floor(np.log2(np.maximum(
                np.maximum(np.abs(a), np.abs(r)), 2.0 ** -126))) -
                (7 if dtype == torch.bfloat16 else 10)) + 1e-6
            assert np.all(np.abs(a - r) <= tol)


@pytest.mark.cuda
@pytest.mark.parametrize("flag", [0, 1])
def test_sgd_kernel_device_lr_and_noop_flag(cuda_device, flag):
    p, g, b = _sgd_lists(cuda_device, SHAPES)
    p0, b0 = [t.clone() for t in p], [t.clone() for t in b]
    lr_t = torch.full((1,), 0.05, device=cuda_device)
    noop = torch.full((), flag, dtype=torch.int32, device=cuda_device)
    fo.sgd_cuda(mt.TensorTable([p, g, b]), lr=123.0, momentum=0.9,
                weight_decay=1e-4, lr_t=lr_t, noop_flag=noop)
    torch.cuda.synchronize()
    for i in range(len(p)):
        if flag:
            assert torch.equal(p[i], p0[i]) and torch.equal(b[i], b0[i])
        else:
            p_p, b_p = fo.sgd_update_plain(p0[i], g[i], b0[i], lr=0.05,
                                           momentum=0.9, weight_decay=1e-4)
            np.testing.assert_allclose(p[i].cpu().numpy(),
                                       p_p.cpu().numpy(), rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unscale_with_the_device_scale_flags_outputs(cuda_device, dtype):
    x = _lists(cuda_device, SHAPES, dtype, seed=9)[1]
    x[0][5, 7] = 1e38 if dtype == torch.float32 else 3e38
    inv = torch.full((), 4.0, device=cuda_device)
    want, finite = mt.multi_tensor_scale_plain(x, 4.0, flag_output=True)
    flag = mt.multi_tensor_scale_cuda(mt.TensorTable([x]), 0, 0,
                                      scale_t=inv, flag_output=True)
    torch.cuda.synchronize()
    assert int(flag) == 1 and not bool(finite)   # the product overflowed
    for got, w in zip(x, want):
        np.testing.assert_array_equal(got.float().cpu().numpy(),
                                      w.float().cpu().numpy())


@pytest.mark.cuda
def test_fused_sgd_on_the_card_matches_the_cpu_across_a_skip(cuda_device):
    shapes = [(300, 64), (64,), (5,)]
    gen = torch.Generator().manual_seed(10)
    init = [torch.randn(s, generator=gen) for s in shapes]
    grads = [[torch.randn(s, generator=gen) for s in shapes]
             for _ in range(4)]
    schedule = lambda step: 0.1 * 0.5 ** (step - 1)        # noqa: E731
    result = []
    for device in ("cuda", "cpu"):
        ps = [torch.nn.Parameter(t.clone().to(device)) for t in init]
        opt = FusedSGD(ps, lr=schedule, momentum=0.9, weight_decay=1e-4,
                       nesterov=True)
        before = fo.sgd_cuda.launches
        for k, step in enumerate(grads):
            opt.zero_grad()
            for p, gr in zip(ps, step):
                p.grad.add_(gr.to(device))
            flag = torch.full((), int(k == 1), dtype=torch.int32,
                              device=device)
            opt.step(noop_flag=flag)
        assert fo.sgd_cuda.launches - before == (4 if device == "cuda"
                                                 else 0)
        assert opt.step_count == 3
        result.append(([p.detach().cpu() for p in ps],
                       [m.cpu() for m in opt.momentum_buffer],
                       float(opt.lr_tensor())))
    (p_g, b_g, lr_g), (p_c, b_c, lr_c) = result
    assert lr_g == lr_c == np.float32(0.1 * 0.5 ** 3)
    for a, b in zip(p_g + b_g, p_c + b_c):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def _assert_half_close(a, r, dtype):
    """One ulp of ``dtype`` plus 1e-6 (fp32: rtol 1e-5, atol 1e-6)."""
    if dtype == torch.float32:
        np.testing.assert_allclose(a, r, rtol=1e-5, atol=1e-6)
        return
    bits = 7 if dtype == torch.bfloat16 else 10
    tol = 2.0 ** (np.floor(np.log2(np.maximum(
        np.maximum(np.abs(a), np.abs(r)), 2.0 ** -126))) - bits) + 1e-6
    assert np.all(np.abs(a - r) <= tol)


NOVO = dict(beta1=0.95, beta2=0.98, eps=1e-8, weight_decay=0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("first_step,ga", [(True, 0.05), (False, 0.05),
                                           (False, 1.0)])
@pytest.mark.parametrize("misaligned", [False, True])
def test_novograd_kernel_matches_plain(cuda_device, dtype, first_step, ga,
                                       misaligned):
    p, g, m = _sgd_lists(cuda_device, SHAPES, dtype, seed=21)
    if misaligned:
        p, g, m = ([_misaligned(t) for t in lst] for lst in (p, g, m))
    gen = torch.Generator(device=cuda_device).manual_seed(22)
    v = torch.rand(len(p), device=cuda_device, generator=gen)
    sq = mt.multi_tensor_l2norm_plain(g)[1]
    p0, m0, v0 = [t.clone() for t in p], [t.clone() for t in m], v.clone()
    hyper = dict(NOVO, grad_avg_coeff=ga)
    scal = torch.tensor([0.02 / 0.05, 1.7], device=cuda_device)
    step = torch.full((), 0 if first_step else 3, dtype=torch.int32,
                      device=cuda_device)
    table = mt.TensorTable([p, g, m])
    launches = fo.novograd_cuda.launches
    inv = fo.novograd_cuda(table, sq, v, scal, step, **hyper)
    torch.cuda.synchronize()
    assert fo.novograd_cuda.launches == launches + 1
    v_p, inv_p = fo.novograd_moment_plain(
        sq, v0, beta2=0.98, eps=1e-8, c2=1.7, first_step=first_step)
    np.testing.assert_allclose(v.cpu().numpy(), v_p.cpu().numpy(), rtol=1e-6)
    np.testing.assert_allclose(inv.cpu().numpy(), inv_p.cpu().numpy(),
                               rtol=1e-6)
    for i in range(len(p)):
        p_p, m_p = fo.novograd_update_plain(
            p0[i], g[i], m0[i], inv_denom=inv_p[i], lr_c1=0.02 / 0.05,
            beta1=0.95, weight_decay=0.01, grad_avg_coeff=ga)
        np.testing.assert_allclose(m[i].cpu().numpy(), m_p.cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)
        _assert_half_close(p[i].float().cpu().numpy(),
                           p_p.float().cpu().numpy(), dtype)
    p1, m1, v1 = [t.clone() for t in p], [t.clone() for t in m], v.clone()
    for lst, ref in ((p, p0), (m, m0)):
        for a, b in zip(lst, ref):
            a.copy_(b)
    v.copy_(v0)
    fo.novograd_cuda(table, sq, v, scal, step, **hyper)
    torch.cuda.synchronize()
    assert torch.equal(v, v1)
    assert all(torch.equal(a, b) for a, b in zip(p + m, p1 + m1))


@pytest.mark.cuda
@pytest.mark.parametrize("flag", [0, 1])
@pytest.mark.parametrize("count", [0, 3])
def test_novograd_kernel_first_step_branch_and_noop_flag(cuda_device, flag,
                                                         count):
    p, g, m = _sgd_lists(cuda_device, SHAPES, seed=23)
    v = torch.rand(len(p), device=cuda_device) + 0.5
    sq = mt.multi_tensor_l2norm_plain(g)[1]
    p0, m0, v0 = [t.clone() for t in p], [t.clone() for t in m], v.clone()
    scal = torch.tensor([0.3, 1.25], device=cuda_device)
    step = torch.full((), count, dtype=torch.int32, device=cuda_device)
    noop = torch.full((), flag, dtype=torch.int32, device=cuda_device)
    fo.novograd_cuda(mt.TensorTable([p, g, m]), sq, v, scal, step,
                     grad_avg_coeff=0.05, noop_flag=noop, **NOVO)
    torch.cuda.synchronize()
    if flag:
        assert torch.equal(v, v0)
        assert all(torch.equal(a, b) for a, b in zip(p + m, p0 + m0))
        return
    v_p, inv_p = fo.novograd_moment_plain(sq, v0, beta2=0.98, eps=1e-8,
                                          c2=1.25, first_step=count == 0)
    np.testing.assert_allclose(v.cpu().numpy(), v_p.cpu().numpy(), rtol=1e-6)
    for i in range(len(p)):
        p_p, _ = fo.novograd_update_plain(
            p0[i], g[i], m0[i], inv_denom=inv_p[i], lr_c1=0.3, beta1=0.95,
            weight_decay=0.01, grad_avg_coeff=0.05)
        np.testing.assert_allclose(p[i].cpu().numpy(), p_p.cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("w_mode", [False, True])
@pytest.mark.parametrize("misaligned", [False, True])
def test_adagrad_kernel_matches_plain(cuda_device, dtype, w_mode,
                                      misaligned):
    p, g, _ = _sgd_lists(cuda_device, SHAPES, dtype, seed=24)
    h = [torch.rand(t.shape, device=cuda_device) * 1e-4 for t in p]
    if misaligned:
        p, g, h = ([_misaligned(t) for t in lst] for lst in (p, g, h))
    p0, h0 = [t.clone() for t in p], [t.clone() for t in h]
    hyper = dict(lr=0.01, eps=1e-10, weight_decay=1e-4,
                 adagrad_w_mode=w_mode)
    table = mt.TensorTable([p, g, h])
    launches = fo.adagrad_cuda.launches
    fo.adagrad_cuda(table, **hyper)
    torch.cuda.synchronize()
    assert fo.adagrad_cuda.launches == launches + 1
    for i in range(len(p)):
        p_p, h_p = fo.adagrad_update_plain(p0[i], g[i], h0[i], **hyper)
        np.testing.assert_allclose(h[i].cpu().numpy(), h_p.cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)
        _assert_half_close(p[i].float().cpu().numpy(),
                           p_p.float().cpu().numpy(), dtype)
    p1, h1 = [t.clone() for t in p], [t.clone() for t in h]
    for lst, ref in ((p, p0), (h, h0)):
        for a, b in zip(lst, ref):
            a.copy_(b)
    fo.adagrad_cuda(table, **hyper)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(p + h, p1 + h1))


@pytest.mark.cuda
@pytest.mark.parametrize("flag", [0, 1])
def test_adagrad_kernel_device_lr_and_noop_flag(cuda_device, flag):
    p, g, _ = _sgd_lists(cuda_device, SHAPES, seed=25)
    h = [torch.rand(t.shape, device=cuda_device) * 1e-4 for t in p]
    p0, h0 = [t.clone() for t in p], [t.clone() for t in h]
    lr_t = torch.full((1,), 0.05, device=cuda_device)
    noop = torch.full((), flag, dtype=torch.int32, device=cuda_device)
    fo.adagrad_cuda(mt.TensorTable([p, g, h]), lr=123.0, eps=1e-10,
                    weight_decay=1e-4, lr_t=lr_t, noop_flag=noop)
    torch.cuda.synchronize()
    for i in range(len(p)):
        if flag:
            assert torch.equal(p[i], p0[i]) and torch.equal(h[i], h0[i])
        else:
            p_p, _ = fo.adagrad_update_plain(p0[i], g[i], h0[i], lr=0.05,
                                             eps=1e-10, weight_decay=1e-4)
            np.testing.assert_allclose(p[i].cpu().numpy(),
                                       p_p.cpu().numpy(), rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16,
                                     torch.float16])
@pytest.mark.parametrize("y_dtype", [torch.float32, torch.bfloat16,
                                     torch.float16])
@pytest.mark.parametrize("misaligned", [False, True])
def test_axpby_kernel_matches_plain(cuda_device, x_dtype, y_dtype,
                                    misaligned):
    x = _sgd_lists(cuda_device, SHAPES, x_dtype, seed=26)[0]
    y = _sgd_lists(cuda_device, SHAPES, y_dtype, seed=27)[0]
    out = [torch.empty_like(t) for t in y]
    if misaligned:
        x, y, out = ([_misaligned(t) for t in lst] for lst in (x, y, out))
    launches = mt.multi_tensor_axpby_cuda.launches
    mt.multi_tensor_axpby_cuda(mt.TensorTable([x, y, out]), 0.7, -1.3)
    torch.cuda.synchronize()
    assert mt.multi_tensor_axpby_cuda.launches == launches + 1
    want = mt.multi_tensor_axpby_plain(0.7, x, -1.3, y)
    for a, r in zip(out, want):
        assert a.dtype == y_dtype
        _assert_half_close(a.float().cpu().numpy(), r.float().cpu().numpy(),
                           y_dtype)
    again = mt.multi_tensor_axpby(0.7, x, -1.3, y)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.cuda
@pytest.mark.parametrize("cls", [FusedNovoGrad, FusedAdagrad])
def test_novograd_and_adagrad_on_the_card_match_the_cpu_across_a_skip(
        cuda_device, cls):
    shapes = [(300, 64), (64,), (5,)]
    gen = torch.Generator().manual_seed(28)
    init = [torch.randn(s, generator=gen) for s in shapes]
    grads = [[torch.randn(s, generator=gen) for s in shapes]
             for _ in range(4)]
    schedule = lambda step: 0.05 * 0.5 ** (step - 1)       # noqa: E731
    counter = fo.novograd_cuda if cls is FusedNovoGrad else fo.adagrad_cuda
    result = []
    for device in ("cuda", "cpu"):
        ps = [torch.nn.Parameter(t.clone().to(device)) for t in init]
        opt = cls(ps, lr=schedule, weight_decay=1e-3)
        before = counter.launches
        for k, step in enumerate(grads):
            opt.zero_grad()
            for p, gr in zip(ps, step):
                p.grad.add_(gr.to(device))
            flag = torch.full((), int(k in (0, 2)), dtype=torch.int32,
                              device=device)
            opt.step(noop_flag=flag)
        assert counter.launches - before == (4 if device == "cuda" else 0)
        assert opt.step_count == 2
        state = opt.state_dict()
        result.append([p.detach().cpu() for p in ps] + [
            t.cpu() for name in state if name != "step"
            for t in state[name]])
    for a, b in zip(*result):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("cls", [FusedNovoGrad, FusedAdagrad, FusedAdam,
                                 FusedLAMB])
def test_first_step_overflow_is_skipped_with_no_host_sync(cuda_device, cls):
    policy, scaler = amp.initialize("O2", loss_scale="dynamic",
                                    device=cuda_device)
    md = amp.module_dtypes(policy)
    model = resnet18(num_classes=10, num_filters=8, dtype=md.compute,
                     bn_dtype=md.bn_stats, device=cuda_device)
    opt = cls(model.parameters(), lr=1e-3)
    state = create_train_state(model, opt, policy, scaler)
    gen = torch.Generator(device=cuda_device).manual_seed(29)
    x = torch.randn(8, 32, 32, 3, device=cuda_device, generator=gen)
    y = torch.randint(0, 10, (8,), device=cuda_device, generator=gen)
    torch.nn.functional.cross_entropy(model(x), y).backward()   # warm up
    torch.cuda.synchronize()
    before = [t.detach().clone() for t in model.parameters()]
    saved = opt.state_dict()
    poison = lambda logits, labels: (                # noqa: E731
        torch.nn.functional.cross_entropy(logits, labels) * float("inf"))
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = make_train_step(poison)(state, (x, y))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert float(metrics["grads_finite"]) == 0.0
    assert float(state.scaler.scale) == 2.0 ** 15 and opt.step_count == 0
    after = opt.state_dict()
    for a, b in zip(list(model.parameters()), before):
        assert torch.equal(a, b)
    for name in saved:
        if name != "step":
            assert all(torch.equal(a, b) for a, b in zip(after[name],
                                                         saved[name]))
    state, metrics = make_train_step()(state, (x, y))
    torch.cuda.synchronize()
    assert float(metrics["grads_finite"]) == 1.0 and opt.step_count == 1
    if cls is FusedNovoGrad:       # the first-step branch: v = ||g||^2
        _, sq = mt.multi_tensor_l2norm_cuda(opt.tables[0], index=1)
        assert torch.equal(opt._v[0], sq)


# (49997, 64): the last block row short; (100352, 64): the stem at batch 8
BN_CASES = [(1000, 64), (777, 37), (4096, 1024), (12544 // 8, 2048),
            (33, 3), (1, 8), (49997, 64), (8 * 112 * 112, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows,C", BN_CASES)
def test_bn_kernels_match_plain(cuda_device, dtype, rows, C):
    gen = torch.Generator(device=cuda_device).manual_seed(rows + C)
    x = (torch.randn(rows, C, device=cuda_device, generator=gen) * 2
         + 3).to(dtype)
    dy = torch.randn(rows, C, device=cuda_device, generator=gen).to(dtype)
    c = torch.randn(C, device=cuda_device, generator=gen) + 3
    mean = torch.randn(C, device=cuda_device, generator=gen) + 3
    inv = torch.rand(C, device=cuda_device, generator=gen) + 0.5
    counts = (bn.bn_stats_cuda.launches, bn.bn_bwd_sums_cuda.launches)
    got = bn.bn_stats_cuda(x, c) + bn.bn_bwd_sums_cuda(x, dy, mean, inv)
    want = bn.bn_stats_plain(x, c) + bn.bn_bwd_sums_plain(x, dy, mean, inv)
    again = bn.bn_stats_cuda(x, c) + bn.bn_bwd_sums_cuda(x, dy, mean, inv)
    torch.cuda.synchronize()
    assert (bn.bn_stats_cuda.launches - counts[0],
            bn.bn_bwd_sums_cuda.launches - counts[1]) == (2, 2)
    xc, dyf = x.float() - c, dy.float()
    mags = (xc.abs().sum(0), (xc * xc).sum(0), dyf.abs().sum(0),
            (dyf * (x.float() - mean) * inv).abs().sum(0))
    for a, w, r, m in zip(got, want, again, mags):
        assert a.dtype == torch.float32 and a.shape == (C,)
        err = (a - w).abs()
        assert bool((err <= 1e-4 * w.abs() + 4e-6 * m).all()), float(
            err.max())
        assert torch.equal(a, r)                      # bitwise repeat


@pytest.mark.cuda
@pytest.mark.parametrize("C", [64, 37, 1024, 2048])
def test_bn_sums_count_every_row_once(cuda_device, C):
    """The kernel's split of the rows over the row blocks, at row counts
    around the grid's size (one block row short, even, one over, a short
    last block row): small integer inputs make every partial sum exact in
    fp32, so each sum equals the float64 one bitwise, and a row dropped or
    taken twice would show."""
    lib = bn._library()
    for mode in (0, 1):
        vec = 4 if C % 4 == 0 else 1
        sms, resident = bn._blocks_per_sm(lib, cuda_device, mode, 0, vec)
        tx, _ = bn.geometry(1, C, vec, sms, resident)
        chunk = bn.THREADS // tx
        grid = max(1, sms * resident // -(-C // (tx * vec)))
        for k in (grid - 1, grid, grid + 1, 3 * grid + 1, 7 * grid + 5):
            for short in (0, 1, chunk - 1):
                rows = max(1, k * chunk - short)
                r = torch.arange(rows, device=cuda_device)[:, None]
                ch = torch.arange(C, device=cuda_device)
                x = ((r % 7) + 1 + ch % 3).float()
                dy = ((r % 5) - 2 + 0 * ch).float()
                zero = torch.zeros(C, device=cuda_device)
                one = torch.ones(C, device=cuda_device)
                if mode == 0:
                    got = bn.bn_stats_cuda(x, zero)
                    want = (x.double().sum(0), (x.double() ** 2).sum(0))
                else:
                    got = bn.bn_bwd_sums_cuda(x, dy, zero, one)
                    want = (dy.double().sum(0),
                            (dy.double() * x.double()).sum(0))
                for a, w in zip(got, want):
                    assert torch.equal(a.double(), w), (mode, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,h", [(torch.float32, 768),
                                     (torch.float32, 410),
                                     (torch.bfloat16, 768)])
def test_norm_bwd_counts_every_row_once(cuda_device, dtype, h):
    """The persistent backward's split of the rows over its warps, at row
    counts around the grid's (a row a warp: one short, even, one over,
    two rows a warp and one over) and at few rows (a grid of one group of
    blocks, and of two), LayerNorm and RMSNorm: with mean 0 and
    rstd 1, small integer x and dy make x_hat exact and every partial sum
    of dgamma and dbeta exact in fp32, so each equals the float64 sum
    bitwise, and a row dropped or taken twice would show."""
    from apex_example_tpu_torch.ops import _build
    lib = port_ln._library()
    g = torch.ones(h, device=cuda_device)
    for kmean in (1, 0):
        vec = port_ln._pack_width(
            h, (torch.empty(1, h, dtype=dtype, device=cuda_device),), (g,))
        sms, resident = port_ln._blocks_per_sm(
            lib, cuda_device, kmean, _build.DTYPE_CODES[dtype], vec, h)
        grid = sms * resident * port_ln.BWD_WARPS
        for n in (5, 129, grid - 1, grid, grid + 1, 2 * grid + 1):
            assert port_ln.bwd_geometry(n, h, sms, resident).layout == \
                port_ln.BWD_PERSIST
            r = torch.arange(n, device=cuda_device)[:, None]
            c = torch.arange(h, device=cuda_device)
            x = ((r % 7) + 1 + c % 3).to(dtype)
            dy = ((r % 5) - 2 + 0 * c).to(dtype)
            zero = torch.zeros(n, device=cuda_device)
            one = torch.ones(n, device=cuda_device)
            want_g = (dy.double() * x.double()).sum(0)
            if kmean:
                _, dg, db = port_ln.layer_norm_bwd_cuda(x, g, zero, one, dy)
                assert torch.equal(db.double(), dy.double().sum(0)), n
            else:
                _, dg = port_ln.rms_norm_bwd_cuda(x, g, one, dy)
            assert torch.equal(dg.double(), want_g), (kmean, n)


@pytest.mark.cuda
def test_tickets_reset_across_kernels_and_streams(cuda_device):
    """bn_stats, bn_bwd_sums (8 channel slabs, a ticket each), the
    LayerNorm backward at few rows (one group of blocks: its ticket) and
    at many rows (ticket 0 and one a group) interleaved on one
    stream, then on two streams at once: every sum repeats bitwise and
    every stream's tickets are back at 0."""
    from apex_example_tpu_torch.ops import _build
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    rnd = lambda *s: torch.randn(*s, device=cuda_device,  # noqa: E731
                                 generator=gen)
    x, dy = rnd(20000, 1024) + 3, rnd(20000, 1024)
    c, mean, inv = rnd(1024) + 3, rnd(1024) + 3, rnd(1024).abs() + 0.5
    lx, ldy, lg = rnd(128, 768), rnd(128, 768), rnd(768) * 0.2 + 1
    _, lmean, lrstd = port_ln.layer_norm_plain(lx, lg, lg)
    mx, mdy = rnd(4096, 768), rnd(4096, 768)
    _, mmean, mrstd = port_ln.layer_norm_plain(mx, lg, lg)

    def run():
        return (bn.bn_stats_cuda(x, c) + bn.bn_bwd_sums_cuda(x, dy, mean, inv)
                + port_ln.layer_norm_bwd_cuda(lx, lg, lmean, lrstd, ldy)
                + port_ln.layer_norm_bwd_cuda(mx, lg, mmean, mrstd, mdy))

    want = run()
    one = [run() for _ in range(3)]
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    two = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(3):
        for s in streams:
            with torch.cuda.stream(s):
                two.append(run())
    torch.cuda.synchronize()
    for got in one + two:
        assert all(torch.equal(a, w) for a, w in zip(got, want))
    for stream in [torch.cuda.current_stream()] + streams:
        assert not bool(_build.tickets(x.device, stream.cuda_stream).any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_batch_norm_on_the_card_matches_the_cpu(cuda_device, dtype):
    gen = torch.Generator().manual_seed(11)
    x = (torch.randn(8, 7, 7, 96, generator=gen) * 2 + 1).to(dtype)
    dy = torch.randn(8, 7, 7, 96, generator=gen).to(dtype)
    out = []
    for device in ("cuda", "cpu"):
        m = SyncBatchNorm(96, dtype=dtype, stats_dtype=torch.float32,
                          fused_kernel=True, device=device)
        affine = torch.Generator().manual_seed(12)
        with torch.no_grad():
            m.scale.copy_(torch.rand(96, generator=affine) + 0.5)
            m.bias.copy_(torch.rand(96, generator=affine) - 0.5)
        xd = x.to(device).requires_grad_()
        y = m(xd)
        y.backward(dy.to(device))
        out.append([t.detach().float().cpu() for t in
                    (y, xd.grad, m.scale.grad, m.bias.grad, m.mean, m.var)])
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(*out):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_resnet18_dynamic_step_makes_no_host_sync(cuda_device):
    policy, scaler = amp.initialize("O2", loss_scale="dynamic",
                                    device=cuda_device)
    md = amp.module_dtypes(policy)
    model = resnet18(num_classes=10, num_filters=8, dtype=md.compute,
                     bn_dtype=md.bn_stats, device=cuda_device)
    opt = FusedSGD(model.parameters(), lr=lambda s: 0.1 / s, momentum=0.9)
    state = create_train_state(model, opt, policy, scaler)
    step = make_train_step()
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    x = torch.randn(8, 32, 32, 3, device=cuda_device, generator=gen)
    y = torch.randint(0, 10, (8,), device=cuda_device, generator=gen)
    state, _ = step(state, (x, y))                    # warm up
    torch.cuda.synchronize()
    before = [p.detach().clone() for p in model.parameters()]
    bufs = [b.clone() for b in opt.momentum_buffer]
    poison = lambda logits, labels: (                # noqa: E731
        torch.nn.functional.cross_entropy(logits, labels) * float("inf"))
    counts = (mt.multi_tensor_scale_cuda.launches, fo.sgd_cuda.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = make_train_step(poison)(state, (x, y))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert (mt.multi_tensor_scale_cuda.launches - counts[0],
            fo.sgd_cuda.launches - counts[1]) == (1, 1)
    assert float(metrics["grads_finite"]) == 0.0
    assert float(state.scaler.scale) == 2.0 ** 15 and opt.step_count == 1
    for a, b in zip(list(model.parameters()) + opt.momentum_buffer,
                    before + bufs):
        assert torch.equal(a, b)


ATTN_CASES = [  # (B, Sq, Sk, H, D, causal, bias)
    (2, 256, 256, 2, 64, True, False), (2, 256, 256, 2, 64, False, True),
    (1, 96, 200, 2, 64, True, False), (1, 100, 100, 3, 16, True, False),
    (2, 100, 100, 2, 80, False, True), (1, 64, 64, 1, 128, True, False),
    (1, 200, 200, 2, 24, True, False)]   # D 24: the tensor cores' pad


def _attn_inputs(device, b, sq, sk, h, d, bias, dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(b, s, h, d, device=device, generator=gen)
               .to(dtype) for s in (sq, sk, sk))
    do = torch.randn(b, sq, h, d, device=device, generator=gen).to(dtype)
    dlse = torch.randn(b, h, sq, device=device, generator=gen)
    key_bias = None
    if bias:    # a masked suffix per row; the last row has every key masked
        keep = torch.randint(sk // 2, sk + 1, (b,), device=device,
                             generator=gen)
        keep[-1] = 0
        key_bias = torch.where(
            torch.arange(sk, device=device)[None, :] < keep[:, None],
            0.0, -1e9)
    return q, k, v, do, dlse, key_bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_kernels_match_plain(cuda_device, dtype, case):
    b, sq, sk, h, d, causal, bias = case
    q, k, v, do, dlse, key_bias = _attn_inputs(cuda_device, b, sq, sk, h, d,
                                               bias, dtype, sq * d)
    scale = d ** -0.5
    launches = [fn.launches for fn in (att.flash_attention_cuda,
                                       att.flash_attention_dkdv_cuda,
                                       att.flash_attention_dq_cuda)]
    o, lse = att.flash_attention_cuda(q, k, v, key_bias, causal, scale)
    o_p, lse_p = att.attention_pair_plain(q, k, v, key_bias, causal, scale)
    dl = att.delta(o_p, do, dlse)
    dk, dv = att.flash_attention_dkdv_cuda(q, k, v, key_bias, causal, scale,
                                           do, lse_p, dl)
    dq = att.flash_attention_dq_cuda(q, k, v, key_bias, causal, scale, do,
                                     lse_p, dl)
    want = att.attention_bwd_plain(q, k, v, key_bias, causal, scale, o_p,
                                   lse_p, do, dlse)
    again = (att.flash_attention_cuda(q, k, v, key_bias, causal, scale)
             + att.flash_attention_dkdv_cuda(q, k, v, key_bias, causal,
                                             scale, do, lse_p, dl)
             + (att.flash_attention_dq_cuda(q, k, v, key_bias, causal,
                                            scale, do, lse_p, dl),))
    torch.cuda.synchronize()
    assert [fn.launches for fn in (att.flash_attention_cuda,
                                   att.flash_attention_dkdv_cuda,
                                   att.flash_attention_dq_cuda)] == \
        [n + 2 for n in launches]
    half = dtype != torch.float32
    fwd_tol = att.ATTN_HALF_TOL if half else att.ATTN_FWD_TOL
    checks = [("o", o, o_p, fwd_tol, fwd_tol),
              ("lse", lse, lse_p, att.ATTN_FWD_TOL, att.ATTN_FWD_TOL)]
    grads = (("dq", dq, want[0]), ("dk", dk, want[1]), ("dv", dv, want[2]))
    if half:
        o_t = att.attention_pair_tiled_plain(q, k, v, key_bias, causal,
                                             scale)[0]
        r = att.half_result_check("o", o, o_t)
        assert r.ok, ("o_tiled", r)
        dead = att.dead_batch(key_bias)
        exact = (None,) * 3
        if dead is not None and bool(dead.any()):
            exact = att.attention_exact_sums(
                *(t[dead] for t in (q, k, v, key_bias)), causal, scale,
                do[dead], dl[dead], lse_p[dead])
        for (name, got, ref), ex in zip(grads, exact):
            r = att.half_result_check(name, got, ref, dead, ex)
            assert r.ok, (name, r)
    else:
        checks += [g + (att.ATTN_BWD_TOL, att.ATTN_BWD_TOL) for g in grads]
    for name, got, ref, rtol, atol in checks:
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   ref.float().cpu().numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)
    for got, rep in zip((o, lse, dk, dv, dq), again):
        assert torch.equal(got, rep)                  # bitwise repeat


# The fp32 kernels' tiles: 128 keys or queries a block and 64 streamed rows
# a tile at D <= 64, 64 and 48 at D <= 128 (csrc/attention.cu kF32Rows*,
# kF32Cols*; the forward's too).  Lengths that none of them divide; causal
# Sq < Sk (bottom-right); a key bias whose last batch element masks every
# key; q, k, v and dO as x[..., ::2] of a tensor twice as wide ("strided",
# the kernels' 4-byte element loads) beside contiguous ones (16-byte
# copies).
FP32_BWD_CASES = [  # (B, Sq, Sk, H, D, causal, bias, layout)
    (1, 100, 100, 2, 8, True, False, "contiguous"),
    (2, 96, 200, 2, 128, True, False, "contiguous"),
    (2, 130, 130, 2, 128, False, True, "contiguous"),
    (2, 150, 310, 2, 64, True, True, "contiguous"),
    (2, 150, 310, 2, 64, True, True, "strided"),
    (1, 200, 260, 2, 64, True, False, "strided")]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FP32_BWD_CASES)
def test_fp32_attention_backward_matches_plain(cuda_device, case):
    """The fp32 dK/dV and dQ kernels against ``attention_bwd_plain`` within
    ATTN_BWD_TOL, from the plain forward's lse and Delta; one launch each
    a call, and a second launch bitwise equal."""
    b, sq, sk, h, d, causal, bias, layout = case
    step = 2 if layout == "strided" else 1
    q, k, v, do, dlse, key_bias = _attn_inputs(cuda_device, b, sq, sk, h,
                                               step * d, bias,
                                               torch.float32, sq + sk + d)
    q, k, v, do = (t[..., ::step] for t in (q, k, v, do))
    assert q.stride(-1) == step
    if bias:
        assert bool(att.dead_batch(key_bias)[-1])
    scale = d ** -0.5
    o_p, lse_p = att.attention_pair_plain(q, k, v, key_bias, causal, scale)
    dl = att.delta(o_p, do, dlse)
    bwd = (q, k, v, key_bias, causal, scale, do, lse_p, dl)
    kernels = (att.flash_attention_dkdv_cuda, att.flash_attention_dq_cuda)
    before = [fn.launches for fn in kernels]
    dk, dv = att.flash_attention_dkdv_cuda(*bwd)
    dq = att.flash_attention_dq_cuda(*bwd)
    again = att.flash_attention_dkdv_cuda(*bwd) + (
        att.flash_attention_dq_cuda(*bwd),)
    torch.cuda.synchronize()
    assert [fn.launches for fn in kernels] == [n + 2 for n in before]
    want = att.attention_bwd_plain(q, k, v, key_bias, causal, scale, o_p,
                                   lse_p, do, dlse)
    for name, got, ref in (("dq", dq, want[0]), ("dk", dk, want[1]),
                           ("dv", dv, want[2])):
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=att.ATTN_BWD_TOL,
                                   atol=att.ATTN_BWD_TOL, err_msg=name)
    for got, rep in zip((dk, dv, dq), again):
        assert torch.equal(got, rep)                  # bitwise repeat


@pytest.mark.cuda
@pytest.mark.parametrize("case", FP32_BWD_CASES)
def test_fp32_attention_forward_matches_plain(cuda_device, case):
    """The fp32 forward kernel against ``attention_pair_plain``: O and lse
    within ATTN_FWD_TOL at the backward's cases (D 8 and 128, lengths no
    tile divides, causal Sq < Sk, a dead batch element, strided and
    contiguous views); one launch a call, and a second launch bitwise
    equal."""
    b, sq, sk, h, d, causal, bias, layout = case
    step = 2 if layout == "strided" else 1
    q, k, v, _, _, key_bias = _attn_inputs(cuda_device, b, sq, sk, h,
                                           step * d, bias, torch.float32,
                                           2 * sq + sk + d)
    q, k, v = (t[..., ::step] for t in (q, k, v))
    assert q.stride(-1) == step
    if bias:
        assert bool(att.dead_batch(key_bias)[-1])
    scale = d ** -0.5
    before = att.flash_attention_cuda.launches
    o, lse = att.flash_attention_cuda(q, k, v, key_bias, causal, scale)
    again = att.flash_attention_cuda(q, k, v, key_bias, causal, scale)
    torch.cuda.synchronize()
    assert att.flash_attention_cuda.launches == before + 2
    o_p, lse_p = att.attention_pair_plain(q, k, v, key_bias, causal, scale)
    for name, got, ref in (("o", o, o_p), ("lse", lse, lse_p)):
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=att.ATTN_FWD_TOL,
                                   atol=att.ATTN_FWD_TOL, err_msg=name)
    for got, rep in zip((o, lse), again):
        assert torch.equal(got, rep)                  # bitwise repeat


@pytest.mark.cuda
def test_attention_kernels_raise_on_what_they_cannot_take(cuda_device):
    q = torch.zeros(1, 64, 2, 64, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 8"):
        att.flash_attention_cuda(q[..., :60], q[..., :60], q[..., :60])
    with pytest.raises(ValueError, match="Sq <= Sk"):
        att.flash_attention_cuda(q, q[:, :32], q[:, :32], causal=True)
    with pytest.raises(ValueError, match="lies on"):
        att.flash_attention_cuda(q, q.cpu(), q)


@pytest.mark.cuda
@pytest.mark.parametrize("with_lse", [False, True])
def test_attention_route_carries_the_gradient_as_the_cpu(cuda_device,
                                                         with_lse):
    """Through FlashAttentionFunction on the card: a grad_fn, one launch
    of each kernel, and the CPU route's gradients (strided views of a
    fused projection in, as the model hands them)."""
    gen = torch.Generator().manual_seed(21)
    qkv = torch.randn(2, 128, 3, 4, 32, generator=gen)
    do = torch.randn(2, 128, 4, 32, generator=gen)
    dlse = torch.randn(2, 4, 128, generator=gen)
    grads = []
    for device in ("cuda", "cpu"):
        x = qkv.to(device).requires_grad_()
        q, k, v = x.unbind(2)
        before = (att.flash_attention_cuda.launches,
                  att.flash_attention_dkdv_cuda.launches,
                  att.flash_attention_dq_cuda.launches)
        if with_lse:
            o, lse = att.flash_attention_with_lse(q, k, v, causal=True)
            torch.autograd.backward((o, lse), (do.to(device),
                                               dlse.to(device)))
        else:
            o = att.flash_attention(q, k, v, causal=True)
            assert o.grad_fn is not None
            o.backward(do.to(device))
        after = (att.flash_attention_cuda.launches,
                 att.flash_attention_dkdv_cuda.launches,
                 att.flash_attention_dq_cuda.launches)
        assert [a - b for a, b in zip(after, before)] == (
            [1, 1, 1] if device == "cuda" else [0, 0, 0])
        grads.append((o.detach().cpu(), x.grad.cpu()))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-5,
                                   atol=5e-5)


@pytest.mark.cuda
def test_gpt_flash_route_matches_the_dense_route_on_the_card(cuda_device):
    gen = torch.Generator().manual_seed(22)
    ids = torch.randint(0, 256, (2, 64), generator=gen).to(cuda_device)
    out = []
    for fused in (True, False):
        model = gpt_tiny(device=cuda_device, fused_attention=fused)
        before = att.flash_attention_cuda.launches
        logits = model(ids)
        logits.float().logsumexp(-1).mean().backward()
        assert att.flash_attention_cuda.launches - before == (
            model.num_layers if fused else 0)
        out.append([logits.detach().cpu()] + [
            p.grad.cpu() for p in model.parameters()])
    for a, b in zip(*out):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def card_ranks(tmp_path_factory):
    """Two processes on cuda:0 in a gloo group (tests/torch_dist_cases.py;
    NCCL refuses two ranks on one card): SyncBatchNorm in both branches
    on 2 x 4 rows of 3 x 3 x 6, and DistributedFusedAdam over a few
    tensors for three steps (the second with an inf planted in rank 1's
    grad); every wait bounded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import torch_dist_cases as cases
    rs = np.random.RandomState(0)
    shapes = [(300, 7), (7,), (1000,), (5, 3, 4)]
    spec = {"cases": ["card_syncbn_composite", "card_syncbn_fused",
                      "card_zero_adam"],
            "bn_x": (rs.randn(8, 3, 3, 6) * 2 + 0.5).astype(np.float32),
            "bn_w": rs.randn(8, 3, 3, 6).astype(np.float32),
            "bn_sd": {"scale": (1 + 0.1 * rs.randn(6)).astype(np.float32),
                      "bias": (0.1 * rs.randn(6)).astype(np.float32),
                      "mean": (0.2 * rs.randn(6)).astype(np.float32),
                      "var": (1 + 0.1 * rs.rand(6)).astype(np.float32)},
            "params": [(0.02 * rs.randn(*s)).astype(np.float32)
                       for s in shapes],
            "zero_grads": [[[(1e-3 * rs.randn(*s)).astype(np.float32)
                             for s in shapes] for _ in range(2)]
                           for _ in range(3)]}
    ranks = cases.Ranks(spec, tmp_path_factory.mktemp("card_ranks"), 2,
                        timeout=300)
    return spec, ranks.results()


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_syncbn_across_two_processes_on_the_card(card_ranks, fused):
    """Two ranks' SyncBatchNorm on the card against one process with the
    whole batch on the card: y, dx and the running statistics 1e-5,
    dscale and dbias (summed over the ranks) 1e-5 (fp32 sums over 72
    rows in another order); the fused branch launches each BatchNorm-sum
    kernel once a rank, the composite none."""
    spec, results = card_ranks
    got = [r["card_syncbn_fused" if fused else "card_syncbn_composite"]
           for r in results]
    m = SyncBatchNorm(6, fused_kernel=fused, device="cuda")
    m.load_state_dict({k: torch.from_numpy(v)
                       for k, v in spec["bn_sd"].items()})
    x = torch.from_numpy(spec["bn_x"]).cuda().requires_grad_()
    y = m(x)
    (y * torch.from_numpy(spec["bn_w"]).cuda()).sum().backward()
    want = {"y": y, "dx": x.grad, "mean": m.mean, "var": m.var,
            "dscale": m.scale.grad, "dbias": m.bias.grad}
    merged = {"y": np.concatenate([g["y"] for g in got]),
              "dx": np.concatenate([g["dx"] for g in got]),
              "dscale": sum(g["dscale"] for g in got),
              "dbias": sum(g["dbias"] for g in got),
              "mean": got[0]["mean"], "var": got[0]["var"]}
    for key, value in merged.items():
        np.testing.assert_allclose(value, want[key].detach().cpu().numpy(),
                                   rtol=FP32_TOL, atol=FP32_TOL,
                                   err_msg=key)
    for g in got:
        assert tuple(g["launches"]) == ((1, 1) if fused else (0, 0))


@pytest.mark.cuda
def test_distributed_fused_adam_across_two_processes_on_the_card(card_ranks):
    """Two ranks' DistributedFusedAdam on the card (the Adam kernel over
    each rank's shard) against FusedAdam in one process with the ranks'
    mean grads: every parameter rtol 1e-5 plus 1e-6 of the tensor's
    largest magnitude after each clean step; the step with the planted
    inf skipped by both ranks (parameters bitwise, the count kept); one
    Adam launch a step; both ranks' parameters bitwise equal."""
    import torch_dist_cases as cases
    spec, results = card_ranks
    got = [r["card_zero_adam"] for r in results]
    params = [torch.from_numpy(p).cuda() for p in spec["params"]]
    ref = FusedAdam(params, **cases.ADAM)
    for k, grads in enumerate(spec["zero_grads"]):
        if k != 1:
            with torch.no_grad():
                for p, a, b in zip(params, *grads):
                    p.grad.copy_(torch.from_numpy((a + b) / 2))
            ref.step()
        for g in got:
            assert g["count"][k] == (1 if k < 2 else 2)
            for mine, want in zip(g["params"][k], params):
                w = want.cpu().numpy()
                np.testing.assert_allclose(mine, w, rtol=1e-5,
                                           atol=1e-6 * np.abs(w).max())
        for a, b in zip(got[0]["params"][k], got[1]["params"][k]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(got[0]["params"][1], got[0]["params"][0]):
        np.testing.assert_array_equal(a, b)              # skipped
    assert [g["launches"] for g in got] == [3, 3]


# ------------------------------------------------------- the step options


@pytest.mark.cuda
def test_grad_accumulator_on_the_card_is_the_cpus(cuda_device):
    """engine.GradAccumulator at K = 4 over fp32 and bf16 grads: the scale
    kernel (1/4) and the axpby kernel (folds, then the mean) bitwise the
    CPU's plain versions (products by 1 and powers of two are exact)."""
    from apex_example_tpu_torch.engine import GradAccumulator
    rs = np.random.RandomState(4)
    shapes = [(65537,), (33, 7), (513, 129)]
    dtypes = [torch.float32, torch.bfloat16, torch.bfloat16]
    grads = [[rs.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(4)]
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        ps = [torch.nn.Parameter(torch.zeros(s, dtype=dt, device=dev))
              for s, dt in zip(shapes, dtypes)]
        opt = FusedSGD(ps, lr=0.1)
        acc = GradAccumulator(opt, 4)
        launches = (mt.multi_tensor_axpby_cuda.launches,
                    mt.multi_tensor_scale_cuda.launches)
        opt.zero_grad()
        acc.begin()
        for i, mb in enumerate(grads):
            with torch.no_grad():
                for p, g in zip(ps, mb):
                    p.grad += torch.from_numpy(g).to(dev, p.dtype)
            if i < 3:
                acc.fold()
        acc.finish()
        out[dev.type] = [p.grad.cpu() for p in ps]
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (mt.multi_tensor_axpby_cuda.launches - launches[0],
                    mt.multi_tensor_scale_cuda.launches - launches[1]) == \
                (4, 1)          # 3 folds and the mean of the bf16 table
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_remat_on_the_card_keeps_grads_and_statistics(cuda_device):
    """resnet18 (8 filters, 32 px) at --remat conv and block against none
    on the card, cuDNN's deterministic convolutions: grads and running
    statistics bitwise equal."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(8, 32, 32, 3, generator=gen).to(cuda_device)
    y = torch.randint(0, 10, (8,), generator=gen).to(cuda_device)
    cudnn = torch.backends.cudnn
    before = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        runs = {}
        for remat in ("none", "conv", "block"):
            m = resnet18(num_classes=10, num_filters=8, remat=remat,
                         device=cuda_device)
            torch.nn.functional.cross_entropy(m(x), y).backward()
            runs[remat] = ({k: v.cpu() for k, v in m.state_dict().items()},
                           [p.grad.cpu() for p in m.parameters()])
    finally:
        cudnn.benchmark, cudnn.deterministic = before
    for remat in ("conv", "block"):
        sd, grads = runs[remat]
        assert all(torch.equal(sd[k], v) for k, v in runs["none"][0].items())
        assert all(torch.equal(a, b) for a, b in zip(grads, runs["none"][1]))


@pytest.mark.cuda
def test_host_pipeline_batches_reach_the_card_bitwise(cuda_device):
    """--host-pipeline's batches (pinned, fresh buffers, non_blocking
    copies), five in a row without a sync, equal the CPU's."""
    from argparse import Namespace
    from apex_example_tpu_torch import train
    args = Namespace(arch="resnet18", dataset="cifar10", batch_size=64,
                     seed=3, host_pipeline=True)
    card = train.BatchSource(args, 0, cuda_device, 0, 1, 2)
    cpu = train.BatchSource(args, 0, "cpu", 0, 1, 2)
    try:
        got = [card.train(2 + i) for i in range(5)]
        want = [cpu.train(2 + i) for i in range(5)]
        torch.cuda.synchronize()
    finally:
        card.close()
        cpu.close()
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.is_cuda and torch.equal(gx.cpu(), wx)
        assert torch.equal(gy.cpu(), wy)
