"""The port's BatchNorm sums, its ``batch_norm_train`` autograd function and
its SyncBatchNorm held against the JAX package's, on the CPU.

The JAX side runs as its own tests run it: tests/conftest.py puts Pallas in
interpret mode, so ``bn_stats`` and ``bn_bwd_sums`` run the Pallas
``_stats_kernel`` and ``_bwd_sums_kernel`` (the row counts here tile by
8, as they need).  Inputs come from numpy with a fixed seed and go to both
sides.  Tolerances: per-channel sums rtol 1e-5, atol 1e-4 (fp32 sums over
the rows in another order); y and dx atol 1e-5 in fp32 and one bf16 ulp
(plus 1e-5) in bf16, dscale and dbias as the sums; the running statistics
rtol 1e-5, atol 1e-6.  The CUDA wrappers' refusals run on meta tensors:
they raise, never hand the tensors to a plain version, and build nothing.
The kernels themselves run on the card: tests/test_torch_cuda.py and
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_example_tpu.ops.batch_norm import batch_norm_train as jax_bn_train
from apex_example_tpu.ops.batch_norm import bn_bwd_sums as jax_bn_bwd_sums
from apex_example_tpu.ops.batch_norm import bn_stats as jax_bn_stats
from apex_example_tpu.parallel.sync_batchnorm import \
    SyncBatchNorm as JaxSyncBatchNorm
from apex_example_tpu_torch.ops import _build
from apex_example_tpu_torch.ops import batch_norm as bn
from apex_example_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm

SUM_RTOL, SUM_ATOL = 1e-5, 1e-4
IO_TOL = 1e-5


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    C = shape[-1]
    x = (rs.randn(*shape) * 2 + 1.5).astype(np.float32)
    dy = rs.randn(*shape).astype(np.float32)
    c = (rs.randn(C) * 0.5 + 1.5).astype(np.float32)
    mean = (c + 0.1 * rs.randn(C)).astype(np.float32)
    inv = (rs.rand(C) + 0.5).astype(np.float32)
    scale = (rs.rand(C) + 0.5).astype(np.float32)
    bias = (rs.randn(C) * 0.2).astype(np.float32)
    return x, dy, c, mean, inv, scale, bias


def _bf16_ulp_close(got, want):
    """Every element within one bf16 ulp of the larger magnitude, plus
    1e-5 (the rounding of results that cancel near zero)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0 ** -126)
    tol = 2.0 ** (np.floor(np.log2(mag)) - 7) + 1e-5
    assert np.all(np.abs(got - want) <= tol), float(
        np.max(np.abs(got - want) - tol))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,C", [(64, 16), (392, 24)])
def test_sums_plain_match_the_jax_kernels(dtype, rows, C):
    x, dy, c, mean, inv, _, _ = _inputs((rows, C), rows + C)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, jdy = jnp.asarray(x).astype(jdt), jnp.asarray(dy).astype(jdt)
    want = (jax_bn_stats(jx, jnp.asarray(c))
            + jax_bn_bwd_sums(jx, jdy, jnp.asarray(mean), jnp.asarray(inv)))
    tx, tdy = torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt)
    got = (bn.bn_stats_plain(tx, torch.from_numpy(c))
           + bn.bn_bwd_sums_plain(tx, tdy, torch.from_numpy(mean),
                                  torch.from_numpy(inv)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == (C,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=SUM_RTOL,
                                   atol=SUM_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_train_matches_the_jax_custom_vjp(dtype):
    x, dy, c, _, _, scale, bias = _inputs((4, 6, 6, 16), 3)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def fwd(x, s, b):
        return jax_bn_train(x, s, b, jnp.asarray(c), None, 1e-5, jnp.float32,
                            jdt)

    (jy, jmean, jvar), vjp = jax.vjp(
        fwd, jnp.asarray(x).astype(jdt), jnp.asarray(scale),
        jnp.asarray(bias))
    jdx, jds, jdb = vjp((jnp.asarray(dy).astype(jdt),
                         jnp.zeros_like(jmean), jnp.zeros_like(jvar)))

    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    y, mean, var = bn.batch_norm_train(tx, ts, tb, torch.from_numpy(c), 1e-5,
                                       torch.float32, tdt)
    assert y.dtype == tdt and not mean.requires_grad
    y.backward(torch.from_numpy(dy).to(tdt))
    for got, want in ((mean, jmean), (var, jvar)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    for got, want in ((ts.grad, jds), (tb.grad, jdb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=SUM_RTOL, atol=SUM_ATOL)
    for got, want in ((y, jy), (tx.grad, jdx)):
        got = got.detach().float().numpy()
        want = np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=IO_TOL, rtol=IO_TOL)
        else:
            _bf16_ulp_close(got, want)


def _module_run(m, x, dy):
    xg = x.clone().requires_grad_()
    y = m(xg)
    y.backward(dy)
    return [t.detach() for t in (y, xg.grad, m.scale.grad, m.bias.grad,
                                 m.mean, m.var)]


def test_fused_branch_matches_the_composite_branch():
    x, dy, _, _, _, scale, bias = _inputs((4, 5, 5, 24), 4)
    out = []
    for fused in (True, False):
        m = SyncBatchNorm(24, fused_kernel=fused, device="cpu")
        with torch.no_grad():
            m.scale.copy_(torch.from_numpy(scale))
            m.bias.copy_(torch.from_numpy(bias))
        out.append(_module_run(m, torch.from_numpy(x), torch.from_numpy(dy)))
        m.eval()
        out[-1].append(m(torch.from_numpy(x)).detach())
    for a, b in zip(*out):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True])
def test_sync_batch_norm_matches_the_jax_module(dtype, fused):
    x, dy, _, _, _, scale, bias = _inputs((4, 5, 5, 12), 5)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jm = JaxSyncBatchNorm(momentum=0.1, stats_dtype=jnp.float32,
                          fused_kernel=fused)
    jx = jnp.asarray(x).astype(jdt)
    stats = jm.init(jax.random.PRNGKey(0), jx,
                    use_running_average=False)["batch_stats"]
    stats = {"mean": jnp.asarray(np.full(12, 1.2, np.float32)),
             "var": stats["var"]}

    def loss(params, x):
        y, mut = jm.apply({"params": params, "batch_stats": stats}, x,
                          use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(dy)), (
            y, mut["batch_stats"])

    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    (_, (jy, jstats)), (jg, jdx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jx)
    jeval = jm.apply({"params": params, "batch_stats": jstats}, jx,
                     use_running_average=True)

    m = SyncBatchNorm(12, momentum=0.1, stats_dtype=torch.float32,
                      fused_kernel=fused, device="cpu")
    with torch.no_grad():
        m.scale.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.mean.fill_(1.2)
    y, dx, ds, db, rmean, rvar = _module_run(
        m, torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt))
    m.eval()
    y_eval = m(torch.from_numpy(x).to(tdt)).detach()
    assert y.dtype == y_eval.dtype == tdt
    for got, want in ((rmean, jstats["mean"]), (rvar, jstats["var"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    for got, want in ((ds, jg["scale"]), (db, jg["bias"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=SUM_RTOL, atol=SUM_ATOL)
    for got, want in ((y, jy), (y_eval, jeval), (dx, jdx)):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=IO_TOL, rtol=IO_TOL)
        else:
            _bf16_ulp_close(got, want)


def test_cross_device_statistics_are_refused():
    """Without a process group the cross-process statistics are refused
    where they would be taken, in both branches (tests/test_torch_parallel.py
    runs them across two processes)."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    for fused in (False, True):
        m = SyncBatchNorm(8, axis_name="data", fused_kernel=fused,
                          device="cpu")
        with pytest.raises(RuntimeError, match="process group"):
            m(torch.randn(4, 8))


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("rows,C", [(256 * 112 * 112, 64),
                                    (256 * 14 * 14, 1024),
                                    (256 * 7 * 7, 2048), (50171, 1024),
                                    (777, 37), (1, 3)])
def test_launch_geometry_covers_every_row_and_channel(rows, C, sms):
    """The persistent grid: at most ``sms * resident`` blocks (or one per
    slab), the slabs cover every channel, and no more row blocks than
    block rows, so every row block's share holds one at least (the
    kernel's split itself is checked on the card,
    test_torch_cuda.py::test_bn_sums_count_every_row_once)."""
    for vec in ((1, 4) if C % 4 == 0 else (1,)):
        for resident in (1, 3, 8):
            tx, n_rb = bn.geometry(rows, C, vec, sms, resident)
            assert tx in (1, 2, 4, 8, 16, 32)
            assert 1 <= n_rb <= 65535
            slabs = -(-C // (tx * vec))
            assert slabs * tx * vec >= C > (slabs - 1) * tx * vec
            assert slabs * n_rb <= max(sms * resident, slabs)
            assert n_rb <= -(-rows // (bn.THREADS // tx))


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.fixture
def no_build(monkeypatch):
    def refuse(name):
        raise AssertionError(f"argument checks must raise before {name} "
                             "is built")
    monkeypatch.setattr(_build, "load", refuse)


@pytest.mark.parametrize("call,err,match", [
    (lambda: bn.bn_stats(_meta(64, 16), _meta(16)), ValueError, "CUDA"),
    (lambda: bn.bn_bwd_sums(_meta(64, 16), _meta(64, 16), _meta(16),
                            _meta(16)), ValueError, "CUDA"),
    (lambda: bn.bn_stats_cuda(_meta(64, 16, dtype=torch.float64),
                              _meta(16)), TypeError, "float32"),
    (lambda: bn.bn_stats_cuda(_meta(64, 16), _meta(15)), ValueError,
     "shape"),
    (lambda: bn.bn_stats_cuda(_meta(4, 4, 16), _meta(16)), ValueError,
     "rows, C"),
    (lambda: bn.bn_bwd_sums_cuda(_meta(64, 16), _meta(64, 16).t().t()[:32],
                                 _meta(16), _meta(16)), ValueError,
     "match x"),
    (lambda: bn.bn_stats_cuda(_meta(16, 64).t(), _meta(16)), ValueError,
     "contiguous"),
])
def test_card_route_raises_and_never_takes_the_plain_version(
        no_build, monkeypatch, call, err, match):
    def no_plain(*a, **k):
        raise AssertionError("plain version ran for a non-CPU tensor")
    monkeypatch.setattr(bn, "bn_stats_plain", no_plain)
    monkeypatch.setattr(bn, "bn_bwd_sums_plain", no_plain)
    before = (bn.bn_stats_cuda.launches, bn.bn_bwd_sums_cuda.launches)
    with pytest.raises(err, match=match):
        call()
    assert (bn.bn_stats_cuda.launches, bn.bn_bwd_sums_cuda.launches) == \
        before


def test_fused_module_off_the_cpu_takes_the_kernels_or_raises(no_build,
                                                              monkeypatch):
    def no_plain(*a, **k):
        raise AssertionError("plain version ran for a non-CPU tensor")
    monkeypatch.setattr(bn, "bn_stats_plain", no_plain)
    m = SyncBatchNorm(16, fused_kernel=True, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        m(_meta(2, 4, 4, 16))
