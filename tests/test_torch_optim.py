"""The port's L2 norm, scale, clip, Adam, LAMB and SGD, FusedAdam,
FusedLAMB, FusedSGD and schedules held against the JAX package's.

The JAX side runs as its own tests run it: tests/conftest.py puts Pallas in
interpret mode, so ``_sqsum_leaf``, ``multi_tensor_scale``,
``adam_update_leaf``, ``lamb_stage1_leaf``, ``lamb_stage2_leaf`` and
``sgd_update_leaf`` run the Pallas ``_sqsum_kernel``, ``_scale_kernel``,
``_adam_kernel``, ``_lamb1_kernel``, ``_lamb2_kernel`` and ``_sgd_kernel``
through the interpreter.  Inputs
come from numpy with a fixed seed and go to both sides.  Tolerances: sums
of squares and norms rtol 1e-5 (fp32 sums in another order); the scale's
outputs exactly (one fp32 product each, then the same rounding); u, m, v
and p 1e-6 (the same fp32 arithmetic element by element); FusedLAMB's and
FusedAdam's p, m and v after three steps 1e-6; clipped grads 1e-6; SGD's p
and buf 1e-6 in every branch, with fp32 and bf16 p, and FusedSGD's over
five steps of a schedule.  The
CUDA wrappers' refusals run here on meta tensors: they raise, never hand
the tensors to a plain version, and build nothing.  The kernels themselves
run on the card: tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_example_tpu.ops.fused_optim import (adam_update_leaf,
                                              lamb_stage1_leaf,
                                              lamb_stage2_leaf,
                                              sgd_update_leaf)
from apex_example_tpu.ops.multi_tensor import (
    _sqsum_leaf, clip_grad_norm as jax_clip_grad_norm,
    multi_tensor_l2norm as jax_l2norm,
    multi_tensor_scale as jax_multi_tensor_scale)
from apex_example_tpu.optim.fused import FusedAdam as JaxAdam
from apex_example_tpu.optim.fused import FusedLAMB as JaxLAMB
from apex_example_tpu.optim.fused import FusedSGD as JaxSGD
from apex_example_tpu.optim.fused import \
    lamb_step_scalars as jax_step_scalars
from apex_example_tpu.optim.schedules import \
    build_schedule as jax_build_schedule
from apex_example_tpu_torch.ops import _build
from apex_example_tpu_torch.ops import fused_optim as fo
from apex_example_tpu_torch.ops import multi_tensor as mt
from apex_example_tpu_torch.optim import fused
from apex_example_tpu_torch.optim.schedules import build_schedule

NORM_TOL = 1e-5
STATE_TOL = 1e-6
SHAPES = {"a_w": (5, 130), "b_bias": (300,), "c_ln": (7,), "d_e": (3, 4, 9)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _arrays(seed, scale=1.0):
    rs = np.random.RandomState(seed)
    return {k: (rs.randn(*s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("shape", [(1,), (129,), (5, 130), (1024, 3)])
def test_sqsum_plain_matches_jax_kernel(shape):
    x = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    want = float(_sqsum_leaf(jnp.asarray(x)))
    got = mt.sqsum_plain(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=NORM_TOL)


def test_multi_tensor_l2norm_matches_jax():
    arrays = _arrays(1)
    want, want_each = jax_l2norm({k: jnp.asarray(a) for k, a in
                                  arrays.items()}, per_tensor=True)
    norm, sq = mt.multi_tensor_l2norm_plain(
        [torch.from_numpy(a) for a in arrays.values()])
    np.testing.assert_allclose(float(norm), float(want), rtol=NORM_TOL)
    np.testing.assert_allclose(torch.sqrt(sq).numpy(),
                               np.asarray(want_each), rtol=NORM_TOL)


@pytest.mark.parametrize("grad_scale", [1.0, 0.25])
def test_lamb_stages_plain_match_jax_kernels(grad_scale):
    rs = np.random.RandomState(2)
    p, g, m = (rs.randn(6, 140).astype(np.float32) for _ in range(3))
    v = rs.rand(6, 140).astype(np.float32)
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01,
                 bias_c1=1.0 / (1 - 0.9 ** 2), bias_c2=1.0 / (1 - 0.999 ** 2))
    want = lamb_stage1_leaf(*(jnp.asarray(a) for a in (p, g, m, v)),
                            grad_scale=grad_scale, **hyper)
    got = fo.lamb_stage1_plain(*(torch.from_numpy(a) for a in (p, g, m, v)),
                               grad_scale=grad_scale, **hyper)
    assert got[0].dtype == torch.float32
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=STATE_TOL,
                                   atol=STATE_TOL)
    for a, b in zip(got[3:], want[3:]):
        np.testing.assert_allclose(float(a), float(b), rtol=NORM_TOL)

    u = got[0].numpy()
    want2 = lamb_stage2_leaf(jnp.asarray(p), jnp.asarray(u), 3e-3)
    got2 = fo.lamb_stage2_plain(torch.from_numpy(p), torch.from_numpy(u),
                                3e-3)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2),
                               rtol=STATE_TOL, atol=STATE_TOL)


def test_trust_ratio_is_one_where_a_norm_is_zero():
    ratio = fo.trust_ratio_plain(torch.tensor([4.0, 0.0, 4.0]),
                                 torch.tensor([1.0, 1.0, 0.0]))
    np.testing.assert_array_equal(ratio.numpy(), [2.0, 1.0, 1.0])


def _port_lamb(params, lr):
    ps = [torch.nn.Parameter(torch.from_numpy(a.copy()))
          for a in params.values()]
    return ps, fused.FusedLAMB(ps, lr=lr, weight_decay=0.01)


@pytest.mark.parametrize("grad_scale,clips", [(1.0, True), (0.003, False)])
def test_fused_lamb_three_steps_match_jax(grad_scale, clips):
    params = _arrays(3)
    jlr = jax_build_schedule("poly", 2e-2, 6, warmup_steps=2)
    plr = build_schedule("poly", 2e-2, 6, warmup_steps=2)
    jopt = JaxLAMB(lr=jlr, weight_decay=0.01)
    jparams = {k: jnp.asarray(a) for k, a in params.items()}
    jstate = jopt.init(jparams)
    ps, popt = _port_lamb(params, plr)
    for step in range(3):
        grads = _arrays(10 + step, scale=grad_scale)
        gnorm = float(np.sqrt(sum((a.astype(np.float64) ** 2).sum()
                                  for a in grads.values())))
        assert (gnorm > popt.max_grad_norm) == clips
        jparams, jstate = jopt.apply({k: jnp.asarray(a) for k, a in
                                      grads.items()}, jstate, jparams)
        popt.zero_grad()
        for p, a in zip(ps, grads.values()):
            p.grad.add_(torch.from_numpy(a))
        got_norm = popt.step()
        np.testing.assert_allclose(float(got_norm), gnorm, rtol=NORM_TOL)
    assert popt.step_count == int(jstate.step) == 3
    names = list(params)
    for i, k in enumerate(names):
        for got, want in ((ps[i], jparams[k]), (popt.mu[i], jstate.mu[k]),
                          (popt.nu[i], jstate.nu[k])):
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), rtol=STATE_TOL,
                                       atol=STATE_TOL)


def test_step_scalars_match_jax():
    popt = _port_lamb(_arrays(0), 1e-3)[1]
    jopt = JaxLAMB(lr=1e-3)
    for step in (1, 2, 7, 100):
        got = fused.lamb_step_scalars(popt, step)
        want = jax_step_scalars(jopt, jnp.asarray(step, jnp.int32))
        np.testing.assert_allclose(got, [float(w) for w in want],
                                   rtol=1e-7)


def _port_adam(params, lr):
    ps = [torch.nn.Parameter(torch.from_numpy(a.copy()))
          for a in params.values()]
    return ps, fused.FusedAdam(ps, lr=lr, weight_decay=0.01)


def _port_sgd(params, lr):
    ps = [torch.nn.Parameter(torch.from_numpy(a.copy()))
          for a in params.values()]
    return ps, fused.FusedSGD(ps, lr=lr, momentum=0.9, weight_decay=1e-4)


@pytest.mark.parametrize("make", [_port_lamb, _port_adam, _port_sgd])
def test_grads_are_allocated_once_and_zeroed_in_place(make):
    ps, popt = make(_arrays(4), 1e-3)
    ptrs = [p.grad.data_ptr() for p in ps]
    for p in ps:
        p.grad.fill_(1.0)
    popt.zero_grad()
    assert [p.grad.data_ptr() for p in ps] == ptrs
    assert all(float(p.grad.abs().sum()) == 0.0 for p in ps)
    loss = sum((p * p).sum() for p in ps)
    loss.backward()
    assert [p.grad.data_ptr() for p in ps] == ptrs     # accumulated in place


@pytest.mark.parametrize("make", [_port_lamb, _port_adam])
def test_state_dict_round_trip(make):
    params = _arrays(5)
    ps, popt = make(params, 1e-2)
    for step in range(2):
        for p, a in zip(ps, _arrays(20 + step).values()):
            p.grad.copy_(torch.from_numpy(a))
        popt.step()
    saved = popt.state_dict()
    ps2, popt2 = make(params, 1e-2)
    mu_ptrs = [m.data_ptr() for m in popt2.mu]
    popt2.load_state_dict(saved)
    assert popt2.step_count == 2
    assert [m.data_ptr() for m in popt2.mu] == mu_ptrs
    for a, b in zip(popt.mu + popt.nu, popt2.mu + popt2.nu):
        assert torch.equal(a, b)
    with torch.no_grad():
        for p, q in zip(ps, ps2):
            q.copy_(p)
    for popt_, ps_ in ((popt, ps), (popt2, ps2)):
        for p, a in zip(ps_, _arrays(30).values()):
            p.grad.copy_(torch.from_numpy(a))
        popt_.step()
    for p, q in zip(ps, ps2):
        assert torch.equal(p, q)
    with pytest.raises(ValueError, match="moments"):
        popt2.load_state_dict({"step": 1, "mu": saved["mu"][:1],
                               "nu": saved["nu"][:1]})


@pytest.mark.parametrize("name", ["const", "step", "cosine", "poly"])
def test_schedules_match_jax(name):
    kw = dict(warmup_steps=3, min_lr=1e-4)
    got = build_schedule(name, 0.1, 20, **kw)
    want = jax_build_schedule(name, 0.1, 20, **kw)
    for step in range(1, 24):
        np.testing.assert_allclose(
            got(step), float(want(jnp.asarray(step, jnp.int32))),
            rtol=1e-6, atol=1e-9)
    assert build_schedule("const", 0.1, 20) == 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("planted", [None, np.inf, -np.inf, np.nan])
def test_multi_tensor_scale_plain_matches_jax(dtype, planted):
    arrays = _arrays(6)
    if planted is not None:
        arrays["b_bias"][17] = planted
    jtree = {k: jnp.asarray(a, dtype) for k, a in arrays.items()}
    want, want_finite = jax_multi_tensor_scale(jtree, 0.37)
    tdtype = getattr(torch, dtype)
    outs, finite = mt.multi_tensor_scale_plain(
        [torch.from_numpy(a).to(tdtype) for a in arrays.values()], 0.37)
    assert bool(finite) == bool(want_finite) == (planted is None)
    for got, k in zip(outs, arrays):
        assert got.dtype == tdtype
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want[k], np.float32))


@pytest.mark.parametrize("max_norm", [1e3, 0.25])
def test_clip_grad_norm_plain_matches_jax(max_norm):
    arrays = _arrays(7)
    want, want_norm = jax_clip_grad_norm(
        {k: jnp.asarray(a) for k, a in arrays.items()}, max_norm)
    grads = [torch.from_numpy(a.copy()) for a in arrays.values()]
    norm = mt.clip_grad_norm_plain(grads, max_norm)
    np.testing.assert_allclose(float(norm), float(want_norm), rtol=NORM_TOL)
    assert (float(norm) > max_norm) == (max_norm == 0.25)
    for got, k in zip(grads, arrays):
        np.testing.assert_allclose(got.numpy(), np.asarray(want[k]),
                                   rtol=STATE_TOL, atol=STATE_TOL)
    if max_norm > float(norm):          # below the limit: unchanged
        for got, a in zip(grads, arrays.values()):
            np.testing.assert_array_equal(got.numpy(), a)


def test_clip_scale_plain_propagates_nan():
    assert torch.isnan(mt.clip_scale_plain(torch.tensor(float("nan")), 1.0))
    assert float(mt.clip_scale_plain(torch.tensor(float("inf")), 1.0)) == 0.0


@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_adam_update_plain_matches_jax_kernel(adam_w_mode):
    rs = np.random.RandomState(8)
    p, g, m = (rs.randn(6, 140).astype(np.float32) for _ in range(3))
    v = rs.rand(6, 140).astype(np.float32)
    hyper = dict(lr=3e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=0.01, bias_c1=1.0 / (1 - 0.9 ** 3),
                 bias_c2=1.0 / (1 - 0.999 ** 3), adam_w_mode=adam_w_mode)
    want = adam_update_leaf(*(jnp.asarray(a) for a in (p, g, m, v)),
                            **hyper)
    got = fo.adam_update_plain(*(torch.from_numpy(a) for a in (p, g, m, v)),
                               **hyper)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=STATE_TOL)


@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_fused_adam_three_steps_match_jax(adam_w_mode):
    params = _arrays(9)
    jlr = jax_build_schedule("cosine", 1e-2, 6, warmup_steps=2)
    plr = build_schedule("cosine", 1e-2, 6, warmup_steps=2)
    jopt = JaxAdam(lr=jlr, weight_decay=0.05, adam_w_mode=adam_w_mode)
    jparams = {k: jnp.asarray(a) for k, a in params.items()}
    jstate = jopt.init(jparams)
    ps = [torch.nn.Parameter(torch.from_numpy(a.copy()))
          for a in params.values()]
    popt = fused.FusedAdam(ps, lr=plr, weight_decay=0.05,
                           adam_w_mode=adam_w_mode)
    for step in range(3):
        grads = _arrays(40 + step, scale=0.1)
        jparams, jstate = jopt.apply({k: jnp.asarray(a) for k, a in
                                      grads.items()}, jstate, jparams)
        popt.zero_grad()
        for p, a in zip(ps, grads.values()):
            p.grad.add_(torch.from_numpy(a))
        assert popt.step() is None
        np.testing.assert_allclose(
            float(popt.grad_norm()),
            np.sqrt(sum((a.astype(np.float64) ** 2).sum()
                        for a in grads.values())), rtol=NORM_TOL)
    assert popt.step_count == int(jstate.step) == 3
    for i, k in enumerate(params):
        for got, want in ((ps[i], jparams[k]), (popt.mu[i], jstate.mu[k]),
                          (popt.nu[i], jstate.nu[k])):
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), rtol=STATE_TOL,
                                       atol=STATE_TOL)


def test_fused_adam_refuses_amsgrad():
    with pytest.raises(ValueError, match="amsgrad"):
        fused.FusedAdam([torch.nn.Parameter(torch.zeros(2))], amsgrad=True)


def test_optimizer_clip_is_the_plain_clip_on_the_cpu():
    arrays = _arrays(12, scale=3.0)
    ps = [torch.nn.Parameter(torch.from_numpy(a.copy()))
          for a in arrays.values()]
    popt = fused.FusedAdam(ps)
    for p, a in zip(ps, arrays.values()):
        p.grad.copy_(torch.from_numpy(a))
    norm = popt.clip_grad_norm(0.5)
    want = [torch.from_numpy(a.copy()) for a in arrays.values()]
    want_norm = mt.clip_grad_norm_plain(want, 0.5)
    assert float(norm) == float(want_norm) > 0.5
    for p, w in zip(ps, want):
        assert torch.equal(p.grad, w)
    np.testing.assert_allclose(float(popt.grad_norm()), 0.5, rtol=NORM_TOL)


@pytest.mark.parametrize("numels", [[1], [0, 5], [65536, 65537, 3],
                                    [200000, 1, 131072]])
def test_chunk_table_covers_every_element_once(numels):
    offsets, ctensor, cstart, chunk0 = mt.chunk_table(numels)
    np.testing.assert_array_equal(offsets, np.cumsum([0] + numels))
    assert len(ctensor) == len(cstart) == chunk0[-1]
    for t, n in enumerate(numels):
        mine = np.arange(chunk0[t], chunk0[t + 1])
        assert (ctensor[mine] == t).all()
        covered = np.concatenate(
            [np.arange(s, min(s + mt.CHUNK, n)) for s in cstart[mine]]
            or [np.zeros(0, np.int64)])
        np.testing.assert_array_equal(covered, np.arange(n))


def test_tensor_table_layout_and_refresh():
    xs = [torch.zeros(3), torch.zeros(70000), torch.zeros(2, 2)]
    ys = [torch.ones_like(x) for x in xs]
    table = mt.TensorTable([xs, ys])
    buf = table.buffer.numpy()
    n, c = 3, table.n_chunks
    assert c == 1 + 2 + 1 and table.total == 70007
    args = table.args()
    base = table.buffer.data_ptr()
    assert [(a - base) // 8 for a in args[:5]] == [0, 6, 10, 10 + c,
                                                   10 + 2 * c]
    assert args[5:] == [n, c]
    assert list(buf[:6].view(np.uint64)) == \
        [t.data_ptr() for t in xs + ys]
    np.testing.assert_array_equal(buf[6:10], [0, 3, 70003, 70007])
    old = table.buffer
    table.refresh()
    assert table.buffer is old             # nothing moved: no rebuild
    xs[1].set_(torch.zeros(70000))
    table.refresh()
    assert table.buffer is not old
    assert table.buffer.numpy()[1].view(np.uint64) == xs[1].data_ptr()


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.fixture
def no_build(monkeypatch):
    def refuse(name):
        raise AssertionError(f"argument checks must raise before {name} "
                             "is built")
    monkeypatch.setattr(_build, "load", refuse)


def test_l2norm_raises_instead_of_falling_back(no_build, monkeypatch):
    def no_plain(*a, **k):
        raise AssertionError("plain version ran for a non-CPU tensor")
    monkeypatch.setattr(mt, "multi_tensor_l2norm_plain", no_plain)
    before = mt.multi_tensor_l2norm_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        mt.multi_tensor_l2norm_cuda(mt.TensorTable([[_meta(4),
                                                     _meta(3, 3)]]))
    with pytest.raises(TypeError, match="float32"):
        mt.multi_tensor_l2norm_cuda(mt.TensorTable(
            [[_meta(4, dtype=torch.float64)]]))
    assert mt.multi_tensor_l2norm_cuda.launches == before


def _meta_table(dtype=torch.float32, m_dtype=torch.float32):
    p = [_meta(8, 3, dtype=dtype), _meta(5, dtype=dtype)]
    return mt.TensorTable([p, [torch.empty_like(t) for t in p],
                           [_meta(8, 3, dtype=m_dtype),
                            _meta(5, dtype=m_dtype)],
                           [_meta(8, 3), _meta(5)]])


@pytest.mark.parametrize("make,err,match", [
    (lambda: (_meta_table(torch.float64), _meta(29)), TypeError, "float32"),
    (lambda: (_meta_table(m_dtype=torch.bfloat16), _meta(29)), TypeError,
     "m and v"),
    (lambda: (_meta_table(), _meta(28)), ValueError, "29 elements"),
    (lambda: (_meta_table(), _meta(29, dtype=torch.float16)), ValueError,
     "u must be"),
    (lambda: (_meta_table(), _meta(29)), ValueError, "CUDA"),
])
def test_lamb_wrappers_raise_on_what_they_cannot_take(no_build, make, err,
                                                      match):
    table, u = make()
    before = (fo.lamb_stage1_cuda.launches, fo.lamb_stage2_cuda.launches)
    with pytest.raises(err, match=match):
        fo.lamb_stage1_cuda(table, u, None, beta1=0.9, beta2=0.999, eps=1e-6,
                            weight_decay=0.0, bias_c1=1.0, bias_c2=1.0)
    with pytest.raises(err, match=match):
        fo.lamb_stage2_cuda(table, u, _meta(2), 1e-3)
    assert (fo.lamb_stage1_cuda.launches,
            fo.lamb_stage2_cuda.launches) == before


def test_fused_lamb_off_the_cpu_takes_the_kernels_or_raises(no_build,
                                                            monkeypatch):
    def no_plain(*a, **k):
        raise AssertionError("plain LAMB ran for non-CPU parameters")
    monkeypatch.setattr(fused, "lamb_update_leaf", no_plain)
    monkeypatch.setattr(fused, "multi_tensor_l2norm_plain", no_plain)
    ps = [torch.nn.Parameter(_meta(4, 4)), torch.nn.Parameter(_meta(4))]
    opt = fused.FusedLAMB(ps)
    assert all(p.grad is not None for p in ps)
    with pytest.raises(ValueError, match="CUDA"):
        opt.step()


@pytest.mark.parametrize("call,err,match", [
    (lambda t: mt.multi_tensor_scale_cuda(t, 0, 0, 0.5), ValueError, "CUDA"),
    (lambda t: mt.multi_tensor_scale_cuda(t, 0, 1, 0.5), TypeError,
     "share a dtype"),
    (lambda t: mt.multi_tensor_scale_cuda(t, 0, 0), ValueError,
     "neither"),
    (lambda t: mt.multi_tensor_scale_cuda(t, 0, 0, 0.5, norm=_meta(())),
     ValueError, "not both"),
    (lambda t: mt.multi_tensor_scale_cuda(t, 0, 0, norm=_meta(2)),
     ValueError, "norm must be"),
    (lambda t: mt.clip_grad_norm_cuda(t, 1.0, index=0), ValueError, "CUDA"),
])
def test_scale_wrapper_raises_instead_of_falling_back(no_build, monkeypatch,
                                                      call, err, match):
    def no_plain(*a, **k):
        raise AssertionError("plain version ran for a non-CPU tensor")
    for name in ("multi_tensor_scale_plain", "clip_grad_norm_plain",
                 "multi_tensor_l2norm_plain"):
        monkeypatch.setattr(mt, name, no_plain)
    table = mt.TensorTable([[_meta(4), _meta(3, 3)],
                            [_meta(4, dtype=torch.bfloat16),
                             _meta(3, 3, dtype=torch.bfloat16)]])
    before = (mt.multi_tensor_scale_cuda.launches,
              mt.multi_tensor_l2norm_cuda.launches)
    with pytest.raises(err, match=match):
        call(table)
    assert (mt.multi_tensor_scale_cuda.launches,
            mt.multi_tensor_l2norm_cuda.launches) == before


@pytest.mark.parametrize("make,err,match", [
    (lambda: _meta_table(torch.float64), TypeError, "float32"),
    (lambda: _meta_table(m_dtype=torch.bfloat16), TypeError, "m and v"),
    (lambda: mt.TensorTable(_meta_table().lists[:3]), ValueError,
     "4 lists"),
    (lambda: _meta_table(), ValueError, "CUDA"),
])
def test_adam_wrapper_raises_on_what_it_cannot_take(no_build, make, err,
                                                    match):
    before = fo.adam_cuda.launches
    with pytest.raises(err, match=match):
        fo.adam_cuda(make(), lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                     weight_decay=0.0, bias_c1=1.0, bias_c2=1.0)
    assert fo.adam_cuda.launches == before


def test_fused_adam_off_the_cpu_takes_the_kernels_or_raises(no_build,
                                                            monkeypatch):
    def no_plain(*a, **k):
        raise AssertionError("plain Adam ran for non-CPU parameters")
    for name in ("adam_update_plain", "clip_grad_norm_plain",
                 "multi_tensor_l2norm_plain"):
        monkeypatch.setattr(fused, name, no_plain)
    ps = [torch.nn.Parameter(_meta(4, 4)), torch.nn.Parameter(_meta(4))]
    opt = fused.FusedAdam(ps)
    assert opt.table is not None and all(p.grad is not None for p in ps)
    for call in (opt.step, opt.grad_norm, lambda: opt.clip_grad_norm(1.0)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


SGD_BRANCHES = [{}, {"nesterov": True}, {"first_step": True},
                {"dampening": 0.3}, {"weight_decay": 0.0},
                {"nesterov": True, "first_step": True}]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("branch", SGD_BRANCHES)
def test_sgd_update_plain_matches_jax_kernel(dtype, branch):
    rs = np.random.RandomState(11)
    p = (rs.randn(5, 130) * 0.1).astype(np.float32)
    g = (rs.randn(5, 130) * 1e-2).astype(np.float32)
    b = (rs.randn(5, 130) * 1e-2).astype(np.float32)
    hyper = dict(dict(lr=0.1, momentum=0.9, weight_decay=1e-4), **branch)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp, jb = sgd_update_leaf(jnp.asarray(p).astype(jdt),
                             jnp.asarray(g).astype(jdt), jnp.asarray(b),
                             **hyper)
    tp, tb = fo.sgd_update_plain(torch.from_numpy(p).to(tdt),
                                 torch.from_numpy(g).to(tdt),
                                 torch.from_numpy(b), **hyper)
    assert tp.dtype == tdt and tb.dtype == torch.float32
    for got, want in ((tp, jp), (tb, jb)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=0,
                                   atol=STATE_TOL)


def test_fused_sgd_five_steps_of_a_schedule_match_jax():
    params = _arrays(6)
    kw = dict(boundaries=[2, 4], gamma=0.5, warmup_steps=1)
    jopt = JaxSGD(lr=jax_build_schedule("step", 0.1, 5, **kw), momentum=0.9,
                  weight_decay=1e-4, nesterov=True)
    jparams = {k: jnp.asarray(a) for k, a in params.items()}
    jstate = jopt.init(jparams)
    ps = [torch.nn.Parameter(torch.from_numpy(a.copy()))
          for a in params.values()]
    popt = fused.FusedSGD(ps, lr=build_schedule("step", 0.1, 5, **kw),
                          momentum=0.9, weight_decay=1e-4, nesterov=True)
    for step in range(5):
        grads = _arrays(40 + step, scale=0.1)
        jparams, jstate = jopt.apply({k: jnp.asarray(a) for k, a in
                                      grads.items()}, jstate, jparams)
        popt.zero_grad()
        for p, a in zip(ps, grads.values()):
            p.grad.add_(torch.from_numpy(a))
        assert popt.step() is None                 # SGD takes no norm
        for i, k in enumerate(params):
            for got, want in ((ps[i], jparams[k]),
                              (popt.momentum_buffer[i],
                               jstate.momentum[k])):
                np.testing.assert_allclose(got.detach().numpy(),
                                           np.asarray(want), rtol=STATE_TOL,
                                           atol=STATE_TOL)
    assert popt.step_count == int(jstate.step) == 5


def test_fused_sgd_noop_flag_keeps_params_buffers_and_step():
    ps, popt = _port_sgd(_arrays(7), build_schedule(
        "step", 0.1, 6, boundaries=[1, 2], gamma=0.5))
    for p, a in zip(ps, _arrays(8).values()):
        p.grad.copy_(torch.from_numpy(a))
    popt.step()
    before = [t.detach().clone() for t in ps + popt.momentum_buffer]
    lr_before = float(popt.lr_tensor())
    popt.step(noop_flag=torch.tensor(1, dtype=torch.int32))
    assert popt.step_count == 1 and float(popt.lr_tensor()) == lr_before
    for a, b in zip(ps + popt.momentum_buffer, before):
        assert torch.equal(a, b)
    popt.step(noop_flag=torch.tensor(0, dtype=torch.int32))
    assert popt.step_count == 2
    assert float(popt.lr_tensor()) == np.float32(0.025)
    assert not torch.equal(ps[0], before[0])


def test_fused_sgd_state_dict_round_trip():
    params = _arrays(5)
    ps, popt = _port_sgd(params, 1e-2)
    for step in range(2):
        for p, a in zip(ps, _arrays(20 + step).values()):
            p.grad.copy_(torch.from_numpy(a))
        popt.step()
    saved = popt.state_dict()
    assert saved["step"] == 2 and set(saved) == {"step", "momentum_buffer"}
    ps2, popt2 = _port_sgd(params, 1e-2)
    ptrs = [b.data_ptr() for b in popt2.momentum_buffer]
    popt2.load_state_dict(saved)
    assert popt2.step_count == 2
    assert [b.data_ptr() for b in popt2.momentum_buffer] == ptrs
    for a, b in zip(popt.momentum_buffer, popt2.momentum_buffer):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="momentum_buffer"):
        popt2.load_state_dict({"step": 1, "momentum_buffer":
                               saved["momentum_buffer"][:1]})


def test_optimizers_group_parameters_by_dtype():
    ps = [torch.nn.Parameter(_meta(4, 4, dtype=torch.bfloat16)),
          torch.nn.Parameter(_meta(4)),
          torch.nn.Parameter(_meta(3, dtype=torch.bfloat16))]
    sgd = fused.FusedSGD(ps, lr=0.1)
    assert sgd.groups == [[0, 2], [1]] and len(sgd.tables) == 2
    assert [t.dtype(0) for t in sgd.tables] == [torch.bfloat16,
                                                torch.float32]
    with pytest.raises(ValueError, match="one dtype"):
        fused.FusedAdam(ps).table


def _meta_sgd_table(dtype=torch.float32, b_dtype=torch.float32, lists=3):
    p = [_meta(8, 3, dtype=dtype), _meta(5, dtype=dtype)]
    tensors = [p, [torch.empty_like(t) for t in p],
               [_meta(8, 3, dtype=b_dtype), _meta(5, dtype=b_dtype)]]
    return mt.TensorTable(tensors[:lists])


@pytest.mark.parametrize("make,kw,err,match", [
    (lambda: _meta_sgd_table(lists=2), {}, ValueError, "3 lists"),
    (lambda: _meta_sgd_table(b_dtype=torch.bfloat16), {}, TypeError,
     "momentum buffers"),
    (lambda: _meta_sgd_table(torch.float64), {}, TypeError, "float32"),
    (_meta_sgd_table, dict(lr_t=_meta(1, dtype=torch.float16)), ValueError,
     "lr_t"),
    (_meta_sgd_table, dict(noop_flag=_meta(())), ValueError, "noop_flag"),
    (_meta_sgd_table, {}, ValueError, "CUDA"),
])
def test_sgd_wrapper_raises_on_what_it_cannot_take(no_build, make, kw, err,
                                                   match):
    before = fo.sgd_cuda.launches
    with pytest.raises(err, match=match):
        fo.sgd_cuda(make(), lr=0.1, momentum=0.9, weight_decay=0.0, **kw)
    assert fo.sgd_cuda.launches == before


def test_fused_sgd_off_the_cpu_takes_the_kernels_or_raises(no_build,
                                                           monkeypatch):
    def no_plain(*a, **k):
        raise AssertionError("plain SGD ran for non-CPU parameters")
    for name in ("sgd_update_plain", "multi_tensor_scale_plain",
                 "multi_tensor_l2norm_plain"):
        monkeypatch.setattr(fused, name, no_plain)
    ps = [torch.nn.Parameter(_meta(4, 4)), torch.nn.Parameter(_meta(4))]
    opt = fused.FusedSGD(ps, lr=0.1, momentum=0.9)
    for call in (opt.step, opt.grad_norm,
                 lambda: opt.unscale_grads(_meta(()))):
        with pytest.raises(ValueError, match="CUDA"):
            call()
