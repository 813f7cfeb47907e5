"""The port's L2 norm, scale, clip, axpby, Adam, LAMB, SGD, NovoGrad and
Adagrad, FusedAdam, FusedLAMB, FusedSGD, FusedNovoGrad, FusedAdagrad and
schedules held against the JAX package's.

The JAX side runs as its own tests run it: tests/conftest.py puts Pallas in
interpret mode, so ``_sqsum_leaf``, ``multi_tensor_scale``,
``adam_update_leaf``, ``lamb_stage1_leaf``, ``lamb_stage2_leaf``,
``sgd_update_leaf``, ``novograd_update_leaf``, ``adagrad_update_leaf`` and
``multi_tensor_axpby`` run the Pallas ``_sqsum_kernel``, ``_scale_kernel``,
``_adam_kernel``, ``_lamb1_kernel``, ``_lamb2_kernel``, ``_sgd_kernel``,
``_novograd_kernel``, ``_adagrad_kernel`` and ``_axpby_kernel`` through the
interpreter; each multi-step trail jits the JAX optimizer's ``apply`` once
(the interpreter traces its kernels once, not at every step).  Inputs
come from numpy with a fixed seed and go to both sides.  Tolerances: sums
of squares and norms rtol 1e-5 (fp32 sums in another order); the scale's
outputs exactly (one fp32 product each, then the same rounding); u, m, v
and p 1e-6 (the same fp32 arithmetic element by element); FusedLAMB's and
FusedAdam's p, m and v after three steps 1e-6; clipped grads 1e-6; SGD's p
and buf 1e-6 in every branch, with fp32 and bf16 p, and FusedSGD's over
five steps of a schedule; NovoGrad's, Adagrad's and axpby's plain versions
1e-6 in fp32 and one bf16 ulp in bf16 (the same fp32 arithmetic, one
rounding); FusedNovoGrad's and FusedAdagrad's params and state after five
steps rtol 1e-4 (norms summed in another order, compounding), from a
fresh state, from a converted JAX state and across a skipped first
step.  The
CUDA wrappers' refusals run here on meta tensors: they raise, never hand
the tensors to a plain version, and build nothing.  The kernels themselves
run on the card: tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_example_tpu.ops.fused_optim import (adagrad_update_leaf,
                                              adam_update_leaf,
                                              lamb_stage1_leaf,
                                              lamb_stage2_leaf,
                                              novograd_update_leaf,
                                              sgd_update_leaf)
from apex_example_tpu.ops.multi_tensor import (
    _sqsum_leaf, clip_grad_norm as jax_clip_grad_norm,
    multi_tensor_axpby as jax_axpby,
    multi_tensor_l2norm as jax_l2norm,
    multi_tensor_scale as jax_multi_tensor_scale)
from apex_example_tpu.optim.fused import FusedAdagrad as JaxAdagrad
from apex_example_tpu.optim.fused import FusedAdam as JaxAdam
from apex_example_tpu.optim.fused import FusedLAMB as JaxLAMB
from apex_example_tpu.optim.fused import FusedNovoGrad as JaxNovoGrad
from apex_example_tpu.optim.fused import FusedSGD as JaxSGD
from apex_example_tpu.optim.fused import \
    lamb_step_scalars as jax_step_scalars
from apex_example_tpu.optim.schedules import \
    build_schedule as jax_build_schedule
from apex_example_tpu_torch.convert import optimizer_state_from_jax
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
    japply = jax.jit(jopt.apply)     # traced once
    ps, popt = _port_lamb(params, plr)
    for step in range(3):
        grads = _arrays(10 + step, scale=grad_scale)
        gnorm = float(np.sqrt(sum((a.astype(np.float64) ** 2).sum()
                                  for a in grads.values())))
        assert (gnorm > popt.max_grad_norm) == clips
        jparams, jstate = japply({k: jnp.asarray(a) for k, a in
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


ADAM_LAMB = {"adam": (JaxAdam, lambda params, lr: _port_adam(params, lr)),
             "lamb": (JaxLAMB, lambda params, lr: _port_lamb(params, lr))}


@pytest.mark.parametrize("name", ["adam", "lamb"])
def test_fused_adam_and_lamb_skip_a_flagged_step_as_jax_selects(name):
    """A step under a set noop flag (its grads hold an inf) leaves the
    parameters, m, v and the step count bitwise as they were, as JAX's
    ``select_tree`` of the old params and state does; the clean steps
    around it equal JAX's three clean steps (the bias corrections and the
    schedule's lr from the count the skip kept): rtol and atol 1e-6."""
    jcls, make = ADAM_LAMB[name]
    params = _arrays(6)
    jopt = jcls(lr=jax_build_schedule("poly", 2e-2, 6, warmup_steps=2),
                weight_decay=0.01)
    jparams = {k: jnp.asarray(a) for k, a in params.items()}
    jstate = jopt.init(jparams)
    japply = jax.jit(jopt.apply)     # traced once
    ps, popt = make(params, build_schedule("poly", 2e-2, 6, warmup_steps=2))
    state = lambda: [t.detach().clone() for t in                # noqa: E731
                     ps + popt.mu + popt.nu]
    for step in range(3):
        grads = _arrays(50 + step, scale=0.1)
        jparams, jstate = japply({k: jnp.asarray(a) for k, a in
                                  grads.items()}, jstate, jparams)
        popt.zero_grad()
        for p, a in zip(ps, grads.values()):
            p.grad.add_(torch.from_numpy(a))
        popt.step(noop_flag=torch.tensor(0, dtype=torch.int32))
        if step == 0:
            before = state()
            popt.zero_grad()
            ps[1].grad[3] = float("inf")
            popt.step(noop_flag=torch.tensor(1, dtype=torch.int32))
            assert popt.step_count == 1
            assert all(torch.equal(a, b) for a, b in zip(state(), before))
    assert popt.step_count == int(jstate.step) == 3
    for i, k in enumerate(params):
        for got, want in ((ps[i], jparams[k]), (popt.mu[i], jstate.mu[k]),
                          (popt.nu[i], jstate.nu[k])):
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), rtol=STATE_TOL,
                                       atol=STATE_TOL)


@pytest.mark.parametrize("name", ["adam", "lamb"])
def test_fused_adam_and_lamb_take_mixed_dtypes_as_jax_leaf_by_leaf(name):
    """Two bf16 and two fp32 parameters (amp O3's mix), three steps against
    the JAX optimizer's leaf-by-leaf update: m and v rtol 1e-5 (LAMB's
    global grad norm sums the tensors in another order), fp32 p 1e-6, bf16
    p one bf16 ulp (the same fp32 arithmetic, then one rounding)."""
    jcls, _ = ADAM_LAMB[name]
    half = ("a_w", "d_e")
    cast = lambda k, a: (jnp.asarray(a).astype(jnp.bfloat16)    # noqa
                         if k in half else jnp.asarray(a))
    params = _arrays(7)
    jopt = jcls(lr=1e-2, weight_decay=0.01)
    jparams = {k: cast(k, a) for k, a in params.items()}
    jstate = jopt.init(jparams)
    japply = jax.jit(jopt.apply)     # traced once
    ps = [torch.nn.Parameter(torch.from_numpy(a.copy()).to(
        torch.bfloat16 if k in half else torch.float32))
        for k, a in params.items()]
    popt = (fused.FusedAdam if name == "adam" else fused.FusedLAMB)(
        ps, lr=1e-2, weight_decay=0.01)
    assert popt.groups == [[0, 3], [1, 2]]
    for step in range(3):
        grads = _arrays(60 + step, scale=0.5)
        jparams, jstate = japply({k: cast(k, a) for k, a in
                                  grads.items()}, jstate, jparams)
        popt.zero_grad()
        for p, (k, a) in zip(ps, grads.items()):
            p.grad.copy_(torch.from_numpy(a))
        popt.step()
    for i, k in enumerate(params):
        assert ps[i].dtype == (torch.bfloat16 if k in half
                               else torch.float32)
        np.testing.assert_allclose(
            ps[i].detach().float().numpy(),
            np.asarray(jparams[k], np.float32),
            rtol=2.0 ** -8 if k in half else STATE_TOL, atol=STATE_TOL)
        for got, want in ((popt.mu[i], jstate.mu[k]),
                          (popt.nu[i], jstate.nu[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=NORM_TOL, atol=STATE_TOL)


def _port_adam(params, lr):
    ps = [torch.nn.Parameter(torch.from_numpy(a.copy()))
          for a in params.values()]
    return ps, fused.FusedAdam(ps, lr=lr, weight_decay=0.01)


def _port_sgd(params, lr):
    ps = [torch.nn.Parameter(torch.from_numpy(a.copy()))
          for a in params.values()]
    return ps, fused.FusedSGD(ps, lr=lr, momentum=0.9, weight_decay=1e-4)


def _port_novograd(params, lr):
    ps = [torch.nn.Parameter(torch.from_numpy(a.copy()))
          for a in params.values()]
    return ps, fused.FusedNovoGrad(ps, lr=lr, weight_decay=0.01)


def _port_adagrad(params, lr):
    ps = [torch.nn.Parameter(torch.from_numpy(a.copy()))
          for a in params.values()]
    return ps, fused.FusedAdagrad(ps, lr=lr, weight_decay=0.01)


@pytest.mark.parametrize("make", [_port_lamb, _port_adam, _port_sgd,
                                  _port_novograd, _port_adagrad])
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


@pytest.mark.parametrize("make", [_port_lamb, _port_adam, _port_novograd,
                                  _port_adagrad])
def test_state_dict_round_trip(make):
    params = _arrays(5)
    ps, popt = make(params, 1e-2)
    for step in range(2):
        for p, a in zip(ps, _arrays(20 + step).values()):
            p.grad.copy_(torch.from_numpy(a))
        popt.step()
    saved = popt.state_dict()
    names = [k for k in saved if k != "step"]
    assert names == list(popt.state_names) + (
        ["nu"] if make is _port_novograd else [])
    ps2, popt2 = make(params, 1e-2)
    state = lambda opt: [t for n in names                 # noqa: E731
                         for t in getattr(opt, n)]
    ptrs = [t.data_ptr() for t in state(popt2)]
    popt2.load_state_dict(saved)
    assert popt2.step_count == 2
    assert [t.data_ptr() for t in state(popt2)] == ptrs
    for a, b in zip(state(popt), state(popt2)):
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
        popt2.load_state_dict({"step": 1, **{n: saved[n][:1]
                                             for n in names}})


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
    japply = jax.jit(jopt.apply)     # traced once
    ps = [torch.nn.Parameter(torch.from_numpy(a.copy()))
          for a in params.values()]
    popt = fused.FusedAdam(ps, lr=plr, weight_decay=0.05,
                           adam_w_mode=adam_w_mode)
    for step in range(3):
        grads = _arrays(40 + step, scale=0.1)
        jparams, jstate = japply({k: jnp.asarray(a) for k, a in
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
                            weight_decay=0.0, scalars_t=_meta(3))
    with pytest.raises(err, match=match):
        fo.lamb_stage2_cuda(table, u, _meta(2), _meta(3))
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
        fo.adam_cuda(make(), beta1=0.9, beta2=0.999, eps=1e-8,
                     weight_decay=0.0, scalars_t=_meta(3))
    assert fo.adam_cuda.launches == before


@pytest.mark.parametrize("kw,match", [
    (lambda: dict(scalars_t=_meta(2)), "scalars_t"),
    (lambda: dict(scalars_t=_meta(3, dtype=torch.float16)), "scalars_t"),
    (lambda: dict(scalars_t=_meta(3), noop_flag=_meta(())), "noop_flag"),
    (lambda: dict(scalars_t=_meta(3),
                  noop_flag=_meta(2, dtype=torch.int32)), "noop_flag"),
])
def test_adam_and_lamb_wrappers_check_the_step_row_and_the_flag(no_build, kw,
                                                                match):
    table, u, extra = _meta_table(), _meta(29), kw()
    calls = (
        lambda: fo.adam_cuda(table, beta1=0.9, beta2=0.999, eps=1e-8,
                             weight_decay=0.0, **extra),
        lambda: fo.lamb_stage1_cuda(table, u, None, beta1=0.9, beta2=0.999,
                                    eps=1e-6, weight_decay=0.0, **extra),
        lambda: fo.lamb_stage2_cuda(table, u, _meta(2), **extra))
    before = (fo.adam_cuda.launches, fo.lamb_stage1_cuda.launches,
              fo.lamb_stage2_cuda.launches)
    for call in calls:
        with pytest.raises(ValueError, match=match):
            call()
    assert (fo.adam_cuda.launches, fo.lamb_stage1_cuda.launches,
            fo.lamb_stage2_cuda.launches) == before


def test_fused_adam_off_the_cpu_takes_the_kernels_or_raises(no_build,
                                                            monkeypatch):
    def no_plain(*a, **k):
        raise AssertionError("plain Adam ran for non-CPU parameters")
    for name in ("adam_update_plain", "clip_grad_norm_plain",
                 "multi_tensor_l2norm_plain"):
        monkeypatch.setattr(fused, name, no_plain)
    ps = [torch.nn.Parameter(_meta(4, 4)), torch.nn.Parameter(_meta(4))]
    opt = fused.FusedAdam(ps)
    assert len(opt.tables) == 1 and all(p.grad is not None for p in ps)
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
    japply = jax.jit(jopt.apply)     # traced once
    ps = [torch.nn.Parameter(torch.from_numpy(a.copy()))
          for a in params.values()]
    popt = fused.FusedSGD(ps, lr=build_schedule("step", 0.1, 5, **kw),
                          momentum=0.9, weight_decay=1e-4, nesterov=True)
    for step in range(5):
        grads = _arrays(40 + step, scale=0.1)
        jparams, jstate = japply({k: jnp.asarray(a) for k, a in
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
    for opt in (fused.FusedNovoGrad(ps), fused.FusedAdagrad(ps)):
        assert opt.groups == [[0, 2], [1]]
        assert [t.dtype(0) for t in opt.tables] == [torch.bfloat16,
                                                    torch.float32]
        assert [len(t.lists) for t in opt.tables] == [3, 3]
    novograd = fused.FusedNovoGrad(ps)
    assert [v.numel() for v in novograd._v] == [2, 1]
    assert novograd.nu[1].data_ptr() == novograd._v[1].data_ptr()
    for opt in (fused.FusedAdam(ps), fused.FusedLAMB(ps)):
        assert opt.groups == [[0, 2], [1]]
        assert [t.dtype(0) for t in opt.tables] == [torch.bfloat16,
                                                    torch.float32]
        assert [len(t.lists) for t in opt.tables] == [4, 4]
    assert [u.numel() for u in fused.FusedLAMB(ps)._u] == [19, 4]


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


def _ulp_close(got, want, dtype):
    """fp32: 1e-6 (rtol and atol); bf16: one bf16 ulp of the larger
    magnitude."""
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(want, np.float32).astype(np.float64)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=STATE_TOL, atol=STATE_TOL)
        return
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0 ** -126)
    assert np.all(np.abs(got - want) <= 2.0 ** (np.floor(np.log2(mag)) - 7))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ga", [0.05, 1.0])
def test_novograd_update_plain_matches_jax_kernel(dtype, ga):
    rs = np.random.RandomState(13)
    p, g, m = (rs.randn(6, 140).astype(np.float32) * s
               for s in (0.1, 1e-2, 1e-3))
    hyper = dict(inv_denom=np.float32(7.3), lr_c1=np.float32(0.02 / 0.05),
                 beta1=0.95, weight_decay=0.01, grad_avg_coeff=ga)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp, jm = novograd_update_leaf(jnp.asarray(p).astype(jdt),
                                  jnp.asarray(g).astype(jdt),
                                  jnp.asarray(m), **hyper)
    tp, tm = fo.novograd_update_plain(
        torch.from_numpy(p).to(tdt), torch.from_numpy(g).to(tdt),
        torch.from_numpy(m), **dict(hyper, inv_denom=float(7.3)))
    assert tp.dtype == tdt and tm.dtype == torch.float32
    _ulp_close(tp, jp, dtype)
    _ulp_close(tm, jm, "float32")


@pytest.mark.parametrize("first_step,init_zero", [(True, False),
                                                  (False, False),
                                                  (True, True)])
def test_novograd_moment_plain_is_the_jax_optimizers(first_step, init_zero):
    # apex_example_tpu/optim/fused.py:252-259, written out in jnp
    rs = np.random.RandomState(14)
    sq = (rs.rand(9) * 3).astype(np.float32)
    v = (rs.rand(9) * 2).astype(np.float32)
    c2 = np.float32(1.0) / (np.float32(1.0) - np.float32(0.98) ** 3)
    jv = (jnp.asarray(sq) if first_step and not init_zero
          else 0.98 * jnp.asarray(v) + (1.0 - 0.98) * jnp.asarray(sq))
    jinv = 1.0 / (jnp.sqrt(jv * c2) + 1e-8)
    tv, tinv = fo.novograd_moment_plain(
        torch.from_numpy(sq), torch.from_numpy(v), beta2=0.98, eps=1e-8,
        c2=float(c2), first_step=first_step, init_zero=init_zero)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-7)
    np.testing.assert_allclose(tinv.numpy(), np.asarray(jinv), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w_mode", [False, True])
def test_adagrad_update_plain_matches_jax_kernel(dtype, w_mode):
    rs = np.random.RandomState(15)
    p = (rs.randn(6, 140) * 0.1).astype(np.float32)
    g = (rs.randn(6, 140) * 1e-2).astype(np.float32)
    h = (rs.rand(6, 140) * 1e-3).astype(np.float32)
    hyper = dict(lr=0.01, eps=1e-10, weight_decay=0.05,
                 adagrad_w_mode=w_mode)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp, jh = adagrad_update_leaf(jnp.asarray(p).astype(jdt),
                                 jnp.asarray(g).astype(jdt), jnp.asarray(h),
                                 **hyper)
    tp, th = fo.adagrad_update_plain(torch.from_numpy(p).to(tdt),
                                     torch.from_numpy(g).to(tdt),
                                     torch.from_numpy(h), **hyper)
    assert tp.dtype == tdt and th.dtype == torch.float32
    _ulp_close(tp, jp, dtype)
    _ulp_close(th, jh, "float32")


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("y_dtype", ["float32", "bfloat16", "float16"])
def test_multi_tensor_axpby_plain_matches_jax(x_dtype, y_dtype):
    xs, ys = _arrays(16), _arrays(17)
    jx = {k: jnp.asarray(a).astype(x_dtype) for k, a in xs.items()}
    jy = {k: jnp.asarray(a).astype(y_dtype) for k, a in ys.items()}
    want = jax_axpby(0.7, jx, -1.3, jy)
    got = mt.multi_tensor_axpby(
        0.7, [torch.from_numpy(np.array(jx[k], np.float32)).to(
            getattr(torch, x_dtype)) for k in xs],
        -1.3, [torch.from_numpy(np.array(jy[k], np.float32)).to(
            getattr(torch, y_dtype)) for k in ys])
    for t, k in zip(got, xs):
        assert t.dtype == getattr(torch, y_dtype)
        assert t.shape == tuple(want[k].shape)
        if y_dtype == "float16":     # one fp16 ulp
            a = t.float().numpy().astype(np.float64)
            b = np.asarray(want[k], np.float32).astype(np.float64)
            mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 2.0 ** -14)
            assert np.all(np.abs(a - b) <= 2.0 ** (np.floor(np.log2(mag))
                                                   - 10))
        else:
            _ulp_close(t, want[k], y_dtype)


NOVOGRAD_CASES = {
    "defaults": {},
    "no_grad_averaging": dict(grad_averaging=False),
    "no_bias_correction": dict(bias_correction=False),
    "init_zero": dict(init_zero=True),
    "weight_decay": dict(weight_decay=0.05),
    "schedule": dict(lr=("cosine", 5e-2, 5, 2)),
}


def _lr_pair(lr):
    """A float, or (name, base, total, warmup) as the JAX and the port
    schedule."""
    if not isinstance(lr, tuple):
        return lr, lr
    name, base, total, warmup = lr
    return (jax_build_schedule(name, base, total, warmup_steps=warmup),
            build_schedule(name, base, total, warmup_steps=warmup))


def _novograd_pair(kw, params):
    kw = dict(kw)
    jlr, plr = _lr_pair(kw.pop("lr", 2e-2))
    jopt = JaxNovoGrad(lr=jlr, **kw)
    ps = [torch.nn.Parameter(torch.from_numpy(a.copy()))
          for a in params.values()]
    return jopt, ps, fused.FusedNovoGrad(ps, lr=plr, **kw)


def _adagrad_pair(kw, params):
    kw = dict(kw)
    jlr, plr = _lr_pair(kw.pop("lr", 5e-2))
    jopt = JaxAdagrad(lr=jlr, **kw)
    ps = [torch.nn.Parameter(torch.from_numpy(a.copy()))
          for a in params.values()]
    return jopt, ps, fused.FusedAdagrad(ps, lr=plr, **kw)


def _trail(jopt, ps, popt, jparams, jstate, steps, seed, flags=()):
    """``steps`` steps of both sides on the same grads; the step numbered
    in ``flags`` overflows: JAX's state is kept as the engine's
    ``select_tree`` keeps it, the port's step takes the noop flag."""
    japply = jax.jit(jopt.apply)     # traced once
    for step in range(steps):
        grads = _arrays(seed + step, scale=0.1)
        skip = step in flags
        new_p, new_s = japply({k: jnp.asarray(a) for k, a in
                               grads.items()}, jstate, jparams)
        if not skip:
            jparams, jstate = new_p, new_s
        popt.zero_grad()
        for p, a in zip(ps, grads.values()):
            p.grad.add_(torch.from_numpy(a))
        popt.step(noop_flag=torch.tensor(int(skip), dtype=torch.int32))
    return jparams, jstate


def _assert_state_follows(ps, popt, jparams, jstate, fields):
    assert popt.step_count == int(jstate.step)
    for i, k in enumerate(jparams):
        np.testing.assert_allclose(ps[i].detach().numpy(),
                                   np.asarray(jparams[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
        for port, jax_field in fields:
            np.testing.assert_allclose(
                getattr(popt, port)[i].numpy(),
                np.asarray(getattr(jstate, jax_field)[k]), rtol=1e-4,
                atol=1e-7, err_msg=f"{port} {k}")


@pytest.mark.parametrize("case", sorted(NOVOGRAD_CASES))
def test_fused_novograd_five_steps_match_jax(case):
    params = _arrays(18)
    jopt, ps, popt = _novograd_pair(NOVOGRAD_CASES[case], params)
    jparams = {k: jnp.asarray(a) for k, a in params.items()}
    jstate = jopt.init(jparams)
    japply = jax.jit(jopt.apply)     # traced once
    for step in range(5):
        grads = _arrays(50 + step, scale=0.1)
        jparams, jstate = japply({k: jnp.asarray(a) for k, a in
                                  grads.items()}, jstate, jparams)
        popt.zero_grad()
        for p, a in zip(ps, grads.values()):
            p.grad.add_(torch.from_numpy(a))
        gnorm = popt.step()
        np.testing.assert_allclose(
            float(gnorm), np.sqrt(sum((a.astype(np.float64) ** 2).sum()
                                      for a in grads.values())),
            rtol=NORM_TOL)
    assert int(jstate.step) == 5
    _assert_state_follows(ps, popt, jparams, jstate,
                          [("mu", "mu"), ("nu", "nu")])
    moved = max(float(np.abs(np.asarray(jparams[k]) - a).max())
                for k, a in params.items())
    assert moved > 1e-3


@pytest.mark.parametrize("kw", [dict(weight_decay=0.05),
                                dict(weight_decay=0.05, adagrad_w_mode=True),
                                dict(lr=("poly", 5e-2, 5, 1))])
def test_fused_adagrad_five_steps_match_jax(kw):
    params = _arrays(19)
    jopt, ps, popt = _adagrad_pair(kw, params)
    jparams = {k: jnp.asarray(a) for k, a in params.items()}
    jstate = jopt.init(jparams)
    jparams, jstate = _trail(jopt, ps, popt, jparams, jstate, 5, 60)
    assert int(jstate.step) == 5
    _assert_state_follows(ps, popt, jparams, jstate, [("sum_sq", "sum_sq")])


def _fields(name):
    return {"novograd": [("mu", "mu"), ("nu", "nu")],
            "adagrad": [("sum_sq", "sum_sq")],
            "sgd": [("momentum_buffer", "momentum")]}[name]


@pytest.mark.parametrize("name", ["novograd", "adagrad", "sgd"])
def test_trail_from_a_converted_jax_state_matches_jax(name):
    """Two JAX steps, the state and params converted into a fresh port
    optimizer, then three more steps on both sides."""
    params = _arrays(20)
    if name == "novograd":
        jopt, ps, popt = _novograd_pair(dict(weight_decay=0.01), params)
    elif name == "adagrad":
        jopt, ps, popt = _adagrad_pair({}, params)
    else:
        jopt = JaxSGD(lr=0.05, momentum=0.9, weight_decay=1e-4)
        ps, popt = _port_sgd(params, 0.05)
        popt.lr = 0.05
    jparams = {k: jnp.asarray(a) for k, a in params.items()}
    jstate = jopt.init(jparams)
    japply = jax.jit(jopt.apply)     # traced once
    for step in range(2):
        grads = {k: jnp.asarray(a) for k, a in
                 _arrays(70 + step, scale=0.1).items()}
        jparams, jstate = japply(grads, jstate, jparams)
    order = lambda tree: [tree[k] for k in params]          # noqa: E731
    numpy_state = {f: jax.tree_util.tree_map(np.asarray, v)
                   for f, v in jstate._asdict().items()}
    popt.load_state_dict(optimizer_state_from_jax(name, numpy_state, order))
    with torch.no_grad():
        for p, k in zip(ps, params):
            p.copy_(torch.from_numpy(np.array(jparams[k])))
    assert popt.step_count == 2
    jparams, jstate = _trail(jopt, ps, popt, jparams, jstate, 3, 72)
    _assert_state_follows(ps, popt, jparams, jstate, _fields(name))


@pytest.mark.parametrize("name", ["novograd", "adagrad"])
def test_noop_flag_on_the_first_step_keeps_jax_step_one(name):
    """The first step overflows: both sides keep the whole old state,
    step count included, so the next step is JAX's step 1 (NovoGrad's
    first-step branch, v = ||g||^2, and c1, c2 at t = 1); a later skip
    keeps the state again."""
    params = _arrays(21)
    pair = _novograd_pair if name == "novograd" else _adagrad_pair
    jopt, ps, popt = pair(dict(lr=("step", 5e-2, 5, 0)), params)
    jparams = {k: jnp.asarray(a) for k, a in params.items()}
    jstate = jopt.init(jparams)
    jparams, jstate = _trail(jopt, ps, popt, jparams, jstate, 1, 80,
                             flags=(0,))
    assert popt.step_count == int(jstate.step) == 0
    for p, a in zip(ps, params.values()):
        assert torch.equal(p.detach(), torch.from_numpy(a))
    jparams, jstate = _trail(jopt, ps, popt, jparams, jstate, 1, 81)
    assert int(jstate.step) == 1
    _assert_state_follows(ps, popt, jparams, jstate, _fields(name))
    if name == "novograd":     # the first-step branch: v = ||g_1||^2
        np.testing.assert_allclose(
            [float(v) for v in popt.nu],
            [float((a.astype(np.float64) ** 2).sum())
             for a in _arrays(81, scale=0.1).values()], rtol=NORM_TOL)
    jparams, jstate = _trail(jopt, ps, popt, jparams, jstate, 3, 82,
                             flags=(1,))
    assert int(jstate.step) == 3
    _assert_state_follows(ps, popt, jparams, jstate, _fields(name))


def test_fused_novograd_refuses_amsgrad():
    with pytest.raises(ValueError, match="amsgrad"):
        fused.FusedNovoGrad([torch.nn.Parameter(torch.zeros(2))],
                            amsgrad=True)


def _meta_three(dtype=torch.float32, s_dtype=torch.float32, lists=3):
    p = [_meta(8, 3, dtype=dtype), _meta(5, dtype=dtype)]
    tensors = [p, [torch.empty_like(t) for t in p],
               [_meta(8, 3, dtype=s_dtype), _meta(5, dtype=s_dtype)]]
    return mt.TensorTable(tensors[:lists])


@pytest.mark.parametrize("make,kw,err,match", [
    (lambda: _meta_three(lists=2), {}, ValueError, "3 lists"),
    (lambda: _meta_three(s_dtype=torch.bfloat16), {}, TypeError,
     "m must be float32"),
    (lambda: _meta_three(torch.float64), {}, TypeError, "float32"),
    (_meta_three, dict(sq=_meta(3)), ValueError, "sq must be"),
    (_meta_three, dict(v=_meta(2, dtype=torch.bfloat16)), ValueError,
     "v must be"),
    (_meta_three, dict(scal=_meta(3)), ValueError, "scalars_t"),
    (_meta_three, dict(step=_meta(())), ValueError, "step_t"),
    (_meta_three, dict(noop_flag=_meta((), dtype=torch.int64)), ValueError,
     "noop_flag"),
    (_meta_three, {}, ValueError, "CUDA"),
])
def test_novograd_wrapper_raises_on_what_it_cannot_take(no_build, make, kw,
                                                        err, match):
    before = fo.novograd_cuda.launches
    args = dict(sq=_meta(2), v=_meta(2), scal=_meta(2),
                step=_meta((), dtype=torch.int32))
    args.update(kw)
    with pytest.raises(err, match=match):
        fo.novograd_cuda(make(), args.pop("sq"), args.pop("v"),
                         args.pop("scal"), args.pop("step"), beta1=0.95,
                         beta2=0.98, eps=1e-8, weight_decay=0.0,
                         grad_avg_coeff=0.05, **args)
    assert fo.novograd_cuda.launches == before


@pytest.mark.parametrize("make,kw,err,match", [
    (lambda: _meta_three(lists=2), {}, ValueError, "3 lists"),
    (lambda: _meta_three(s_dtype=torch.float16), {}, TypeError,
     "sums of squares"),
    (lambda: _meta_three(torch.float64), {}, TypeError, "float32"),
    (_meta_three, dict(lr_t=_meta(1, dtype=torch.float16)), ValueError,
     "lr_t"),
    (_meta_three, dict(noop_flag=_meta(())), ValueError, "noop_flag"),
    (_meta_three, {}, ValueError, "CUDA"),
])
def test_adagrad_wrapper_raises_on_what_it_cannot_take(no_build, make, kw,
                                                       err, match):
    before = fo.adagrad_cuda.launches
    with pytest.raises(err, match=match):
        fo.adagrad_cuda(make(), lr=0.1, eps=1e-10, weight_decay=0.0, **kw)
    assert fo.adagrad_cuda.launches == before


@pytest.mark.parametrize("lists,err,match", [
    ([[_meta(4)], [_meta(4)]], ValueError, "3 lists"),
    ([[_meta(4)], [_meta(4)], [_meta(4, dtype=torch.bfloat16)]], TypeError,
     "y's dtype"),
    ([[_meta(4, dtype=torch.float64)], [_meta(4)], [_meta(4)]], TypeError,
     "float32"),
    ([[_meta(4, dtype=torch.bfloat16)], [_meta(4)], [_meta(4)]], ValueError,
     "CUDA"),
])
def test_axpby_wrapper_raises_instead_of_falling_back(no_build, monkeypatch,
                                                      lists, err, match):
    def no_plain(*a, **k):
        raise AssertionError("plain version ran for a non-CPU tensor")
    monkeypatch.setattr(mt, "multi_tensor_axpby_plain", no_plain)
    before = mt.multi_tensor_axpby_cuda.launches
    with pytest.raises(err, match=match):
        mt.multi_tensor_axpby_cuda(mt.TensorTable(lists), 0.5, 2.0)
    if len(lists) == 3 and match == "CUDA":
        with pytest.raises(ValueError, match="CUDA"):
            mt.multi_tensor_axpby(0.5, lists[0], 2.0, lists[1])
    assert mt.multi_tensor_axpby_cuda.launches == before


@pytest.mark.parametrize("cls,plain", [
    (fused.FusedNovoGrad, ("novograd_update_plain", "novograd_moment_plain",
                           "multi_tensor_l2norm_plain")),
    (fused.FusedAdagrad, ("adagrad_update_plain",
                          "multi_tensor_l2norm_plain"))])
def test_novograd_and_adagrad_off_the_cpu_take_the_kernels_or_raise(
        no_build, monkeypatch, cls, plain):
    def no_plain(*a, **k):
        raise AssertionError("a plain version ran for non-CPU parameters")
    for name in plain + ("multi_tensor_scale_plain",):
        monkeypatch.setattr(fused, name, no_plain)
    ps = [torch.nn.Parameter(_meta(4, 4)), torch.nn.Parameter(_meta(4))]
    opt = cls(ps, lr=0.1)
    assert opt.skips_on_flag and len(opt.tables) == 1
    for call in (opt.step, opt.grad_norm,
                 lambda: opt.unscale_grads(_meta(()))):
        with pytest.raises(ValueError, match="CUDA"):
            call()
