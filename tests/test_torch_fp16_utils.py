"""The port's fp16_utils (apex_example_tpu_torch/fp16_utils.py) held against
the JAX package's, case by case as tests/test_fp16_utils.py holds the JAX
module, on the CPU: the same bf16 parameters and grads (numpy, from a
seed) through the JAX ``FP16_Optimizer`` (init/step) and the port's
(backward/step on a model's parameters in place).

- master-weight SGD equals fp32 SGD on the masters (rtol 1e-6), and the
  port's masters equal JAX's; the model's parameters keep their dtype;
- an overflow step (inf grads) under dynamic scaling leaves the model's
  parameters, the masters and the inner optimizer's state and count as
  they were and halves the scale, as JAX's does; the next clean step
  moves the masters as JAX's step moves its own (rtol 1e-6), with
  FusedSGD, and with FusedAdam and FusedLAMB, whose skip is their noop
  flag;
- ``scale_loss`` and the state dict round trip;
- ``network_to_half`` of a model (half compute and parameters, BatchNorm
  fp32) and of a dict of tensors (floating ones half, integer ones kept),
  as the JAX module's;
- ``prep_param_lists``, ``master_to_model`` and ``grads_to_master``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_example_tpu import fp16_utils as jfu
from apex_example_tpu.models import resnet18 as jax_resnet18
from apex_example_tpu.optim import FusedAdam as JaxAdam
from apex_example_tpu.optim import FusedLAMB as JaxLAMB
from apex_example_tpu.optim import FusedSGD as JaxSGD
from apex_example_tpu_torch import fp16_utils as fu
from apex_example_tpu_torch.models.resnet import resnet18
from apex_example_tpu_torch.optim.fused import FusedAdam, FusedLAMB, FusedSGD
from apex_example_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm

TOL = 1e-6
OPTS = {"sgd": (lambda ps, **kw: FusedSGD(ps, **kw),
                lambda **kw: JaxSGD(**kw)),
        "adam": (lambda ps, **kw: FusedAdam(ps, **kw),
                 lambda **kw: JaxAdam(**kw)),
        "lamb": (lambda ps, **kw: FusedLAMB(ps, **kw),
                 lambda **kw: JaxLAMB(**kw))}


def _half_arrays(seed, shapes):
    rs = np.random.RandomState(seed)
    return {f"p{i}": np.asarray(jnp.asarray(rs.randn(*s), jnp.bfloat16))
            for i, s in enumerate(shapes)}


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _port(arrays, opt, **kw):
    params = [torch.nn.Parameter(_bf16(a)) for a in arrays.values()]
    model_params, masters = fu.prep_param_lists(params)
    inner = OPTS[opt][0](masters, **kw.pop("inner"))
    return params, fu.FP16_Optimizer(inner, model_params, **kw)


def _set_grads(params, grads):
    for p, g in zip(params, grads.values()):
        p.grad = _bf16(g)


def test_fp16_optimizer_matches_fp32_sgd():
    arrays = _half_arrays(0, [(8, 4), (4,)])
    grads = {k: np.full(a.shape, 0.1, np.float32) for k, a in arrays.items()}
    jopt = jfu.FP16_Optimizer(JaxSGD(lr=0.5, momentum=0.0),
                              static_loss_scale=1.0)
    jstate = jopt.init({k: jnp.asarray(a) for k, a in arrays.items()})
    _, jstate = jopt.step({k: jnp.asarray(g).astype(jnp.bfloat16)
                           for k, g in grads.items()}, jstate)
    params, opt = _port(arrays, "sgd", inner=dict(lr=0.5, momentum=0.0),
                        static_loss_scale=1.0)
    opt.zero_grad()
    _set_grads(params, grads)
    opt.step()
    for i, k in enumerate(arrays):
        want = (np.asarray(arrays[k], np.float32)
                - 0.5 * np.asarray(_bf16(grads[k]).float()))
        np.testing.assert_allclose(opt.masters[i].detach().numpy(), want,
                                   rtol=TOL)
        np.testing.assert_allclose(opt.masters[i].detach().numpy(),
                                   np.asarray(jstate.masters[k]), rtol=TOL)
        assert params[i].dtype == torch.bfloat16
        assert torch.equal(params[i].detach(),
                           opt.masters[i].detach().to(torch.bfloat16))


@pytest.mark.parametrize("opt", ["sgd", "adam", "lamb"])
def test_fp16_optimizer_overflow_skips_step(opt):
    arrays = _half_arrays(1, [(4, 4), (6,)])
    jopt = jfu.FP16_Optimizer(OPTS[opt][1](lr=0.5), dynamic_loss_scale=True)
    jstate = jopt.init({k: jnp.asarray(a) for k, a in arrays.items()})
    params, popt = _port(arrays, opt, inner=dict(lr=0.5),
                         dynamic_loss_scale=True)
    s0 = float(popt.scaler.scale)
    assert s0 == float(jstate.scaler.scale) == 2.0 ** 16

    bad = {k: np.full(a.shape, np.inf, np.float32)
           for k, a in arrays.items()}
    jhalf, jstate = jopt.step({k: jnp.asarray(g).astype(jnp.bfloat16)
                               for k, g in bad.items()}, jstate)
    before = [t.detach().clone() for t in params + popt.masters]
    popt.zero_grad()
    _set_grads(params, bad)
    popt.step()
    assert all(torch.equal(a, b) for a, b in
               zip(params + popt.masters, before))
    assert popt.inner.step_count == int(
        jax.tree_util.tree_leaves(jstate.inner_state)[0]) == 0
    for i, k in enumerate(arrays):
        np.testing.assert_array_equal(
            params[i].detach().float().numpy(),
            np.asarray(jhalf[k], np.float32))
    assert float(popt.scaler.scale) == float(jstate.scaler.scale) \
        == s0 * popt.scaler.backoff_factor

    good = {k: np.ones(a.shape, np.float32) for k, a in arrays.items()}
    _, jstate = jopt.step({k: jnp.asarray(g).astype(jnp.bfloat16)
                           for k, g in good.items()}, jstate)
    popt.zero_grad()
    _set_grads(params, good)
    popt.step()
    assert popt.inner.step_count == 1
    for i, k in enumerate(arrays):
        m = popt.masters[i].detach()
        assert not torch.equal(m, before[len(params) + i])
        np.testing.assert_allclose(m.numpy(), np.asarray(jstate.masters[k]),
                                   rtol=TOL, atol=TOL)


def test_scale_loss_and_state_dict_roundtrip():
    arrays = {"w": np.ones((2, 2), np.float32)}
    params, opt = _port(arrays, "sgd", inner=dict(lr=0.1),
                        static_loss_scale=128.0)
    jopt = jfu.FP16_Optimizer(JaxSGD(lr=0.1), static_loss_scale=128.0)
    jstate = jopt.init({"w": jnp.ones((2, 2), jnp.bfloat16)})
    assert float(opt.scale_loss(torch.tensor(2.0))) == float(
        jopt.scale_loss(jnp.asarray(2.0), jstate)) == 256.0
    opt.zero_grad()
    _set_grads(params, {"w": np.full((2, 2), 0.5, np.float32)})
    opt.step()
    d = opt.state_dict()
    assert d["scaler"] == {"scale": 128.0, "growth_counter": 0,
                           "dynamic": False}
    params2, opt2 = _port(arrays, "sgd", inner=dict(lr=0.1),
                          static_loss_scale=1.0)
    opt2.load_state_dict(d)
    assert float(opt2.scaler.scale) == 128.0
    assert opt2.inner.step_count == 1
    assert torch.equal(opt2.masters[0], opt.masters[0])
    assert torch.equal(params2[0], params[0])


def test_network_to_half_model_and_tree():
    jm = jfu.network_to_half(jax_resnet18(num_classes=10))
    assert jm.dtype == jnp.bfloat16 and jm.bn_dtype == jnp.float32
    m = fu.network_to_half(resnet18(num_classes=10, num_filters=4,
                                    small_stem=True, device="cpu"))
    assert m.dtype == jnp_to_torch(jm.dtype)
    assert m.conv_init.weight.dtype == torch.bfloat16
    bns = [mod for mod in m.modules() if isinstance(mod, SyncBatchNorm)]
    assert bns and all(b.stats_dtype == jnp_to_torch(jm.bn_dtype)
                       and b.scale.dtype == torch.float32 for b in bns)
    out = m(torch.randn(2, 16, 16, 3))
    assert out.dtype == torch.float32 and bool(out.isfinite().all())

    tree = {"a": np.ones((3,), np.float32), "n": np.arange(3)}
    jt = jfu.network_to_half({k: jnp.asarray(v) for k, v in tree.items()})
    th = fu.network_to_half({k: torch.from_numpy(v)
                             for k, v in tree.items()})
    assert th["a"].dtype == jnp_to_torch(jt["a"].dtype) == torch.bfloat16
    assert th["n"].dtype == torch.int64 and jt["n"].dtype == jnp.int32
    np.testing.assert_array_equal(th["a"].float().numpy(),
                                  np.asarray(jt["a"], np.float32))


def jnp_to_torch(dtype):
    return {jnp.dtype(jnp.bfloat16): torch.bfloat16,
            jnp.dtype(jnp.float32): torch.float32}[jnp.dtype(dtype)]


def test_prep_and_sync_param_lists():
    arrays = _half_arrays(2, [(3, 3)])
    jmodel, jmasters = jfu.prep_param_lists(
        {k: jnp.asarray(a) for k, a in arrays.items()})
    params = [torch.nn.Parameter(_bf16(a)) for a in arrays.values()]
    model_params, masters = fu.prep_param_lists(params)
    assert masters[0].dtype == torch.float32 == jnp_to_torch(
        jmasters["p0"].dtype)
    np.testing.assert_array_equal(masters[0].detach().numpy(),
                                  np.asarray(jmasters["p0"]))
    with torch.no_grad():
        masters[0].add_(1.0)
    back = fu.master_to_model(masters, model_params)
    jback = jfu.master_to_model(jmasters, jmodel)
    assert back[0] is params[0]
    assert back[0].dtype == jnp_to_torch(jback["p0"].dtype)
    np.testing.assert_array_equal(
        back[0].detach().float().numpy(),
        (masters[0].detach() - 0.0).to(torch.bfloat16).float().numpy())
    params[0].grad = torch.ones(3, 3, dtype=torch.bfloat16)
    g = fu.grads_to_master(model_params, masters)
    jg = jfu.grads_to_master({"p0": jnp.ones((3, 3), jnp.bfloat16)})
    assert g[0].dtype == jnp_to_torch(jg["p0"].dtype) == torch.float32
    assert g[0] is masters[0].grad and float(g[0].sum()) == 9.0
