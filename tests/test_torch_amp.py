"""The port's amp (policy, op lists, module dtypes, loss scaler) held against
the JAX package's apex_example_tpu.amp, on the CPU.

- The O0-O3 table in bf16 and fp16, and ``get_policy``'s ``loss_scale``
  and ``keep_batchnorm_fp32`` overrides, field by field (dtypes mapped
  jnp -> torch).
- ``module_dtypes`` for each level, ``op_dtype`` / ``cast_args`` and
  ``disable_casts`` under O1.
- The scaler: ``update`` over a sequence of finite flags step by step
  (growth at ``growth_interval``, backoff on a non-finite step), the
  unscale of a dynamic and a static scaler, the identity scaler launching
  and touching nothing, and a ``state_dict`` round trip.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_example_tpu import amp as jamp
from apex_example_tpu_torch import amp
from apex_example_tpu_torch.amp import lists
from apex_example_tpu_torch.optim.fused import FusedSGD

DTYPES = {jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float16): torch.float16}
HALF = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
        "float16": (jnp.float16, torch.float16)}


def _same_policy(p, j):
    assert p.opt_level == j.opt_level
    for field in ("param_dtype", "compute_dtype", "bn_dtype"):
        assert getattr(p, field) == DTYPES[jnp.dtype(getattr(j, field))], \
            field
    assert p.master_weights == j.master_weights
    assert p.loss_scale == j.loss_scale
    assert p.cast_at_call_sites == j.cast_at_call_sites
    assert p.uses_dynamic_scaling == j.uses_dynamic_scaling


@pytest.mark.parametrize("half", list(HALF))
@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
def test_opt_level_table_matches_jax(level, half):
    jh, th = HALF[half]
    _same_policy(amp.opt_level_table(th)[level],
                 jamp.opt_level_table(jh)[level])


@pytest.mark.parametrize("keep", [None, True, False])
@pytest.mark.parametrize("loss_scale", [None, "dynamic", "128", 64.0])
@pytest.mark.parametrize("level", ["o2", "O3"])
def test_get_policy_overrides_match_jax(level, loss_scale, keep):
    p = amp.get_policy(level, loss_scale=loss_scale, keep_batchnorm_fp32=keep)
    _same_policy(p, jamp.get_policy(level, loss_scale=loss_scale,
                                    keep_batchnorm_fp32=keep))
    if p.uses_dynamic_scaling:
        with pytest.raises(ValueError, match="no static scale"):
            p.static_scale


def test_an_unknown_level_is_refused():
    with pytest.raises(ValueError, match="O4"):
        amp.get_policy("O4")


@pytest.mark.parametrize("half", list(HALF))
@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
def test_module_dtypes_match_jax(level, half):
    jh, th = HALF[half]
    got = amp.module_dtypes(amp.get_policy(level, half_dtype=th))
    want = jamp.module_dtypes(jamp.get_policy(level, half_dtype=jh))
    for field in ("compute", "bn_io", "bn_stats", "ln_io", "softmax",
                  "param"):
        assert getattr(got, field) == DTYPES[jnp.dtype(getattr(want, field))]


def test_o1_casts_by_the_op_lists_and_disable_casts_forces_fp32():
    p = amp.get_policy("O1")
    x16 = torch.ones(2, dtype=torch.bfloat16)
    x32 = torch.ones(2)
    assert amp.op_dtype(p, "conv") == torch.bfloat16
    assert amp.op_dtype(p, "softmax") == torch.float32
    assert amp.op_dtype(p, "add", torch.bfloat16, torch.float32) == \
        torch.float32
    assert amp.cast_args(p, "matmul", x32).dtype == torch.bfloat16
    a, b = amp.cast_args(p, "add", x16, x32)
    assert a.dtype == b.dtype == torch.float32
    with amp.disable_casts():
        assert amp.op_dtype(p, "conv") == torch.float32
    assert amp.op_dtype(p, "conv") == torch.bfloat16
    assert amp.op_dtype(amp.get_policy("O2"), "conv") is None
    assert amp.cast_args(amp.get_policy("O2"), "conv", x32) is x32


def test_the_op_lists_are_the_jax_package_s():
    from apex_example_tpu.amp import lists as jlists
    for name in ("FP16_FUNCS", "FP32_FUNCS", "PROMOTE_FUNCS", "INT8_FUNCS"):
        assert set(getattr(lists, name)) == set(getattr(jlists, name)), name
    for op in ("conv", "batch_norm", "softmax", "add", "embedding",
               "unknown_op"):
        assert lists.classify(op) == jlists.classify(op)
        assert lists.quant_classify(op) == jlists.quant_classify(op)


def test_scaler_update_matches_jax_over_a_sequence_of_flags():
    policy = amp.get_policy("O2", loss_scale="dynamic")
    jpolicy = jamp.get_policy("O2", loss_scale="dynamic")
    s = amp.make_scaler(policy, init_scale=1024.0, growth_interval=3)
    js = jamp.make_scaler(jpolicy, init_scale=1024.0, growth_interval=3)
    flags = [True, True, True, True, False, True, True, True, False, False,
             True, True, True, True, True, True]
    grew = shrank = 0
    for finite in flags:
        before = float(s.scale)
        s = amp.update_scaler(s, torch.tensor(0 if finite else 1,
                                              dtype=torch.int32))
        js = jamp.update_scaler(js, jnp.asarray(finite))
        assert float(s.scale) == float(js.scale)
        assert int(s.growth_counter) == int(js.growth_counter)
        assert s.scale.dtype == torch.float32
        assert s.growth_counter.dtype == torch.int32
        grew += float(s.scale) > before
        shrank += float(s.scale) < before
    assert grew >= 3 and shrank == 3


def test_a_static_scaler_does_not_update():
    s = amp.make_scaler(amp.get_policy("O2", loss_scale=128.0))
    assert not s.dynamic and not s.identity and float(s.scale) == 128.0
    assert amp.update_scaler(s, torch.tensor(1, dtype=torch.int32)) is s


class _NoUnscale:
    def unscale_grads(self, inv):
        raise AssertionError("the identity scaler unscaled")


def test_the_identity_scaler_touches_and_launches_nothing():
    for level in ("O0", "O1", "O2"):
        s = amp.make_scaler(amp.get_policy(level))
        assert s.identity and not s.dynamic
        loss = torch.tensor(2.5)
        assert amp.scale_loss(loss, s) is loss
        assert amp.unscale_grads(_NoUnscale(), s) is None


def _sgd_with_grads(grads):
    ps = [torch.nn.Parameter(torch.zeros_like(g)) for g in grads]
    opt = FusedSGD(ps, lr=0.1)
    for p, g in zip(ps, grads):
        p.grad.copy_(g)
    return opt


@pytest.mark.parametrize("planted", [None, np.inf, np.nan, 3e38])
def test_dynamic_unscale_matches_jax(planted):
    rs = np.random.RandomState(7)
    grads = [(rs.randn(5, 7) * 100).astype(np.float32),
             (rs.randn(11) * 100).astype(np.float32)]
    if planted is not None:
        grads[1][4] = planted
    policy = amp.get_policy("O0", loss_scale="dynamic")
    s = amp.make_scaler(policy, init_scale=0.5)
    js = jamp.make_scaler(jamp.get_policy("O0", loss_scale="dynamic"),
                          init_scale=0.5)
    opt = _sgd_with_grads([torch.from_numpy(g) for g in grads])
    flag = amp.unscale_grads(opt, s)
    jgrads, finite = jamp.unscale_grads([jnp.asarray(g) for g in grads], js)
    assert flag.dtype == torch.int32 and flag.dim() == 0
    assert int(flag) == int(not bool(finite))
    assert int(flag) == (planted is not None)     # 3e38 / 0.5 overflows
    for got, want in zip(opt.grads, jgrads):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert amp.scale_loss(torch.tensor(3.0), s).item() == 1.5


def test_a_static_scaler_unscales_and_reports_no_flag():
    g = torch.full((4,), 256.0)
    opt = _sgd_with_grads([g])
    s = amp.make_scaler(amp.get_policy("O2", loss_scale="128"))
    assert amp.unscale_grads(opt, s) is None
    assert torch.equal(opt.grads[0], torch.full((4,), 2.0))


def test_state_dict_round_trip():
    policy = amp.get_policy("O2", loss_scale="dynamic")
    s = amp.make_scaler(policy, growth_interval=2)
    for flag in (0, 0, 1, 0):
        s = amp.update_scaler(s, torch.tensor(flag, dtype=torch.int32))
    d = amp.state_dict(s)
    assert d == jamp.state_dict(jamp.load_state_dict(
        jamp.make_scaler(jamp.get_policy("O2", loss_scale="dynamic"),
                         growth_interval=2), d))
    back = amp.load_state_dict(amp.make_scaler(policy, growth_interval=2), d)
    assert amp.state_dict(back) == d
    assert float(back.scale) == float(s.scale) == 2.0 ** 16
    static = amp.make_scaler(amp.get_policy("O2", loss_scale=4.0))
    loaded = amp.load_state_dict(static, {"scale": 1.0, "growth_counter": 0,
                                          "dynamic": False})
    assert loaded.identity and not static.identity


@pytest.mark.parametrize("half,dynamic", [(None, False),
                                          (torch.float16, True)])
def test_initialize_returns_the_policy_and_its_scaler(half, dynamic):
    policy, scaler = amp.initialize("O2", half_dtype=half)
    assert policy.compute_dtype == (half or torch.bfloat16)
    assert scaler.dynamic == dynamic and scaler.identity == (not dynamic)
    assert scaler.scale.device.type == "cpu"
