"""The port's ResNet held against the JAX package's, on the CPU.

Both sides get the same weights (the flax init, converted by
``convert.resnet_params_from_flax``) and the same NHWC numpy images, fp32:

- train-mode logits and the new running statistics against
  ``model.apply(..., train=True, mutable=["batch_stats"])``;
- eval-mode logits on those statistics;
- the gradients of one cross-entropy loss against ``jax.grad``;
- at 17 px, where every stride-2 layer sees an odd size, and with
  ``small_stem``; the Bottleneck at ResNet-50's stage layout, one block a
  stage, and ResNet-50 itself;
- each convolution and max pool alone against flax's ``padding="SAME"``,
  which pads the far side more, where torch would pad both sides alike;
- ``resnet_params_from_flax`` as a lossless round trip of every leaf.

Tolerance: every element within 1e-4 of its tensor's L2 norm (fp32 sums in
another order).  Full-depth ResNet-50 at these widths is
ill-conditioned: 16 blocks of BatchNorm over as few as 4 rows amplify the
rounding differences of the first layers, so its logits are held to
3 x the JAX model's own change under an input scaled by 1 + 1e-6, when
that is larger.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_example_tpu.models import resnet as jr
from apex_example_tpu_torch.convert import resnet_params_from_flax
from apex_example_tpu_torch.models import resnet as pr

TOL = 1e-4
CLASSES = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close_to_norm(got, want, tol=TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    norm = np.linalg.norm(want)
    assert err <= tol * max(norm, 1e-30), (what, err, norm)


CONFIGS = {
    # name: (JAX builder, port builder, kwargs, image size)
    "resnet18": (jr.resnet18, pr.resnet18, dict(num_filters=8), 32),
    "resnet18_odd": (jr.resnet18, pr.resnet18, dict(num_filters=4), 17),
    "resnet18_small_stem": (jr.resnet18, pr.resnet18,
                            dict(num_filters=8, small_stem=True), 16),
    "bottleneck": (functools.partial(jr.ResNet, stage_sizes=[1, 1, 1, 1],
                                     block_cls=jr.Bottleneck),
                   functools.partial(pr.ResNet, stage_sizes=[1, 1, 1, 1],
                                     block_cls=pr.Bottleneck),
                   dict(num_filters=4), 32),
}


def _weights(jm, size, seed):
    """flax ``params`` and ``batch_stats`` trees of ``jm`` filled from
    numpy: convolutions and the classifier He-normal, BatchNorm's scale,
    bias and running statistics drawn around 1, 0, 0 and 1 (so that none
    is trivially one or zero).  ``jax.eval_shape`` gives the tree without
    running the init."""
    tree = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False))
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rs.randn(*shape) * np.sqrt(2.0 / fan_in)).astype(
                np.float32)
        base = {"scale": 1.0, "var": 1.0}.get(name, 0.0)
        return (base + 0.1 * rs.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _reference(jbuild, kwargs, size, batch=4, seed=0):
    """The JAX side of one configuration, as numpy: inputs, weights, train
    logits and new statistics, eval logits, and the grads of the loss."""
    rs = np.random.RandomState(seed)
    x = rs.randn(batch, size, size, 3).astype(np.float32)
    y = rs.randint(0, CLASSES, batch)
    jm = jbuild(num_classes=CLASSES, **kwargs)
    v = _weights(jm, size, seed + 1)
    params, stats = v["params"], v["batch_stats"]

    def loss(params):
        logits, mut = jm.apply({"params": params, "batch_stats": stats},
                               jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        lp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(lp, jnp.asarray(y)[:, None], 1)
        return nll.mean(), (logits, mut["batch_stats"])

    (_, (logits, new_stats)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    eval_logits = jax.jit(lambda p, s: jm.apply(
        {"params": p, "batch_stats": s}, jnp.asarray(x), train=False))(
            params, new_stats)
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    return dict(model=jm, x=x, y=y, params=params, stats=stats,
                logits=np.asarray(logits), new_stats=np_(new_stats),
                eval_logits=np.asarray(eval_logits), grads=np_(grads))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    jbuild, pbuild, kwargs, size = CONFIGS[request.param]
    ref = _reference(jbuild, kwargs, size)
    pm = pbuild(num_classes=CLASSES, device="cpu", **kwargs)
    pm.load_state_dict(resnet_params_from_flax(ref["params"], ref["stats"]))
    pm.train()
    logits = pm(torch.from_numpy(ref["x"]))
    torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(ref["y"]).long()).backward()
    buffers = {k: b.clone() for k, b in pm.named_buffers()}
    pm.eval()
    with torch.no_grad():
        eval_logits = pm(torch.from_numpy(ref["x"]))
    return dict(ref, name=request.param, port=pm,
                port_logits=logits.detach().numpy(), port_buffers=buffers,
                port_eval=eval_logits.numpy())


def test_train_logits_and_new_statistics_match_jax(case):
    assert case["port_logits"].dtype == np.float32
    _close_to_norm(case["port_logits"], case["logits"], what="logits")
    want = resnet_params_from_flax(case["params"], case["new_stats"])
    assert set(case["port_buffers"]) == {k for k in want if
                                         k.endswith((".mean", ".var"))}
    for k, b in case["port_buffers"].items():
        _close_to_norm(b.numpy(), want[k].numpy(), what=k)


def test_eval_logits_match_jax(case):
    _close_to_norm(case["port_eval"], case["eval_logits"], what="eval")


def test_grads_of_one_step_match_jax(case):
    want = resnet_params_from_flax(case["grads"])
    names = [k for k, _ in case["port"].named_parameters()]
    assert sorted(names) == sorted(want)
    for k, p in case["port"].named_parameters():
        _close_to_norm(p.grad.numpy(), want[k].numpy(), what=k)


def test_resnet50_logits_match_jax_within_its_floor():
    jm = jr.resnet50(num_classes=CLASSES, num_filters=4)
    v = _weights(jm, 32, 5)
    x = np.random.RandomState(4).randn(4, 32, 32, 3).astype(np.float32)
    apply = jax.jit(lambda x: jm.apply(v, x, train=True,
                                       mutable=["batch_stats"])[0])
    want = np.asarray(apply(jnp.asarray(x)))
    floor = np.abs(np.asarray(apply(jnp.asarray(
        x * np.float32(1 + 1e-6)))) - want).max()
    pm = pr.resnet50(num_classes=CLASSES, num_filters=4, device="cpu")
    assert len(list(pm.parameters())) == 161
    pm.load_state_dict(resnet_params_from_flax(v["params"],
                                               v["batch_stats"]))
    pm.train()
    with torch.no_grad():
        logits = pm(torch.from_numpy(x)).numpy()
    err = np.abs(logits - want).max()
    limit = max(3 * floor, TOL * np.abs(want).max())
    assert err <= limit, (err, floor)


@pytest.mark.parametrize("size,kernel,stride", [
    (s, k, st) for s in (16, 17) for k, st in ((7, 2), (3, 2), (1, 2), (3, 1))
] + [(224, 7, 2), (225, 7, 2)])
def test_conv_pads_as_flax_same(size, kernel, stride):
    rs = np.random.RandomState(size + kernel)
    x = rs.randn(2, size, size, 3).astype(np.float32)
    w = rs.randn(kernel, kernel, 3, 5).astype(np.float32)
    conv = fnn.Conv(5, (kernel, kernel), (stride, stride), padding="SAME",
                    use_bias=False)
    want = conv.apply({"params": {"kernel": jnp.asarray(w)}}, jnp.asarray(x))
    port = pr.Conv(3, 5, kernel, stride)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    before, after = pr.same_pads(size, kernel, stride)
    assert after - before in (0, 1)
    if stride == 2 and size % 2 == 0 and kernel > 1:
        assert after == before + 1      # torchvision's padding would shift


@pytest.mark.parametrize("size", [8, 9, 112])
def test_max_pool_pads_as_flax_same(size):
    x = np.random.RandomState(size).randn(2, size, size, 4).astype(np.float32)
    want = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                        padding="SAME")
    got = pr.max_pool_same(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))


def test_resnet_params_from_flax_round_trip():
    jm = jr.resnet50(num_classes=CLASSES, num_filters=4)
    v = _weights(jm, 32, 1)
    sd = resnet_params_from_flax(v["params"], v["batch_stats"])
    pm = pr.resnet50(num_classes=CLASSES, num_filters=4, device="cpu")
    pm.load_state_dict(sd, strict=True)
    n_leaves = len(jax.tree_util.tree_leaves(v))
    assert len(sd) == n_leaves == len(pm.state_dict())
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(v)[0]}
    for path, leaf in flat.items():
        coll, *mods, name = path.split("/")
        port_name = {"kernel": "weight"}.get(name, name)
        t = pm.state_dict()[".".join(mods + [port_name])].numpy()
        if name == "kernel" and leaf.ndim == 4:     # HWIO -> OIHW
            t = t.transpose(2, 3, 1, 0)
        elif name == "kernel":                      # (in, out) -> (out, in)
            t = t.T
        np.testing.assert_array_equal(t, leaf, err_msg=path)


def test_random_init_follows_flax_distributions():
    pm = pr.resnet18(num_classes=CLASSES, num_filters=8, device="cpu",
                     seed=3)
    again = pr.resnet18(num_classes=CLASSES, num_filters=8, device="cpu",
                        seed=3)
    for (k, p), q in zip(pm.named_parameters(), again.parameters()):
        assert torch.equal(p, q), k                 # the seed decides
    w = pm.get_submodule("BasicBlock_2.Conv_0").weight
    fan_in = w[0].numel()
    std = float(w.detach().std())
    assert abs(std - (2.0 / fan_in) ** 0.5) < 0.15 * (2.0 / fan_in) ** 0.5
    bound = 2 * (2.0 / fan_in) ** 0.5 / 0.8796      # 2 std, truncated
    assert float(w.detach().abs().max()) <= bound + 1e-6
    bn0 = pm.get_submodule("bn_init")
    assert torch.equal(bn0.scale, torch.ones(8))
    assert torch.equal(bn0.bias, torch.zeros(8))
    assert torch.equal(bn0.var, torch.ones(8)) and not bn0.mean.any()
    assert not pm.fc.bias.any()


@pytest.mark.parametrize("kw", [dict(remat="conv"),
                                dict(stem_space_to_depth=True)])
def test_options_not_ported_yet_are_refused(kw):
    with pytest.raises(NotImplementedError, match="not ported"):
        pr.resnet18(num_classes=CLASSES, num_filters=4, device="cpu", **kw)


@pytest.mark.parametrize("level", ["O2", "O3"])
def test_amp_dtypes_of_the_model(level):
    from apex_example_tpu_torch import amp
    md = amp.module_dtypes(amp.get_policy(level))
    pm = pr.resnet18(num_classes=CLASSES, num_filters=4, dtype=md.compute,
                     param_dtype=md.param, bn_dtype=md.bn_stats,
                     bn_io_dtype=md.bn_io, device="cpu")
    conv_w = pm.get_submodule("BasicBlock_0.Conv_0").weight
    bn_scale = pm.get_submodule("BasicBlock_0.SyncBatchNorm_0").scale
    assert conv_w.dtype == (torch.float32 if level == "O2"
                            else torch.bfloat16)
    assert bn_scale.dtype == torch.float32              # (:183)
    out = pm(torch.randn(2, 16, 16, 3))
    assert out.dtype == torch.float32 and out.shape == (2, CLASSES)
