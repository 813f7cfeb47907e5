"""Gradient accumulation in the port held against the JAX package's, on
the CPU at tiny sizes: engine.GradAccumulator and ``make_train_step`` /
``make_txl_train_step`` with ``grad_accum``.  The JAX steps run the XLA
reference forms of their kernels (``ops._config.force_xla``), each
compiled once; the kernels themselves are held against the port's in
their own test files.

- One step at K = 2 from the same weights (the flax init, converted) on
  the same numpy batch, FusedSGD on both sides: bert_tiny MLM with a mask
  whose weight count differs between the microbatches (each microbatch
  normalises by its own count, as JAX's does: the loss is not the
  full-batch loss); ResNet-18 (4 filters, the CIFAR stem) with its
  running statistics; transformer_xl_tiny from a random memory, the new
  memory put back in stream order.  Loss, parameters, statistics and
  memory rtol 1e-5, atol 1e-6 (fp32, sums in another order).
- O3 (bf16 convolutions beside fp32 BatchNorm parameters: the fp32
  accumulators and the in-place sums at once) at K = 2 against JAX's O3:
  the loss and the parameters after the step no further from the fp32
  step's than twice JAX's distance plus 1e-3 (the bf16 trail rule).
- The accumulator's arithmetic: fp32 and bf16 grads at K = 4 bitwise
  (sum of the fp32 grads, / 4, in the grad's dtype, as JAX's), at K = 3
  within two fp32 roundings of it.
- Port against itself: bert_tiny at K = 4 against K = 1 with uniform
  weights within JAX's own tolerance (rtol 1e-4, tests/test_engine.py).

The other step options (remat, the space-to-depth stem, the host
runtime, the CLI's refusals) are in tests/test_torch_step_options.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_ref import create_state
from apex_example_tpu import amp as jamp
from apex_example_tpu.amp.policy import get_policy
from apex_example_tpu.data.synthetic import lm_batch as jax_lm_batch
from apex_example_tpu.data.synthetic import mlm_batch as jax_mlm_batch
from apex_example_tpu.engine import TrainState as JaxTrainState
from apex_example_tpu.engine import make_train_step as jax_make_step
from apex_example_tpu.models.bert import bert_tiny as jax_bert_tiny
from apex_example_tpu.models.resnet import resnet18 as jax_resnet18
from apex_example_tpu.models.transformer_xl import \
    transformer_xl_tiny as jax_txl_tiny
from apex_example_tpu.ops import _config as jax_ops_config
from apex_example_tpu.optim.fused import FusedSGD as JaxSGD
from apex_example_tpu.workloads import make_txl_train_step as jax_txl_step
from apex_example_tpu.workloads import mlm_loss as jax_mlm_loss
from apex_example_tpu_torch import amp
from apex_example_tpu_torch.convert import (bert_params_from_flax,
                                            resnet_params_from_flax,
                                            txl_params_from_flax)
from apex_example_tpu_torch.engine import (GradAccumulator,
                                           create_train_state,
                                           make_train_step)
from apex_example_tpu_torch.models.bert import bert_tiny
from apex_example_tpu_torch.models.resnet import resnet18
from apex_example_tpu_torch.models.transformer_xl import transformer_xl_tiny
from apex_example_tpu_torch.optim.fused import FusedSGD
from apex_example_tpu_torch.workloads import make_txl_train_step, mlm_loss

B, S, V, K = 8, 16, 256, 2
IMG, CLASSES = 16, 10
SGD = dict(lr=0.1, momentum=0.9, weight_decay=1e-4)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _setup():
    """One torch thread; the JAX steps on their kernels' XLA forms."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with jax_ops_config.force_xla(True):
        yield
    torch.set_num_threads(before)


def _np32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _assert_sd(model, want, what, **tol):
    got = model.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].float().numpy(),
                                   w.float().numpy(), **(tol or TOL),
                                   err_msg=f"{what} {name}")


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def _flat(sd, names):
    return torch.cat([sd[n].float().reshape(-1) for n in names])


# ------------------------------------------------- accumulation vs JAX


def test_bert_mlm_accumulation_matches_jax_with_its_per_microbatch_norm():
    ids, labels, w = (np.array(a) for a in jax_mlm_batch(
        jnp.asarray(0, jnp.int32), batch_size=B, seq_len=S, vocab_size=V,
        mask_token_id=V - 1, seed=0))
    w[: B // K] = 0.0
    w[: B // K, :3] = 1.0            # 12 masked positions against ~10
    assert w[: B // K].sum() != w[B // K:].sum()
    policy = get_policy("O0")
    jm, jopt = jax_bert_tiny(), JaxSGD(**SGD)
    jstate = create_state(jax.random.PRNGKey(3), jm, jopt,
                          jnp.asarray(ids[:1]), policy)
    weights = bert_params_from_flax(_np32(jstate.params))
    jstate, jmet = jax.jit(jax_make_step(
        jm, jopt, policy, loss_fn=jax_mlm_loss, compute_accuracy=False,
        grad_accum=K))(jstate, (jnp.asarray(ids), (jnp.asarray(labels),
                                                    jnp.asarray(w))))
    pm = bert_tiny(device="cpu")
    pm.load_state_dict(weights)
    batch = (torch.from_numpy(ids), (torch.from_numpy(labels),
                                     torch.from_numpy(w)))
    with torch.no_grad():
        whole = float(mlm_loss(pm(batch[0]), batch[1]))
    state = create_train_state(pm, FusedSGD(pm.parameters(), **SGD))
    state, met = make_train_step(mlm_loss, compute_accuracy=False,
                                 grad_accum=K)(state, batch)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               **TOL)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)
    assert abs(float(met["loss"]) - whole) > 1e-3
    _assert_sd(pm, bert_params_from_flax(_np32(jstate.params)), "bert")


def _jax_resnet(level):
    """JAX's ResNet-18 at ``level`` and its state, the weights from numpy
    (``jax.eval_shape`` gives the tree; the init never compiles): He
    normal kernels, the rest 1 or 0 plus 0.05 normal."""
    policy = get_policy(level)
    md = jamp.module_dtypes(policy)
    jm = jax_resnet18(num_classes=CLASSES, num_filters=4, small_stem=True,
                      dtype=md.compute, param_dtype=md.param,
                      bn_dtype=md.bn_stats, bn_io_dtype=md.bn_io)
    rs = np.random.RandomState(1)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return (rs.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
                    ).astype(np.float32)
        base = 1.0 if name in ("scale", "var") else 0.0
        return (base + 0.05 * rs.randn(*shape)).astype(np.float32)
    tree = jax.tree_util.tree_map_with_path(fill, jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)),
                        train=False)))
    # the port's dtypes: BatchNorm's parameters stay fp32 under O3
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: jnp.asarray(p).astype(
            jnp.float32 if any("bn" in k.key or "BatchNorm" in k.key
                               for k in path) else policy.param_dtype),
        tree["params"])
    jopt = JaxSGD(**SGD)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=tree["batch_stats"],
                           opt_state=jopt.init(params),
                           scaler=jamp.make_scaler(policy))
    return jm, jopt, policy, jstate


def _port_resnet(level, sd):
    policy, scaler = amp.initialize(level)
    md = amp.module_dtypes(policy)
    pm = resnet18(num_classes=CLASSES, num_filters=4, small_stem=True,
                  dtype=md.compute, param_dtype=md.param,
                  bn_dtype=md.bn_stats, bn_io_dtype=md.bn_io, device="cpu")
    pm.load_state_dict(sd)
    state = create_train_state(pm, FusedSGD(pm.parameters(), **SGD),
                               policy, scaler)
    return pm, state


def _image_batch():
    rs = np.random.RandomState(4)
    return (rs.randn(B, IMG, IMG, 3).astype(np.float32),
            rs.randint(0, CLASSES, B).astype(np.int32))


def test_resnet_accumulation_matches_jax_with_its_running_statistics():
    x, y = _image_batch()
    jm, jopt, policy, jstate = _jax_resnet("O0")
    sd = resnet_params_from_flax(_np32(jstate.params),
                                 _np32(jstate.batch_stats))
    jstate, jmet = jax.jit(jax_make_step(jm, jopt, policy, grad_accum=K))(
        jstate, (jnp.asarray(x), jnp.asarray(y)))
    pm, state = _port_resnet("O0", sd)
    state, met = make_train_step(grad_accum=K)(
        state, (torch.from_numpy(x), torch.from_numpy(y).long()))
    for key in ("loss", "top1", "grad_norm"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    _assert_sd(pm, resnet_params_from_flax(_np32(jstate.params),
                                           _np32(jstate.batch_stats)),
               "resnet")


def test_resnet_o3_accumulation_follows_jax_within_the_bf16_trail_rule():
    x, y = _image_batch()
    jm, jopt, policy, jstate = _jax_resnet("O3")
    sd = resnet_params_from_flax(_np32(jstate.params),
                                 _np32(jstate.batch_stats))
    jstate, jmet = jax.jit(jax_make_step(jm, jopt, policy, grad_accum=K))(
        jstate, (jnp.asarray(x), jnp.asarray(y)))
    batch = (torch.from_numpy(x), torch.from_numpy(y).long())
    pm32, state32 = _port_resnet("O0", sd)
    state32, met32 = make_train_step(grad_accum=K)(state32, batch)
    pm, state = _port_resnet("O3", sd)
    assert {p.dtype for p in pm.parameters()} == {torch.bfloat16,
                                                  torch.float32}
    acc = []
    real = GradAccumulator.fold

    def fold(self):
        acc.append(len(self.half))
        real(self)
    GradAccumulator.fold = fold
    try:
        state, met = make_train_step(grad_accum=K)(state, batch)
    finally:
        GradAccumulator.fold = real
    assert acc == [1]                # the bf16 table through accumulators
    l32, lp, lj = (float(m["loss"]) for m in (met32, met, jmet))
    assert abs(lp - l32) <= 2 * abs(lj - l32) + 2e-3 * abs(l32)
    ref = pm32.state_dict()
    want = resnet_params_from_flax(_np32(jstate.params),
                                   _np32(jstate.batch_stats))
    names = [n for n, _ in pm.named_parameters()]
    got = pm.state_dict()
    assert _rel(_flat(got, names), _flat(ref, names)) <= 2 * _rel(
        _flat(want, names), _flat(ref, names)) + 1e-3


def test_txl_accumulation_splits_the_memory_by_streams_as_jax_does():
    toks = np.array(jax_lm_batch(jnp.asarray(0, jnp.int32), batch_size=4,
                                 seq_len=S, vocab_size=V, seed=0))
    inp, tgt = (np.ascontiguousarray(toks[:, :-1]),
                np.ascontiguousarray(toks[:, 1:]))
    policy = get_policy("O0")
    jm, jopt = jax_txl_tiny(), JaxSGD(**SGD)
    jstate = create_state(jax.random.PRNGKey(6), jm, jopt,
                          jnp.asarray(inp[:1]), policy, train_kwargs={})
    pm = transformer_xl_tiny(device="cpu")
    pm.load_state_dict(txl_params_from_flax(_np32(jstate.params)))
    mems = (np.random.RandomState(2).randn(*pm.init_mems(4).shape)
            .astype(np.float32))
    jstate, jmems, jmet = jax.jit(jax_txl_step(
        jm, jopt, policy, max_grad_norm=0.25, grad_accum=K))(
        jstate, jnp.asarray(mems), (jnp.asarray(inp), jnp.asarray(tgt)))
    state = create_train_state(pm, FusedSGD(pm.parameters(), **SGD))
    state, new_mems, met = make_txl_train_step(0.25, grad_accum=K)(
        state, torch.from_numpy(mems), (torch.from_numpy(inp),
                                        torch.from_numpy(tgt)))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(new_mems.numpy(), np.asarray(jmems), **TOL)
    _assert_sd(pm, txl_params_from_flax(_np32(jstate.params)), "txl")


@pytest.mark.parametrize("k", [3, 4])
def test_accumulator_sums_in_fp32_and_divides_as_jax(k):
    rs = np.random.RandomState(k)
    ps = [torch.nn.Parameter(torch.zeros(5, 7, dtype=dt))
          for dt in (torch.float32, torch.bfloat16, torch.float32)]
    opt = FusedSGD(ps, lr=0.1)
    acc = GradAccumulator(opt, k)
    gs = [[rs.randn(5, 7).astype(np.float32) * 10.0 ** rs.randint(-3, 3)
           for _ in ps] for _ in range(k)]
    opt.zero_grad()
    acc.begin()
    for i, mb in enumerate(gs):
        with torch.no_grad():
            for p, g in zip(ps, mb):      # what a backward adds in place
                p.grad += torch.from_numpy(g).to(p.dtype)
        if i + 1 < k:
            acc.fold()
    acc.finish()
    for j, p in enumerate(ps):
        terms = [torch.from_numpy(mb[j]).to(p.dtype).float() for mb in gs]
        total = terms[0]
        for t in terms[1:]:
            total = total + t
        want = (total / k).to(p.dtype)
        if k == 4:
            assert torch.equal(p.grad, want), j
        else:
            np.testing.assert_allclose(
                p.grad.float().numpy(), want.float().numpy(),
                rtol=2.5e-7 if p.dtype == torch.float32 else 2 ** -8,
                err_msg=str(j))


def test_bert_accumulation_at_4_matches_the_whole_batch():
    ids = np.random.RandomState(3).randint(0, V, (B, S)).astype(np.int32)
    batch = (torch.from_numpy(ids), (torch.from_numpy(ids),
                                     torch.ones(B, S)))
    out = []
    for k in (1, 4):
        pm = bert_tiny(device="cpu")
        state = create_train_state(pm, FusedSGD(pm.parameters(), lr=0.1,
                                                momentum=0.9))
        state, met = make_train_step(mlm_loss, compute_accuracy=False,
                                     grad_accum=k)(state, batch)
        out.append((float(met["loss"]), pm.state_dict()))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-5)
    for name, w in out[0][1].items():
        np.testing.assert_allclose(out[1][1][name].numpy(), w.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
