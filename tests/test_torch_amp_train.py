"""C4's and C5's amp contracts in the port held against the JAX package's,
on the CPU, at tiny sizes (bert_tiny, transformer_xl_tiny, ResNet-18 with
num_filters 4), each test a few seconds and at most five steps.

- bert_tiny MLM with FusedLAMB at amp O2 (bf16 over fp32 masters), from
  one flax init: with a key mask, each tensor of the port's first O2 grads
  no more than twice as far from the fp32 grads (the port's at O0, which
  equal JAX's) as JAX's O2 grads are, plus 1e-3 (the key projections'
  biases, whose exact gradient is zero, aside: their grads are rounding
  noise on both sides); then five steps of the trainer's step, losses
  rtol 2e-2 (bf16 logits).
- transformer_xl_tiny with FusedAdam and the clip at O2 and at O3 (half
  parameters, half softmax), the memory carried: the first logits no more
  than twice as far from the fp32 model's as JAX's are (plus 1e-3), the
  new memory in the compute dtype on both sides; five steps, each loss no
  further from the fp32 trail's than twice JAX's distance plus 2e-3 of
  it, and the parameters after them, all as one vector, no further than
  twice JAX's plus 1e-3 (tensor by tensor, Adam's steps of about lr
  whatever a gradient's size make small tensors that start at zero, the
  biases, a matter of rounding noise on both sides).
- The dynamic skip: FusedAdam (transformer_xl_tiny, the clip, the memory
  carried) and FusedLAMB (bert_tiny) at O0 under --loss-scale dynamic; an
  inf planted in one parameter's grad on step 2 (a hook in the port, a
  custom_vjp in JAX).  That step leaves the port's parameters, m, v and
  step count bitwise as they were, as JAX's ``select_tree`` leaves its
  own, and halves the scale on both sides; every step's parameters,
  moments, step count, scale and memory equal JAX's within 1e-4 (fp32,
  sums in another order), the clean steps after the skip included, whose
  bias corrections come from the count the skip kept.
- FusedAdam and FusedLAMB at O3 on ResNet-18 (bf16 convolutions beside
  fp32 BatchNorm parameters: two dtypes): two steps of the port's trainer,
  then the JAX optimizer fed the same grads from the same parameters leaf
  by leaf: bf16 parameters within one bf16 ulp, fp32 ones and the moments
  rtol 1e-5 (LAMB's global grad norm sums in another order).
- The CLI (``train.main``, in this process) trains transformer_xl_tiny at
  O2 under dynamic scaling and bert_tiny at O3 with FusedLAMB, and their
  streams lint.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

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
from apex_example_tpu.engine import make_train_step as jax_make_step
from apex_example_tpu.models.bert import bert_tiny as jax_bert_tiny
from apex_example_tpu.models.resnet import resnet18 as jax_resnet18
from apex_example_tpu.models.transformer_xl import \
    transformer_xl_tiny as jax_txl_tiny
from apex_example_tpu.ops import _config as jax_ops_config
from apex_example_tpu.optim.fused import FusedAdam as JaxAdam
from apex_example_tpu.optim.fused import FusedLAMB as JaxLAMB
from apex_example_tpu.workloads import make_txl_train_step as jax_txl_step
from apex_example_tpu.workloads import mlm_loss as jax_mlm_loss
from apex_example_tpu_torch import amp, train
from apex_example_tpu_torch.convert import (bert_params_from_flax,
                                            resnet_params_from_flax,
                                            txl_params_from_flax)
from apex_example_tpu_torch.engine import create_train_state, make_train_step
from apex_example_tpu_torch.models.bert import bert_tiny
from apex_example_tpu_torch.models.resnet import resnet18
from apex_example_tpu_torch.models.transformer_xl import transformer_xl_tiny
from apex_example_tpu_torch.optim.fused import FusedAdam, FusedLAMB
from apex_example_tpu_torch.workloads import make_txl_train_step, mlm_loss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIL_TOL = 1e-4
B, S, V, STEPS = 4, 16, 256, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread; the JAX side on its kernels' XLA reference forms
    (``ops._config.force_xla``), which compile in a third of the
    interpreter's time (the kernels are held against the port's in
    tests/test_torch_optim.py, test_torch_layer_norm.py and the like)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with jax_ops_config.force_xla(True):
        yield
    torch.set_num_threads(before)


def _rel(a, b):
    a, b = (t.detach().float() if torch.is_tensor(t)
            else torch.from_numpy(np.array(t, np.float32)) for t in (a, b))
    return float((a - b).norm() / b.norm())


def _np32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _mlm_batches(n=STEPS):
    return [tuple(np.array(a) for a in jax_mlm_batch(
        jnp.asarray(i, jnp.int32), batch_size=B, seq_len=S, vocab_size=V,
        mask_token_id=V - 1, seed=0)) for i in range(n)]


def _lm_batches(n=STEPS):
    out = []
    for i in range(n):
        toks = np.array(jax_lm_batch(jnp.asarray(i, jnp.int32),
                                     batch_size=B, seq_len=S, vocab_size=V,
                                     seed=0))
        out.append((np.ascontiguousarray(toks[:, :-1]),
                    np.ascontiguousarray(toks[:, 1:])))
    return out


def _dtypes(md):
    return dict(dtype=md.compute, param_dtype=md.param, ln_dtype=md.ln_io,
                softmax_dtype=md.softmax)


# ---------------------------------------------------------------- C4 at O2


def test_bert_o2_lamb_with_a_key_mask_follows_jax_within_bf16_rounding():
    batches = _mlm_batches()
    ids, labels, w = batches[0]
    mask = np.ones((B, S), np.int32)
    mask[0, -5:] = 0
    mask[2, -9:] = 0
    policy = get_policy("O2")
    jm = jax_bert_tiny(**_dtypes(jamp.module_dtypes(policy)))
    jopt = JaxLAMB(lr=5e-3, weight_decay=0.01)
    jstate = create_state(jax.random.PRNGKey(3), jm, jopt,
                          jnp.asarray(ids[:1]), policy)
    init = jax.tree_util.tree_map(np.asarray, jstate.params)
    weights = bert_params_from_flax(init)
    target = (torch.from_numpy(labels), torch.from_numpy(w))

    pm32 = bert_tiny(device="cpu")
    pm32.load_state_dict(weights)
    mlm_loss(pm32(torch.from_numpy(ids), torch.from_numpy(mask)),
             target).backward()
    g32 = {n: p.grad for n, p in pm32.named_parameters()}

    ppolicy, scaler = amp.initialize("O2")
    pm = bert_tiny(device="cpu", **_dtypes(amp.module_dtypes(ppolicy)))
    pm.load_state_dict(weights)
    assert pm.layers[0].attention.query.weight.dtype == torch.float32
    mlm_loss(pm(torch.from_numpy(ids), torch.from_numpy(mask)),
             target).backward()
    jgrads = jax.jit(jax.grad(lambda p: jax_mlm_loss(
        jm.apply({"params": p}, jnp.asarray(ids),
                 attention_mask=jnp.asarray(mask)),
        (jnp.asarray(labels), jnp.asarray(w)))))(jstate.params)
    j16 = bert_params_from_flax(_np32(jgrads))
    for name, p in pm.named_parameters():
        if name.endswith("attention.key.bias"):
            continue
        assert p.grad.dtype == torch.float32
        assert _rel(p.grad, g32[name]) <= 2 * _rel(j16[name], g32[name]) \
            + 1e-3, name

    pm.zero_grad(set_to_none=False)
    pstate = create_train_state(pm, FusedLAMB(pm.parameters(), lr=5e-3,
                                              weight_decay=0.01),
                                ppolicy, scaler)
    jstep = jax.jit(jax_make_step(jm, jopt, policy, loss_fn=jax_mlm_loss,
                                  compute_accuracy=False))
    pstep = make_train_step(mlm_loss)
    for ids, labels, w in batches:
        jstate, jmet = jstep(jstate, (jnp.asarray(ids), (
            jnp.asarray(labels), jnp.asarray(w))))
        pstate, pmet = pstep(pstate, (torch.from_numpy(ids), (
            torch.from_numpy(labels), torch.from_numpy(w))))
        np.testing.assert_allclose(float(pmet["loss"]), float(jmet["loss"]),
                                   rtol=2e-2)
        assert float(pmet["scale"]) == float(jmet["scale"]) == 1.0
    assert all(p.dtype == torch.float32 for p in pm.parameters())


# ------------------------------------------------------ C5 at O2 and O3


def _txl_trail(step_fn, state, mems, batches, torch_side=True):
    losses = []
    for x, y in batches:
        if torch_side:
            state, mems, met = step_fn(state, mems, (torch.from_numpy(x),
                                                     torch.from_numpy(y)))
        else:
            state, mems, met = step_fn(state, mems, (jnp.asarray(x),
                                                     jnp.asarray(y)))
        losses.append(float(met["loss"]))
    return state, mems, losses


@pytest.mark.parametrize("level", ["O2", "O3"])
def test_txl_amp_trail_with_carried_memory_follows_jax_within_bf16_rounding(
        level):
    batches = _lm_batches()
    x0 = batches[0][0]
    policy = get_policy(level)
    jmd = jamp.module_dtypes(policy)
    jm = jax_txl_tiny(**_dtypes(jmd))
    jopt = JaxAdam(lr=2e-3, weight_decay=0.01)
    jstate = create_state(jax.random.PRNGKey(6), jm, jopt,
                          jnp.asarray(x0[:1]), policy, train_kwargs={})
    init = jax.tree_util.tree_map(np.asarray, jstate.params)
    weights = txl_params_from_flax(init)
    if level == "O3":
        assert weights["layers.0.attn.q.weight"].dtype == torch.bfloat16

    def port(level_):
        ppolicy, scaler = amp.initialize(level_)
        pm = transformer_xl_tiny(device="cpu",
                                 **_dtypes(amp.module_dtypes(ppolicy)))
        pm.load_state_dict(weights)
        return pm, create_train_state(pm, FusedAdam(
            pm.parameters(), lr=2e-3, weight_decay=0.01), ppolicy, scaler)

    pm32, state32 = port("O0")
    pm, pstate = port(level)
    half = jmd.compute
    assert pm.layers[0].attn.q.weight.dtype == (
        torch.bfloat16 if level == "O3" else torch.float32)
    assert pm.layers[0].attn_ln.scale.dtype == torch.float32
    with torch.no_grad():
        x = torch.from_numpy(x0)
        l32, _ = pm32(x, pm32.init_mems(B))
        lp, mp = pm(x, pm.init_mems(B))
    lj, mj = jm.apply({"params": jstate.params}, jnp.asarray(x0),
                      mems=jm.init_mems(B))
    assert lp.dtype == torch.float32 and mp.dtype == torch.bfloat16
    assert mj.dtype == half == jnp.bfloat16
    assert _rel(lp, l32) <= 2 * _rel(np.asarray(lj), l32) + 1e-3

    jstep = jax.jit(jax_txl_step(jm, jopt, policy, max_grad_norm=0.25))
    pstep = make_txl_train_step(max_grad_norm=0.25)
    state32, _, loss32 = _txl_trail(pstep, state32, pm32.init_mems(B),
                                    batches)
    pstate, pmems, lossp = _txl_trail(pstep, pstate, pm.init_mems(B),
                                      batches)
    jstate, jmems, lossj = _txl_trail(jstep, jstate, jm.init_mems(B),
                                      batches, torch_side=False)
    assert pmems.dtype == torch.bfloat16 and jmems.dtype == jnp.bfloat16
    for a, b, c in zip(lossp, lossj, loss32):
        assert abs(a - c) <= 2 * abs(b - c) + 2e-3 * abs(c), (a, b, c)
    want = txl_params_from_flax(_np32(jstate.params))
    ref = dict(pm32.named_parameters())
    flat = lambda ts: torch.cat([t.detach().float().reshape(-1)  # noqa
                                 for t in ts])
    names = list(ref)
    got = flat(dict(pm.named_parameters())[n] for n in names)
    assert _rel(got, flat(ref[n] for n in names)) <= 2 * _rel(
        flat(want[n] for n in names), flat(ref[n] for n in names)) + 1e-3


# ------------------------------------------------------- the dynamic skip


@jax.custom_vjp
def _plant_inf(x):
    return x


_plant_inf.defvjp(lambda x: (x, None),
                  lambda _, g: (g.at[(0,) * g.ndim].add(jnp.inf),))


class _Planted:
    """The JAX model with an inf added to the gradient of the parameter at
    ``path`` (its first element), through a custom_vjp identity."""

    def __init__(self, model, path):
        self.model, self.path = model, path

    def apply(self, variables, *args, **kw):
        params = jax.tree_util.tree_map_with_path(
            lambda p, x: _plant_inf(x) if tuple(k.key for k in p)
            == self.path else x, variables["params"])
        return self.model.apply({**variables, "params": params}, *args,
                                **kw)


def _plant(param):
    """A hook adding inf to the first element of ``param``'s grad."""
    planted = torch.zeros_like(param)
    planted.view(-1)[0] = float("inf")
    return param.register_hook(lambda g: g + planted)


def _assert_state_follows(popt, pm, jstate, convert):
    want = convert(_np32(jstate.params))
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=TRAIL_TOL, atol=TRAIL_TOL,
                                   err_msg=name)
    for field, got in (("mu", popt.mu), ("nu", popt.nu)):
        want = convert(_np32(getattr(jstate.opt_state, field)))
        for (name, _), t in zip(pm.named_parameters(), got):
            np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                       rtol=TRAIL_TOL, atol=TRAIL_TOL,
                                       err_msg=f"{field} {name}")
    assert popt.step_count == int(jstate.opt_state.step)


def _skip_trail(pstep, pstate, jstep, jplanted, jstate, batches, param,
                convert, mems=None):
    """Four steps, the second with an inf planted; the checks of the
    module docstring at every step."""
    popt, pm = pstate.optimizer, pstate.model
    scales = []
    for i, batch in enumerate(batches):
        planted = i == 1
        before = [t.detach().clone() for t in
                  list(pm.parameters()) + popt.mu + popt.nu]
        jbefore = jax.tree_util.tree_map(np.asarray, (jstate.params,
                                                      jstate.opt_state))
        count = popt.step_count
        hook = _plant(param) if planted else None
        tb = tuple(torch.from_numpy(a) for a in batch[:1]) + (
            (torch.from_numpy(batch[1]),) if len(batch) == 2 else
            ((torch.from_numpy(batch[1]), torch.from_numpy(batch[2])),))
        jb = tuple(jnp.asarray(a) for a in batch[:1]) + (
            (jnp.asarray(batch[1]),) if len(batch) == 2 else
            ((jnp.asarray(batch[1]), jnp.asarray(batch[2])),))
        fn = jplanted if planted else jstep
        if mems is None:
            pstate, pmet = pstep(pstate, tb)
            jstate, jmet = fn(jstate, jb)
        else:
            pmems, jmems = mems
            pstate, pmems, pmet = pstep(pstate, pmems, tb)
            jstate, jmems, jmet = fn(jstate, jmems, jb)
            mems = (pmems, jmems)
            np.testing.assert_allclose(pmems.numpy(), np.asarray(jmems),
                                       rtol=TRAIL_TOL, atol=TRAIL_TOL)
        if hook is not None:
            hook.remove()
        assert float(pmet["grads_finite"]) == float(jmet["grads_finite"]) \
            == (0.0 if planted else 1.0)
        assert float(pmet["scale"]) == float(jmet["scale"])
        scales.append(float(pmet["scale"]))
        if planted:
            after = list(pm.parameters()) + popt.mu + popt.nu
            assert all(torch.equal(a, b) for a, b in zip(after, before))
            assert popt.step_count == count
            jafter = jax.tree_util.tree_map(np.asarray, (jstate.params,
                                                         jstate.opt_state))
            assert all(np.array_equal(a, b) for a, b in zip(
                jax.tree_util.tree_leaves(jafter),
                jax.tree_util.tree_leaves(jbefore)))
        _assert_state_follows(popt, pm, jstate, convert)
    assert scales == [2.0 ** 16, 2.0 ** 15, 2.0 ** 15, 2.0 ** 15]
    assert popt.step_count == len(batches) - 1


def test_dynamic_scaling_skips_a_fused_adam_txl_step_as_jax_does():
    batches = _lm_batches(4)
    policy = get_policy("O0", loss_scale="dynamic")
    # eps 1e-6, not Adam's 1e-8: a gradient element of rounding-noise size
    # (~1e-9) would be normalised into a step of random sign and size ~lr
    jm = jax_txl_tiny()
    jopt = JaxAdam(lr=2e-3, eps=1e-6, weight_decay=0.01)
    jstate = create_state(jax.random.PRNGKey(6), jm, jopt,
                          jnp.asarray(batches[0][0][:1]), policy,
                          train_kwargs={})
    weights = txl_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                          jstate.params))
    ppolicy, scaler = amp.initialize("O0", loss_scale="dynamic")
    pm = transformer_xl_tiny(device="cpu")
    pm.load_state_dict(weights)
    pstate = create_train_state(pm, FusedAdam(
        pm.parameters(), lr=2e-3, eps=1e-6, weight_decay=0.01), ppolicy,
        scaler)
    jstep = jax.jit(jax_txl_step(jm, jopt, policy, max_grad_norm=0.25))
    jplanted = jax.jit(jax_txl_step(_Planted(jm, ("layer_0", "attn",
                                                  "u_bias")), jopt, policy,
                                    max_grad_norm=0.25))
    _skip_trail(make_txl_train_step(max_grad_norm=0.25), pstate, jstep,
                jplanted, jstate, batches, pm.layers[0].attn.u_bias,
                txl_params_from_flax, mems=(pm.init_mems(B),
                                            jm.init_mems(B)))


def test_dynamic_scaling_skips_a_fused_lamb_bert_step_as_jax_does():
    batches = _mlm_batches(4)
    policy = get_policy("O0", loss_scale="dynamic")
    jm = jax_bert_tiny()
    jopt = JaxLAMB(lr=5e-3, weight_decay=0.01)
    jstate = create_state(jax.random.PRNGKey(3), jm, jopt,
                          jnp.asarray(batches[0][0][:1]), policy)
    weights = bert_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           jstate.params))
    ppolicy, scaler = amp.initialize("O0", loss_scale="dynamic")
    pm = bert_tiny(device="cpu")
    pm.load_state_dict(weights)
    pstate = create_train_state(pm, FusedLAMB(
        pm.parameters(), lr=5e-3, weight_decay=0.01), ppolicy, scaler)
    kw = dict(loss_fn=jax_mlm_loss, compute_accuracy=False)
    jstep = jax.jit(jax_make_step(jm, jopt, policy, **kw))
    jplanted = jax.jit(jax_make_step(_Planted(jm, ("mlm_bias",)), jopt,
                                     policy, **kw))
    _skip_trail(make_train_step(mlm_loss), pstate, jstep, jplanted, jstate,
                batches, pm.mlm_bias, bert_params_from_flax)


# ------------------------------------------ mixed dtypes: ResNet-18 at O3


IMG_SIZE, IMG_CLASSES = 16, 10


def _to_flax(template, tensors):
    """The port's ResNet tensors (by name) as a flax tree shaped like
    ``template``, each in its own dtype: a conv weight OIHW -> HWIO, the
    classifier's transposed (convert.resnet_params_from_flax inverted).
    Copies: a jax array made from a numpy view may share the tensor's
    memory, which the port's optimizer then updates in place."""
    def leaf(path, _):
        module = ".".join(k.key for k in path[:-1])
        name = path[-1].key
        t = tensors[f"{module}.{'weight' if name == 'kernel' else name}"]
        bf16 = t.dtype == torch.bfloat16
        if name == "kernel":
            t = t.permute(2, 3, 1, 0) if t.dim() == 4 else t.T
        t = np.array(t.detach().float().numpy())        # a copy
        return jnp.asarray(t).astype(jnp.bfloat16 if bf16 else jnp.float32)
    return jax.tree_util.tree_map_with_path(leaf, template)


@pytest.mark.parametrize("opt", ["adam", "lamb"])
def test_resnet18_o3_adam_and_lamb_update_leaf_by_leaf_as_jax(opt):
    jm = jax_resnet18(num_classes=IMG_CLASSES, num_filters=4,
                      small_stem=True)
    template = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG_SIZE, IMG_SIZE, 3)),
        train=False))
    rs = np.random.RandomState(5)
    params = jax.tree_util.tree_map(
        lambda a: (rs.randn(*a.shape) * 0.2).astype(np.float32),
        template["params"])
    stats = jax.tree_util.tree_map(
        lambda a: np.ones(a.shape, np.float32), template["batch_stats"])
    policy, scaler = amp.initialize("O3")
    md = amp.module_dtypes(policy)
    pm = resnet18(num_classes=IMG_CLASSES, num_filters=4, small_stem=True,
                  dtype=md.compute, param_dtype=md.param,
                  bn_dtype=md.bn_stats, bn_io_dtype=md.bn_io, device="cpu")
    pm.load_state_dict(resnet_params_from_flax(params, stats))
    cls, jcls = ((FusedAdam, JaxAdam) if opt == "adam"
                 else (FusedLAMB, JaxLAMB))
    popt = cls(pm.parameters(), lr=1e-3, weight_decay=1e-4)
    assert {p.dtype for p in pm.parameters()} == {torch.bfloat16,
                                                  torch.float32}
    assert len(popt.groups) == 2
    state = create_train_state(pm, popt, policy, scaler)
    step = make_train_step()
    named = dict(pm.named_parameters())
    jparams = _to_flax(template["params"], named)
    jopt = jcls(lr=1e-3, weight_decay=1e-4)
    jstate = jopt.init(jparams)
    # the Pallas kernels themselves (interpreted): the port's Adam and
    # LAMB take their arithmetic, which the XLA forms round elsewhere
    with jax_ops_config.force_xla(False):
        japply = jax.jit(jopt.apply).lower(jparams, jstate,
                                           jparams).compile()
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        x = torch.randn(B, IMG_SIZE, IMG_SIZE, 3, generator=gen)
        y = torch.randint(0, IMG_CLASSES, (B,), generator=gen)
        state, metrics = step(state, (x, y))
        assert np.isfinite(float(metrics["loss"]))
        grads = _to_flax(template["params"],
                         {n: p.grad for n, p in named.items()})
        jparams, jstate = japply(grads, jstate, jparams)
    want = resnet_params_from_flax(_np32(jparams))
    mu = resnet_params_from_flax(_np32(jstate.mu))
    nu = resnet_params_from_flax(_np32(jstate.nu))
    for i, (name, p) in enumerate(named.items()):
        bf16 = p.dtype == torch.bfloat16
        np.testing.assert_allclose(
            p.detach().float().numpy(), want[name].numpy(),
            rtol=2.0 ** -8 if bf16 else 1e-5, atol=1e-6, err_msg=name)
        for got, w in ((popt.mu[i], mu[name]), (popt.nu[i], nu[name])):
            np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=name)
    assert popt.step_count == int(jstate.step) == 2


# ----------------------------------------------------------------- the CLI


@pytest.mark.parametrize("argv", [
    ["--arch", "transformer_xl_tiny", "--opt", "adam", "--opt-level", "O2",
     "--loss-scale", "dynamic"],
    ["--arch", "bert_tiny", "--opt", "lamb", "--opt-level", "O3"]])
def test_lm_cli_at_amp_levels_lints(tmp_path, argv):
    stream = tmp_path / "lm.jsonl"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):       # train.main in-process
        code = train.main(
            ["--device", "cpu", "--batch-size", "4", "--seq-len", "16",
             "--lr", "1e-3", "--steps-per-epoch", "3", "--print-freq", "1",
             "--metrics-jsonl", str(stream), *argv])
    assert code == 0
    level = argv[argv.index("--opt-level") + 1]
    assert f"opt-level {level} (compute bfloat16" in out.getvalue()
    lint = subprocess.run(
        [sys.executable, "tools/metrics_lint.py", str(stream),
         "--require-summary"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert lint.returncode == 0, lint.stdout + lint.stderr
    records = [json.loads(ln) for ln in stream.read_text().splitlines()]
    steps = [r for r in records if r["record"] == "step"]
    scale = 65536.0 if "dynamic" in argv else 1.0
    assert [r["step"] for r in steps] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and r["scale"] == scale
               and r["grads_finite"] == 1.0 for r in steps)
