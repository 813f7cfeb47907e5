"""The port's BERT MLM model, its loss and softmax cross-entropy held
against the JAX package's, on converted bert_tiny parameters
(convert.bert_params_from_flax of a flax init), on the CPU.

(a) logits with and without an attention mask, to 1e-4: both sides
    compute in fp32 and differ only in summation order (the flash kernel is
    off on both: "auto" takes it only at sequence 2048 and up);
(b) ``mlm_loss`` and its gradient for every parameter against ``jax.grad``
    (the JAX backward runs the Pallas LayerNorm ``_bwd_kernel`` through the
    interpreter; the port's, ``layer_norm_bwd_plain``): loss rtol 1e-5,
    gradients rtol 1e-4 with atol 1e-6 (fp32 sums over rows in another
    order, and entries that cancel near zero);
(c) ``softmax_cross_entropy`` values and logit gradients, with and without
    label smoothing, to 1e-6;
(d) the structure: 41 tensors with the decoder tied to the
    word-embedding table, random init in the flax initializers'
    distributions, bidirectional attention (GPT keeps its causal path:
    tests/test_torch_gpt.py);
(e) with ``fused_attention=True`` at S = 128 and an attention mask (the
    key bias reaches the kernels as ``mask_bias[:, 0, 0, :]``), logits and
    every gradient of ``mlm_loss`` to 1e-4.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_ref import flax_init
from apex_example_tpu.models.bert import bert_tiny as jax_bert_tiny
from apex_example_tpu.ops.xentropy import \
    softmax_cross_entropy as jax_xent
from apex_example_tpu.workloads import mlm_loss as jax_mlm_loss
from apex_example_tpu_torch.convert import bert_params_from_flax
from apex_example_tpu_torch.models.bert import BertLayer, bert_tiny
from apex_example_tpu_torch.ops.xentropy import softmax_cross_entropy
from apex_example_tpu_torch.workloads import mlm_loss

LOGIT_TOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def converted():
    jm = jax_bert_tiny()
    params = flax_init(jm, jax.random.PRNGKey(2),
                       jnp.zeros((1, 8), jnp.int32))["params"]
    tree = jax.tree_util.tree_map(np.asarray, params)
    pm = bert_tiny(device="cpu")
    pm.load_state_dict(bert_params_from_flax(tree))     # strict: every name
    return jm, params, pm


def _batch(seed, b=2, s=12, v=256):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, v, size=(b, s)).astype(np.int32)
    labels = rs.randint(0, v, size=(b, s)).astype(np.int32)
    weights = (rs.rand(b, s) < 0.3).astype(np.float32)
    weights[0, 0] = 1.0
    mask = np.ones((b, s), np.int32)
    mask[1, s - 4:] = 0
    return ids, labels, weights, mask


def test_convert_loads_every_tensor_and_ties_the_decoder(converted):
    _, params, pm = converted
    names = [n for n, _ in pm.named_parameters()]
    assert len(names) == 41 and "mlm_bias" in names
    assert not any("decoder" in n for n in names)
    np.testing.assert_array_equal(
        pm.mlm_dense.weight.detach().numpy(),
        np.asarray(params["mlm_dense"]["kernel"]).T)


@pytest.mark.parametrize("with_mask", [False, True])
def test_logits_match(converted, with_mask):
    jm, params, pm = converted
    ids, _, _, mask = _batch(0)
    want = jax.jit(jm.apply, static_argnames="train")(
        {"params": params}, jnp.asarray(ids),
        attention_mask=jnp.asarray(mask) if with_mask else None, train=False)
    with torch.no_grad():
        got = pm(torch.from_numpy(ids),
                 torch.from_numpy(mask) if with_mask else None)
    assert got.dtype == torch.float32 and got.shape == (2, 12, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    if with_mask:       # the masked keys change row 1's logits
        with torch.no_grad():
            free = pm(torch.from_numpy(ids))
        assert not torch.allclose(got[1], free[1], atol=1e-3)
        torch.testing.assert_close(got[0], free[0])


def test_attention_is_bidirectional(converted):
    _, _, pm = converted
    ids = torch.from_numpy(_batch(1)[0])
    changed = ids.clone()
    changed[:, -1] = (changed[:, -1] + 1) % 256
    with torch.no_grad():
        a, b = pm(ids), pm(changed)
    assert not torch.allclose(a[:, 0], b[:, 0], atol=1e-4)


def test_mlm_loss_and_every_gradient_match_jax_grad(converted):
    jm, params, pm = converted
    ids, labels, weights, _ = _batch(2)

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(ids), train=True)
        return jax_mlm_loss(logits, (jnp.asarray(labels),
                                     jnp.asarray(weights)))

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = bert_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                        want_grads))
    pm.zero_grad(set_to_none=True)
    loss = mlm_loss(pm(torch.from_numpy(ids)),
                    (torch.from_numpy(labels), torch.from_numpy(weights)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    got = dict(pm.named_parameters())
    assert set(got) == set(want)
    for name, g in want.items():
        assert got[name].grad is not None, name
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_softmax_cross_entropy_matches_jax(smoothing):
    rs = np.random.RandomState(3)
    logits = (rs.randn(3, 5, 40) * 3).astype(np.float32)
    labels = rs.randint(0, 40, size=(3, 5)).astype(np.int32)
    dloss = rs.randn(3, 5).astype(np.float32)
    want, vjp = jax.vjp(lambda z: jax_xent(z, jnp.asarray(labels),
                                           smoothing), jnp.asarray(logits))
    (want_grad,) = vjp(jnp.asarray(dloss))
    z = torch.from_numpy(logits).requires_grad_()
    got = softmax_cross_entropy(z, torch.from_numpy(labels), smoothing)
    got.backward(torch.from_numpy(dloss))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-6, atol=1e-6)


def test_mlm_loss_is_a_weighted_mean_with_a_floor():
    logits = torch.zeros(1, 3, 4)
    labels = torch.zeros(1, 3, dtype=torch.int64)
    none = mlm_loss(logits, (labels, torch.zeros(1, 3)))
    assert float(none) == 0.0                        # denominator max(., 1)
    two = mlm_loss(logits, (labels, torch.tensor([[1.0, 0.0, 1.0]])))
    np.testing.assert_allclose(float(two), np.log(4.0), rtol=1e-6)


def test_random_init_follows_the_flax_distributions():
    pm = bert_tiny(device="cpu", seed=7)
    again = bert_tiny(device="cpu", seed=7)
    for (name, p), (_, q) in zip(pm.named_parameters(),
                                 again.named_parameters()):
        assert torch.equal(p, q), name               # the seed alone decides
    assert torch.all(pm.embeddings_ln.scale == 1)
    assert torch.all(pm.mlm_bias == 0)
    assert torch.all(pm.layers[0].attention.query.bias == 0)
    emb = pm.word_embeddings.weight.detach()
    np.testing.assert_allclose(float(emb.std()), 1 / np.sqrt(64), rtol=0.05)
    w = pm.layers[0].intermediate.weight.detach()      # [out 128, in 64]
    np.testing.assert_allclose(float(w.std()), 1 / np.sqrt(64), rtol=0.1)
    assert float(w.abs().max()) <= 2 / np.sqrt(64) / 0.87962566 + 1e-6


def test_bert_base_has_201_tensors_and_109_5m_elements():
    """The optimizer's list at full width, from the layer's own shapes
    (built on the meta device: no storage)."""
    with torch.device("meta"):
        layer = BertLayer(768, 12, 3072)
    shapes = ([(30522, 768), (512, 768), (768,), (768,)]
              + [tuple(p.shape) for p in layer.parameters()] * 12
              + [(768, 768), (768,), (768,), (768,), (30522,)])
    assert len(shapes) == 201
    assert sum(math.prod(s) for s in shapes) == 109_512_762


def test_fused_attention_with_a_mask_matches_jax():
    jm = jax_bert_tiny(fused_attention=True)
    params = flax_init(jm, jax.random.PRNGKey(5),
                       jnp.zeros((1, 8), jnp.int32))["params"]
    pm = bert_tiny(device="cpu", fused_attention=True)
    pm.load_state_dict(bert_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    ids, labels, weights, mask = _batch(6, s=128)
    mask[0, 100:] = 0

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(ids),
                          attention_mask=jnp.asarray(mask))
        return jax_mlm_loss(logits, (jnp.asarray(labels),
                                     jnp.asarray(weights))), logits

    (want_loss, want_logits), want_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    logits = pm(torch.from_numpy(ids), torch.from_numpy(mask))
    loss = mlm_loss(logits, (torch.from_numpy(labels),
                             torch.from_numpy(weights)))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    want = bert_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                        want_grads))
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
