"""The port's Transformer-XL held against the JAX package's on converted
transformer_xl_tiny parameters (convert.txl_params_from_flax of a flax
init, with u_bias, v_bias and the LayerNorms drawn at random so that every
parameter matters), on the CPU.  The JAX LayerNorm runs its Pallas kernel
through the interpreter (tests/conftest.py).

- ``rel_shift`` equals the JAX function exactly (it only moves elements).
- Logits and new memories at seq 24 > mem_len 16 and at seq 8 < 16, from
  zero memories and then from the carried ones, atol 1e-5: both sides
  compute in fp32 and differ only in summation order.
- The loss's gradient for every parameter, rtol 1e-4 (atol 1e-6 for the
  elements that cancel near zero), with carried memories.
- The memory is carried and detached: a second segment's loss differs with
  the first segment's memory from its loss on zero memory, the new memory
  carries no graph, and the second segment's backward leaves the first
  segment's graph untouched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_ref import flax_init
from apex_example_tpu.models.transformer_xl import rel_shift as jax_rel_shift
from apex_example_tpu.models.transformer_xl import \
    transformer_xl_tiny as jax_txl_tiny
from apex_example_tpu.workloads import lm_loss as jax_lm_loss
from apex_example_tpu_torch.convert import txl_params_from_flax
from apex_example_tpu_torch.models.transformer_xl import (rel_shift,
                                                          transformer_xl_tiny)
from apex_example_tpu_torch.workloads import lm_loss

FWD_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def converted():
    jm = jax_txl_tiny()
    params = flax_init(jm, jax.random.PRNGKey(5),
                       jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree_util.tree_map(np.array, params["params"])
    rs = np.random.RandomState(11)
    for i in range(jm.num_layers):
        layer = tree[f"layer_{i}"]
        for name in ("u_bias", "v_bias"):
            layer["attn"][name] = rs.randn(
                *layer["attn"][name].shape).astype(np.float32) * 0.5
        for ln in ("attn_ln", "ff_ln"):
            layer[ln]["scale"] = (1 + 0.2 * rs.randn(
                *layer[ln]["scale"].shape)).astype(np.float32)
            layer[ln]["bias"] = (0.2 * rs.randn(
                *layer[ln]["bias"].shape)).astype(np.float32)
    pm = transformer_xl_tiny(device="cpu")
    pm.load_state_dict(txl_params_from_flax(tree))     # strict: every name
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jm, jparams, tree, pm


def _ids(seed, b, qlen, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, size=(b, qlen))


@pytest.mark.parametrize("lead,q,k", [((2, 3), 4, 4), ((2, 3), 3, 7),
                                      ((1,), 5, 13), ((2, 2), 6, 2)])
def test_rel_shift_equals_jax(lead, q, k):
    x = np.random.RandomState(q * k).randn(*lead, q, k).astype(np.float32)
    want = np.asarray(jax_rel_shift(jnp.asarray(x)))
    got = rel_shift(torch.from_numpy(x))
    assert got.shape == (*lead, q, k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_convert_maps_every_flax_name(converted):
    _, _, tree, pm = converted
    layer = tree["layer_1"]
    np.testing.assert_array_equal(
        pm.layers[1].attn.r.weight.detach().numpy(),
        layer["attn"]["r"]["kernel"].T)
    np.testing.assert_array_equal(pm.layers[1].attn.v_bias.detach().numpy(),
                                  layer["attn"]["v_bias"])
    np.testing.assert_array_equal(pm.layers[0].ff2.bias.detach().numpy(),
                                  tree["layer_0"]["ff2"]["bias"])
    assert pm.layers[0].attn.q.bias is None
    n = sum(p.numel() for p in pm.parameters())
    assert n == sum(a.size for a in jax.tree_util.tree_leaves(tree))
    assert len(list(pm.parameters())) == 1 + 15 * pm.num_layers


@pytest.mark.parametrize("qlen", [24, 8])
def test_logits_and_mems_match_jax_with_carried_memory(converted, qlen):
    jm, jparams, _, pm = converted
    jmems, pmems = None, None
    for seg in range(2):
        ids = _ids(seg, 2, qlen)
        want, jmems = jm.apply({"params": jparams}, jnp.asarray(ids),
                               mems=jmems)
        with torch.no_grad():
            got, pmems = pm(torch.from_numpy(ids), pmems)
        assert got.dtype == torch.float32 and got.shape == (2, qlen, 256)
        assert pmems.shape == (pm.num_layers, 2, pm.mem_len, pm.d_model)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FWD_TOL, atol=FWD_TOL)
        np.testing.assert_allclose(pmems.numpy(), np.asarray(jmems),
                                   rtol=FWD_TOL, atol=FWD_TOL)


def test_gradients_match_jax(converted):
    jm, jparams, _, pm = converted
    ids = [_ids(s, 2, 24) for s in (3, 4)]
    tgt = _ids(5, 2, 24)
    mems = jax.jit(jm.apply)({"params": jparams}, jnp.asarray(ids[0]))[1]

    def loss_fn(params):
        logits, _ = jm.apply({"params": params}, jnp.asarray(ids[1]),
                             mems=mems)
        return jax_lm_loss(logits, jnp.asarray(tgt))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    with torch.no_grad():
        _, pmems = pm(torch.from_numpy(ids[0]))
    pm.zero_grad(set_to_none=True)
    logits, _ = pm(torch.from_numpy(ids[1]), pmems)
    loss = lm_loss(logits, torch.from_numpy(tgt))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=FWD_TOL)
    want = txl_params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in pm.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_memory_is_carried_and_detached(converted):
    _, _, _, pm = converted
    first, second = torch.from_numpy(_ids(6, 2, 8)), \
        torch.from_numpy(_ids(7, 2, 8))
    tgt = torch.from_numpy(_ids(8, 2, 8))
    logits, mems = pm(first)
    assert not mems.requires_grad and mems.grad_fn is None
    assert mems.abs().sum() > 0
    carried = lm_loss(pm(second, mems)[0], tgt)
    fresh = lm_loss(pm(second, pm.init_mems(2))[0], tgt)
    assert abs(float(carried.detach()) - float(fresh.detach())) > 1e-4
    pm.zero_grad(set_to_none=True)
    carried.backward()
    assert all(p.grad is not None for p in pm.parameters())
    # Had the backward reached into segment one's graph, it would have
    # freed that graph's saved tensors, and this second pass would raise.
    logits.sum().backward()
