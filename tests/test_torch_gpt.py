"""The port's GPT held against the JAX package's on converted gpt_tiny
parameters (convert.gpt_params_from_flax of a flax init), on the CPU.

(a) the plain causal forward's logits, to 1e-4: both sides compute in
    fp32 and differ only in summation order, which over two layers and a
    256-way head stays well under it;
(b) a scripted sequence of paged slot-decode steps — a prefill chunk,
    decode lanes, a dead slot and a copy-on-write tick — through both
    sides' step: logits and the updated K/V arenas to 1e-5;
(c) ``sample_tokens``: greedy and top-k filtering agree on fixed logits;
(d) with ``fused_attention=True`` at S = 256 (the flash-attention route on
    both sides), logits and every gradient to 1e-4; "auto" chooses the
    kernels at sequence 2048 and up under an fp32 softmax, as JAX does;
(e) amp O3's module dtypes (bf16 parameters and half softmax) against
    JAX's logits within bf16 rounding; the converters load GPT and BERT
    trees whose position table was widened to 2048.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_ref import flax_init
from apex_example_tpu.models.bert import _resolve_fused_attention
from apex_example_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from apex_example_tpu.models.gpt import sample_tokens as jax_sample_tokens
from apex_example_tpu_torch.convert import gpt_params_from_flax
from apex_example_tpu_torch.models.bert import (BertLayer, paged_step,
                                                resolve_fused_attention)
from apex_example_tpu_torch.models.gpt import (gpt_tiny, sample_tokens,
                                               topk_filter)

STEP_TOL = 1e-5
# the JAX sampler as the serving engine runs it: one compiled program for
# every temperature and top-k (both enter as traced values)
jax_sample_tokens = jax.jit(jax_sample_tokens)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: these tiny shapes gain
    nothing from intra-op threads, and the JAX package's wall-clock tests
    running beside them lose from the contention."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def converted():
    jm = jax_gpt_tiny()
    params = flax_init(jm, jax.random.PRNGKey(1),
                       jnp.zeros((1, 4), jnp.int32))["params"]
    tree = jax.tree_util.tree_map(np.asarray, params)
    pm = gpt_tiny(device="cpu")
    pm.load_state_dict(gpt_params_from_flax(tree))     # strict: every name
    return jm, params, tree, pm.eval()


def test_convert_transposes_dense_kernels(converted):
    _, _, tree, pm = converted
    kernel = tree["layer_1"]["attention"]["query"]["kernel"]      # [in, out]
    np.testing.assert_array_equal(
        pm.layers[1].attention.query.weight.detach().numpy(), kernel.T)
    np.testing.assert_array_equal(
        pm.word_embeddings.weight.detach().numpy(),
        tree["word_embeddings"]["embedding"])


def test_full_causal_forward_matches(converted):
    jm, params, _, pm = converted
    ids = np.random.RandomState(0).randint(0, jm.vocab_size, size=(2, 12))
    want = jax.jit(jm.apply, static_argnames="train")(
        {"params": params}, jnp.asarray(ids, jnp.int32), train=False)
    with torch.no_grad():
        got = pm(torch.from_numpy(ids))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


# Three slots, block size 4, 8 arena blocks, 4 blocks per table row.  Each
# tick: (tokens [S, C], table, fill, n_new, cow_src, cow_dst).
S, BS, NB, MB = 3, 4, 8, 4
_rs = np.random.RandomState(7)
_TOK = [_rs.randint(0, 256, size=(S, BS)) for _ in range(3)]
TICKS = [
    # slot 0 prefills a full block into block 0, slot 1 a partial chunk
    # into block 1; slot 2 is dead (no lanes, an all-zero table row).
    (_TOK[0], [[0, 0, 0, 0], [1, 0, 0, 0], [0, 0, 0, 0]],
     [0, 0, 0], [4, 3, 0], [-1, -1, -1], [-1, -1, -1]),
    # slot 0 decodes into a fresh block 2; slot 1 now maps shared block 0
    # up to fill 3 and its write at position 3 copies it to block 3 first
    # (COW); slot 2 prefills two tokens into block 4.
    (_TOK[1], [[0, 2, 0, 0], [3, 0, 0, 0], [4, 0, 0, 0]],
     [4, 3, 0], [1, 1, 2], [-1, 0, -1], [-1, 3, -1]),
    # decode lanes everywhere; slot 1 crosses into block 5.
    (_TOK[2], [[0, 2, 0, 0], [3, 5, 0, 0], [4, 0, 0, 0]],
     [5, 4, 2], [1, 1, 1], [-1, -1, -1], [-1, -1, -1]),
]


def test_paged_slot_decode_steps_match(converted):
    jm, params, _, pm = converted
    dec = jm.clone(decode=True, slot_decode=True, fused_attention=False,
                   kv_num_blocks=NB, kv_block_size=BS)
    shapes = jax.eval_shape(dec.init, jax.random.PRNGKey(0),
                            jnp.zeros((S, MB * BS), jnp.int32))["cache"]
    cache = jax.tree_util.tree_map(lambda t: jnp.zeros(t.shape, t.dtype),
                                   shapes)
    hd = pm.hidden_size // pm.num_heads
    arenas = [(torch.zeros(NB, BS, pm.num_heads, hd),
               torch.zeros(NB, BS, pm.num_heads, hd))
              for _ in range(pm.num_layers)]
    apply = jax.jit(functools.partial(dec.apply, train=False,
                                      mutable=["cache"]))
    for tok, table, fill, n_new, cow_src, cow_dst in TICKS:
        host = [np.asarray(a, np.int32) for a in
                (table, fill, n_new, cow_src, cow_dst)]
        paged = dict(zip(("block_table", "fill", "n_new", "cow_src",
                          "cow_dst"), map(jnp.asarray, host)))
        want, mut = apply({"params": params, "cache": cache},
                          jnp.asarray(tok, jnp.int32), paged=paged)
        cache = mut["cache"]
        step = paged_step(arenas, tok, *host, device="cpu")
        with torch.no_grad():
            got = pm(step.tokens, step)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=STEP_TOL, atol=STEP_TOL)
        for i, (k, v) in enumerate(arenas):
            layer = cache[f"layer_{i}"]["attention"]
            np.testing.assert_allclose(
                k.numpy(), np.asarray(layer["cached_key"]),
                rtol=STEP_TOL, atol=STEP_TOL)
            np.testing.assert_allclose(
                v.numpy(), np.asarray(layer["cached_value"]),
                rtol=STEP_TOL, atol=STEP_TOL)
    # The COW tick really copied: block 3 starts with block 0's first
    # three rows, then slot 1's own write.
    k0 = arenas[0][0]
    np.testing.assert_array_equal(k0[3, :3].numpy(), k0[0, :3].numpy())
    assert not torch.equal(k0[3, 3], k0[0, 3])


def _fixed_logits():
    lg = np.random.RandomState(3).randn(5, 50).astype(np.float32)
    lg[1, 3] = lg[1, 7] = lg[1].max() + 1.0     # tied maximum: first wins
    lg[2, 4] = 6.0
    lg[2, [9, 11, 20]] = 5.0                    # tie at the 2nd/3rd value
    return lg


def test_sample_tokens_greedy_matches():
    lg = _fixed_logits()
    want = jax_sample_tokens(jax.random.PRNGKey(0), jnp.asarray(lg), 0.0, 0)
    got = sample_tokens(torch.from_numpy(lg), 0.0, 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[1]) == 3
    # top_k 1 at any temperature is greedy on both sides (rows without a
    # tied maximum: a tie keeps both candidates, and either may be drawn)
    lg = np.delete(lg, 1, axis=0)
    t = np.full(len(lg), 0.7, np.float32)
    got1 = sample_tokens(torch.from_numpy(lg), t, 1,
                         torch.Generator().manual_seed(0))
    want1 = jax_sample_tokens(jax.random.PRNGKey(5), jnp.asarray(lg),
                              jnp.asarray(t), 1)
    np.testing.assert_array_equal(got1.numpy(), np.asarray(want1))
    np.testing.assert_array_equal(got1.numpy(), lg.argmax(-1))


@pytest.mark.parametrize("k", [[0, 1, 2, 3, 50], [5, 5, 3, 2, 1]])
def test_topk_filter_keeps_what_jax_samples_from(k):
    lg = _fixed_logits()
    k = np.asarray(k)
    kept = torch.isfinite(topk_filter(torch.from_numpy(lg), k)).numpy()
    for b in range(lg.shape[0]):
        if k[b] == 0:
            assert kept[b].all()
        else:
            thresh = np.sort(lg[b])[::-1][k[b] - 1]
            np.testing.assert_array_equal(kept[b], lg[b] >= thresh)
            assert kept[b].sum() >= k[b]
    assert kept[2].sum() == 4          # ties keep >= k candidates
    # every token the JAX sampler draws under the same top-k lies in the
    # port's kept set (temperature 1, several keys)
    t = jnp.ones((lg.shape[0],), jnp.float32)
    for seed in range(8):
        drawn = np.asarray(jax_sample_tokens(
            jax.random.PRNGKey(seed), jnp.asarray(lg), t, jnp.asarray(k)))
        assert kept[np.arange(lg.shape[0]), drawn].all()
    port = sample_tokens(torch.from_numpy(lg), np.ones(5, np.float32), k,
                         torch.Generator().manual_seed(1)).numpy()
    assert kept[np.arange(lg.shape[0]), port].all()


FUSED_TOL = 1e-4


def test_fused_attention_model_matches_jax_logits_and_grads():
    """gpt_tiny with ``fused_attention=True`` at S = 256 on both sides (the
    JAX layers run the Pallas kernels through the interpreter, the port's
    the plain version of its kernels): logits and every gradient of the
    mean next-token loss, atol = rtol 1e-4."""
    jm = jax_gpt_tiny(max_position=256, fused_attention=True)
    params = flax_init(jm, jax.random.PRNGKey(3),
                       jnp.zeros((1, 8), jnp.int32))["params"]
    tree = jax.tree_util.tree_map(np.asarray, params)
    pm = gpt_tiny(device="cpu", max_position=256, fused_attention=True)
    pm.load_state_dict(gpt_params_from_flax(tree))
    assert pm.layers[0].attention.uses_kernel(256)
    rs = np.random.RandomState(4)
    ids = rs.randint(0, 256, size=(1, 256))
    tgt = rs.randint(0, 256, size=(1, 256))

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(ids, jnp.int32))
        lse = jax.scipy.special.logsumexp(logits, -1)
        picked = jnp.take_along_axis(logits, jnp.asarray(tgt)[..., None],
                                     -1)[..., 0]
        return jnp.mean(lse - picked), logits

    (_, want_logits), want_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    logits = pm(torch.from_numpy(ids))
    torch.nn.functional.cross_entropy(logits.reshape(-1, 256),
                                      torch.from_numpy(tgt).reshape(-1)
                                      ).backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=FUSED_TOL,
                               atol=FUSED_TOL)
    want = gpt_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                       want_grads))
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=FUSED_TOL, atol=FUSED_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("setting,seq,softmax,want", [
    ("auto", 2048, jnp.float32, True), ("auto", 2047, jnp.float32, False),
    ("auto", 4096, jnp.float32, True), (True, 16, jnp.float32, True),
    (False, 4096, jnp.float32, False), (True, 4096, jnp.bfloat16, False),
    ("auto", 2048, jnp.bfloat16, False)])
def test_auto_takes_the_kernels_at_2048_and_up_as_jax(setting, seq, softmax,
                                                      want):
    """The route choice only (no run at 2048): the port's rule against
    the JAX package's ``_resolve_fused_attention``, and a causal layer
    built with the setting (on the meta device: no storage)."""
    tdt = torch.float32 if softmax == jnp.float32 else torch.bfloat16
    assert _resolve_fused_attention(setting, seq, softmax) is want
    assert resolve_fused_attention(setting, seq, tdt) is want
    layer = BertLayer(64, 4, 128, device="meta", causal=True,
                      softmax_dtype=tdt, fused_attention=setting)
    assert layer.attention.uses_kernel(seq) is want


def test_o3_dtypes_forward_matches_jax():
    """amp O3's module dtypes (bf16 parameters, compute and softmax; the
    LayerNorms' parameters and the head bias fp32): the einsum route with
    a half softmax (masks at -1e4), held to JAX's logits within bf16
    rounding (atol = rtol 5e-2: activations rounded to 8 bits at other
    places in the two frameworks)."""
    kw = dict(dtype=jnp.bfloat16, param_dtype=jnp.bfloat16,
              softmax_dtype=jnp.bfloat16)
    jm = jax_gpt_tiny(**kw)
    params = flax_init(jm, jax.random.PRNGKey(5),
                       jnp.zeros((1, 8), jnp.int32))["params"]
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  params)
    pm = gpt_tiny(device="cpu", dtype=torch.bfloat16,
                  param_dtype=torch.bfloat16, softmax_dtype=torch.bfloat16,
                  fused_attention=True)
    pm.load_state_dict(gpt_params_from_flax(tree))
    assert pm.word_embeddings.weight.dtype == torch.bfloat16
    assert pm.layers[0].output.weight.dtype == torch.bfloat16
    assert pm.final_ln.scale.dtype == pm.lm_bias.dtype == torch.float32
    assert not pm.layers[0].attention.uses_kernel(4096)  # half softmax
    ids = np.random.RandomState(6).randint(0, 256, size=(2, 16))
    want = jax.jit(jm.apply)({"params": params},
                             jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        got = pm(torch.from_numpy(ids))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("arch", ["gpt", "bert"])
def test_convert_loads_a_tree_widened_to_2048(arch):
    """train.py widens ``max_position`` to ``--seq-len`` (2048 for the
    long-context run): the converters load such a flax tree, every name
    and shape (strict), the position table row for row."""
    from apex_example_tpu.models.bert import bert_tiny as jax_bert_tiny
    from apex_example_tpu_torch.convert import bert_params_from_flax
    from apex_example_tpu_torch.models.bert import bert_tiny
    jax_cls, port_cls, convert = {
        "gpt": (jax_gpt_tiny, gpt_tiny, gpt_params_from_flax),
        "bert": (jax_bert_tiny, bert_tiny, bert_params_from_flax)}[arch]
    shapes = jax.eval_shape(jax_cls(max_position=2048).init,
                            jax.random.PRNGKey(7),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    rs = np.random.RandomState(7)          # any values: the map is checked
    tree = jax.tree_util.tree_map(
        lambda a: rs.randn(*a.shape).astype(np.float32), shapes)
    pm = port_cls(device="cpu", max_position=2048)
    pm.load_state_dict(convert(tree))
    table = pm.position_embeddings.weight.detach().numpy()
    assert table.shape == (2048, 64)
    np.testing.assert_array_equal(
        table, tree["position_embeddings"]["embedding"])
