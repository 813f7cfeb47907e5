"""The port's flash attention (apex_example_tpu_torch/ops/attention.py) held
against the JAX package's ``flash_attention`` / ``flash_attention_with_lse``
on the CPU.

The same numpy inputs from a seed go through both.  The JAX side runs its
Pallas kernels in interpret mode (tests/conftest.py) wherever Sq and Sk
are multiples of 128, and its XLA reference branch otherwise (the ragged
case); the port's CPU route is the plain version, whose backward uses the
CUDA kernels' equations.  Tolerances as tests/test_attention.py: the
forward O and lse atol = rtol = 2e-5 in fp32 (sums in another order, and
online against one-pass softmax); the grads of q, k and v 5e-5, 1e-4
where sums run over several 128-row blocks; bf16 2e-2 (P and dS are
rounded to bf16 at the kernels' points, the outputs once more).  The
kernels' forward arithmetic in plain PyTorch (``attention_pair_tiled_plain``,
which the card checks hold a half O to) rounds P where JAX's kernel does.

The limit the card checks hold a half (bf16, fp16) result of the tensor
cores to (``half_result_check``) is tested here on the plain versions at
small sizes with one dead batch element (every key masked): the exact
sums (``attention_exact_sums``) agree with the plain backward, the exact
sums pass the limit against the plain version and it against them, each
planted fault (a skipped rounding point, dS from the rounded P, one live
row scaled by 1.05) fails it, a dead row's floor covers its own row and no
other, and S and dP summed in another order than the plain version's
fail it (a dead row, a peaked softmax) unless the pairs whose P or |dS|
is large take the plain chain, as the kernels do.

The CUDA wrappers' argument checks run on meta tensors: they raise before
anything is built, and a tensor that is not on the CPU never reaches the
plain version.  The card's route (the kernels replaced by fakes on meta
tensors) goes through ``FlashAttentionFunction``, so its output carries a
``grad_fn`` and its backward launches the dK/dV and dQ kernels.  The
kernels themselves run only on the card: tests/test_torch_cuda.py and
chip_smoke.py.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_example_tpu.ops.attention import attention_reference
from apex_example_tpu.ops.attention import flash_attention as jax_flash
from apex_example_tpu.ops.attention import \
    flash_attention_with_lse as jax_flash_lse
from apex_example_tpu_torch.ops import _build
from apex_example_tpu_torch.ops import attention as att

FWD_TOL = 2e-5
GRAD_TOL = 5e-5
BF16_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(b=2, sq=256, sk=256, h=2, d=64, seed=0, bias=False):
    """q, k, v (float32 numpy) and a (B, Sk) key bias masking a random
    suffix of each row's keys (row 0 keeps them all) at -1e9, or None."""
    rs = np.random.RandomState(seed)
    q = rs.randn(b, sq, h, d).astype(np.float32)
    k = rs.randn(b, sk, h, d).astype(np.float32)
    v = rs.randn(b, sk, h, d).astype(np.float32)
    mask = None
    if bias:
        keep = rs.randint(sk // 2, sk + 1, size=b)
        keep[0] = sk
        mask = np.where(np.arange(sk)[None, :] < keep[:, None], 0.0,
                        -1e9).astype(np.float32)
    return q, k, v, mask


def _jax(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


def _torch(a, dtype=torch.float32, grad=False):
    if a is None:
        return None
    return torch.from_numpy(a).to(dtype).requires_grad_(grad)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(
        np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                   np.float32),
        np.asarray(want, np.float32), atol=tol, rtol=tol, err_msg=what)


def _grads_both(q, k, v, bias, causal, do, dlse=None, dtype=np.float32):
    """(dq, dk, dv) of JAX's op and of the port's, for the cotangents do
    (and dlse: then through the with-lse forms)."""
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    if dlse is None:
        f = lambda q, k, v: jax_flash(q, k, v, _jax(bias), causal=causal)
        cts = _jax(do, jd)
    else:
        f = lambda q, k, v: jax_flash_lse(q, k, v, _jax(bias),
                                          causal=causal)
        cts = (_jax(do, jd), _jax(dlse))
    _, vjp = jax.vjp(f, _jax(q, jd), _jax(k, jd), _jax(v, jd))
    want = vjp(cts)
    tq, tk, tv = (_torch(a, td, grad=True) for a in (q, k, v))
    if dlse is None:
        o = att.flash_attention(tq, tk, tv, _torch(bias), causal)
        torch.autograd.backward(o, _torch(do, td))
    else:
        o, lse = att.flash_attention_with_lse(tq, tk, tv, _torch(bias),
                                              causal)
        torch.autograd.backward((o, lse), (_torch(do, td), _torch(dlse)))
    return want, (tq.grad, tk.grad, tv.grad)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_forward_and_lse_match_jax(causal, bias):
    q, k, v, b = _inputs(seed=1, bias=bias)
    want_o, want_lse = jax_flash_lse(_jax(q), _jax(k), _jax(v), _jax(b),
                                     causal=causal)
    got_o, got_lse = att.flash_attention_with_lse(
        _torch(q), _torch(k), _torch(v), _torch(b), causal)
    assert got_o.dtype == torch.float32 and got_o.shape == q.shape
    assert got_lse.dtype == torch.float32 and got_lse.shape == (2, 2, 256)
    _close(got_o, want_o, FWD_TOL, "o")
    _close(got_lse, want_lse, FWD_TOL, "lse")
    _close(att.flash_attention(_torch(q), _torch(k), _torch(v), _torch(b),
                               causal),
           jax_flash(_jax(q), _jax(k), _jax(v), _jax(b), causal=causal),
           FWD_TOL, "flash_attention")
    _close(att.attention_plain(_torch(q), _torch(k), _torch(v), _torch(b),
                               causal),
           attention_reference(_jax(q), _jax(k), _jax(v), _jax(b),
                               causal=causal), FWD_TOL, "attention_plain")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_grads_match_jax(causal, bias):
    q, k, v, b = _inputs(sq=128, sk=128, seed=2, bias=bias)
    do = np.random.RandomState(3).randn(*q.shape).astype(np.float32)
    want, got = _grads_both(q, k, v, b, causal, do)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, GRAD_TOL, f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_matches_jax(causal):
    q, k, v, _ = _inputs(sq=128, sk=128, seed=4)
    do = np.random.RandomState(5).randn(*q.shape).astype(np.float32)
    want_o = jax_flash(_jax(q, jnp.bfloat16), _jax(k, jnp.bfloat16),
                       _jax(v, jnp.bfloat16), causal=causal)
    got_o = att.flash_attention(_torch(q, torch.bfloat16),
                                _torch(k, torch.bfloat16),
                                _torch(v, torch.bfloat16), None, causal)
    assert got_o.dtype == torch.bfloat16
    _close(got_o, want_o.astype(jnp.float32), BF16_TOL, "o")
    want, got = _grads_both(q, k, v, None, causal, do, dtype="bf16")
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16
        _close(g, w.astype(jnp.float32), BF16_TOL, f"d{name}")


@pytest.mark.parametrize("causal,bias", [(True, False), (False, True)])
def test_tiled_plain_rounds_where_jax_kernel_rounds(causal, bias):
    """bf16 O of the kernels' arithmetic in plain PyTorch (128-key tiles,
    JAX's block at S = 384) against JAX's Pallas kernel: at most 1e-2 of
    its elements an ulp off (sums in another order), where the
    reference's arithmetic, which rounds the normalised P, moves ~half."""
    q, k, v, mask = _inputs(sq=384, sk=384, seed=7, bias=bias)
    want_o, want_lse = jax_flash_lse(
        *(_jax(a, jnp.bfloat16) for a in (q, k, v)), _jax(mask),
        causal=causal)
    want_o = torch.from_numpy(np.array(want_o.astype(jnp.float32)))
    tq, tk, tv = (_torch(a, torch.bfloat16) for a in (q, k, v))
    o, lse = att.attention_pair_tiled_plain(tq, tk, tv, _torch(mask),
                                            causal, tile=128)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(), want_o.numpy(),
                               rtol=1e-2, atol=1e-3)
    _close(lse, want_lse, FWD_TOL, "lse")
    assert float((o.float() != want_o).float().mean()) <= 1e-2
    ref = att.attention_pair_plain(tq, tk, tv, _torch(mask), causal)[0]
    assert float((ref.float() != want_o).float().mean()) > 0.2


@pytest.mark.parametrize("sq,sk", [(384, 384), (128, 384)])
def test_multiblock_and_rectangular_bottom_right_causal(sq, sk):
    """Several 128-row blocks on the JAX side; Sq < Sk puts the queries
    at the end (query i sees keys 0 .. i + Sk - Sq)."""
    q, k, v, _ = _inputs(b=1, sq=sq, sk=sk, seed=6)
    want_o = jax_flash(_jax(q), _jax(k), _jax(v), causal=True)
    got_o = att.flash_attention(_torch(q), _torch(k), _torch(v), None, True)
    _close(got_o, want_o, FWD_TOL, "o")
    do = np.random.RandomState(7).randn(*q.shape).astype(np.float32)
    want, got = _grads_both(q, k, v, None, True, do)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, 1e-4, f"d{name}")
    if sq < sk:      # the last query sees every key, the first Sk - Sq + 1
        free = q.copy()
        kk = k.copy()
        kk[:, sk - sq + 1:] += 1.0
        a = att.flash_attention(_torch(free), _torch(kk), _torch(v), None,
                                True)
        torch.testing.assert_close(a[:, 0], got_o[:, 0].detach())
        assert not torch.allclose(a[:, -1], got_o[:, -1].detach())


@pytest.mark.parametrize("causal", [False, True])
def test_ragged_length_matches_jax_reference_branch(causal):
    """S = 100 is no multiple of 128: JAX takes its XLA reference branch
    (``_kernel_ok``); the card's kernels take it with masked tail tiles."""
    q, k, v, b = _inputs(sq=100, sk=100, d=16, seed=8, bias=not causal)
    want_o, want_lse = jax_flash_lse(_jax(q), _jax(k), _jax(v), _jax(b),
                                     causal=causal)
    got_o, got_lse = att.flash_attention_with_lse(
        _torch(q), _torch(k), _torch(v), _torch(b), causal)
    _close(got_o, want_o, FWD_TOL, "o")
    _close(got_lse, want_lse, FWD_TOL, "lse")
    do = np.random.RandomState(9).randn(*q.shape).astype(np.float32)
    want, got = _grads_both(q, k, v, b, causal, do)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, GRAD_TOL, f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_lse_cotangent_folds_into_delta(causal):
    """A non-zero dlse (the ring combine differentiates through lse):
    Delta := rowsum(dO * O) - dlse in both."""
    q, k, v, _ = _inputs(b=1, sq=128, sk=128, seed=10)
    rs = np.random.RandomState(11)
    do = rs.randn(*q.shape).astype(np.float32)
    dlse = rs.randn(1, 2, 128).astype(np.float32)
    want, got = _grads_both(q, k, v, None, causal, do, dlse)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, GRAD_TOL, f"d{name}")
    # and it matters: without it the grads differ
    _, plain = _grads_both(q, k, v, None, causal, do)
    assert not np.allclose(plain[0].numpy(), got[0].numpy(), atol=1e-3)


def test_bias_gets_no_gradient():
    q, k, v, b = _inputs(b=2, sq=128, sk=128, seed=12, bias=True)
    jg = jax.grad(lambda bb: jnp.sum(jax_flash(
        _jax(q), _jax(k), _jax(v), bb) ** 2))(_jax(b))
    assert not np.any(np.asarray(jg))
    tb = _torch(b, grad=True)
    tq = _torch(q, grad=True)
    (att.flash_attention(tq, _torch(k), _torch(v), tb) ** 2).sum().backward()
    assert tb.grad is None and tq.grad is not None


def test_fully_masked_row_matches_jax():
    """Every key of row 1 at -1e9: a uniform average of the values, as in
    JAX (its softmax over equal logits)."""
    q, k, v, _ = _inputs(b=2, sq=128, sk=128, seed=13)
    b = np.zeros((2, 128), np.float32)
    b[1] = -1e9
    want = jax_flash(_jax(q), _jax(k), _jax(v), _jax(b))
    got = att.flash_attention(_torch(q), _torch(k), _torch(v), _torch(b))
    _close(got, want, FWD_TOL, "o")
    np.testing.assert_allclose(got[1].numpy(),
                               np.broadcast_to(v[1].mean(0), got[1].shape),
                               atol=1e-5)


def test_causal_with_more_queries_than_keys_is_refused():
    q, k, v, _ = _inputs(sq=256, sk=128, seed=14)
    with pytest.raises(ValueError, match="Sq <= Sk"):
        jax_flash(_jax(q), _jax(k), _jax(v), causal=True)
    with pytest.raises(ValueError, match="Sq <= Sk"):
        att.flash_attention(_torch(q), _torch(k), _torch(v), causal=True)


def test_plain_backward_is_the_gradient_of_the_plain_pair():
    """The kernels' equations, in fp64, equal autograd through
    ``attention_pair_plain`` with both cotangents (bias and a causal
    rectangle included)."""
    q, k, v, b = _inputs(b=2, sq=24, sk=40, d=8, seed=15, bias=True)
    t = [torch.from_numpy(a).double().requires_grad_() for a in (q, k, v)]
    rs = np.random.RandomState(16)
    do = torch.from_numpy(rs.randn(*q.shape))
    dlse = torch.from_numpy(rs.randn(2, 2, 24))
    bias = torch.from_numpy(b).double()
    o, lse = att.attention_pair_plain(*t, bias, True)
    want = torch.autograd.grad((o * do).sum() + (lse * dlse).sum(), t)
    got = att.attention_bwd_plain(*(x.detach() for x in t), bias, True,
                                  8 ** -0.5, o.detach(), lse.detach(), do,
                                  dlse)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


LIMIT_CASES = {   # B 2, H 2; (Sq, Sk, D, causal)
    "causal": (130, 130, 24, True), "rectangular": (96, 130, 16, False)}
HALF = {"bf16": torch.bfloat16, "fp16": torch.float16}
GRADS = ("dq", "dk", "dv")


@pytest.fixture(scope="module")
def limit_case(request):
    """The plain results at a small shape whose key bias masks the last
    quarter of batch element 0's keys and every key of element 1 (dead),
    with the exact sums of both elements and of the dead slice alone."""
    dtype, (sq, sk, d, causal) = HALF[request.param[0]], \
        LIMIT_CASES[request.param[1]]
    rs = np.random.RandomState(7)
    q, k, v, do = (torch.from_numpy(rs.randn(2, s, 2, d).astype(np.float32))
                   .to(dtype) for s in (sq, sk, sk, sq))
    bias = np.zeros((2, sk), np.float32)
    bias[0, 3 * sk // 4:] = -1e9
    bias[1] = -1e9
    bias = torch.from_numpy(bias)
    scale = d ** -0.5
    o, lse = att.attention_pair_plain(q, k, v, bias, causal, scale)
    dl = att.delta(o, do)
    dead = att.dead_batch(bias)
    return dict(
        q=q, k=k, v=v, do=do, bias=bias, causal=causal, scale=scale, o=o,
        lse=lse, dl=dl, dead=dead, key=3 * sk // 4 - 1,
        plain=dict(zip(GRADS, att.attention_bwd_plain(
            q, k, v, bias, causal, scale, o, lse, do))),
        exact=dict(zip(GRADS, att.attention_exact_sums(
            q, k, v, bias, causal, scale, do, dl, lse))),
        exact_dead=dict(zip(GRADS, att.attention_exact_sums(
            *(t[dead] for t in (q, k, v, bias)), causal, scale, do[dead],
            dl[dead], lse[dead]))))


def _ids(params):
    return [f"{a}-{b}" for a, b in params]


LIMIT_PARAMS = [(dt, case) for dt in HALF for case in LIMIT_CASES]


@pytest.mark.parametrize("limit_case", LIMIT_PARAMS, indirect=True,
                         ids=_ids(LIMIT_PARAMS))
def test_exact_sums_agree_with_the_plain_backward_off_dead_rows(limit_case):
    """dQ, dK and dV summed in fp64 are within part 1 of the limit (two
    ulps) of the plain backward in the live batch element, and computed on
    the dead slice alone they are those of the whole batch."""
    c = limit_case
    live = ~c["dead"]
    for name in GRADS:
        got, want = c["exact"][name], c["plain"][name]
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(
            got[live].float().numpy(), want[live].float().numpy(),
            rtol=att.ATTN_HALF_O_RTOL, atol=att.ATTN_HALF_O_ATOL,
            err_msg=name)
        assert torch.equal(c["exact_dead"][name], got[c["dead"]]), name


@pytest.mark.parametrize("limit_case", LIMIT_PARAMS, indirect=True,
                         ids=_ids(LIMIT_PARAMS))
def test_plain_and_exact_sums_pass_the_half_limit(limit_case):
    """Correctly rounded sums pass as a kernel's result against the plain
    version (the dead rows under their floor), and the plain version
    passes against them where no floor applies."""
    c = limit_case
    live = ~c["dead"]
    for name in GRADS:
        r = att.half_result_check(name, c["exact"][name], c["plain"][name],
                                  c["dead"], c["exact_dead"][name])
        assert r.ok, (name, r)
        r = att.half_result_check(name, c["plain"][name][live],
                                  c["exact"][name][live])
        assert r.ok and r.floor == 0.0, (name, r)


def _planted(c, fault):
    """(name, a plain result with one fault planted): a rounding point
    skipped, dS from the rounded P, or one live row scaled by 1.05."""
    dt = c["q"].dtype
    qf, kf, vf, dof = (c[n].float() for n in ("q", "k", "v", "do"))
    if fault == "p_unrounded_o":
        return "o", att.attention_pair_tiled_plain(
            qf, kf, vf, c["bias"], c["causal"], c["scale"])[0].to(dt)
    p = torch.exp(att.scores_plain(c["q"], c["k"], c["bias"], c["causal"],
                                   c["scale"]) - c["lse"][..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf) - c["dl"][..., None]
    name = fault[-2:]
    if fault == "p_unrounded_dv":
        return name, torch.einsum("bhqk,bqhd->bkhd", p, dof).to(dt)
    ds = p * dp * c["scale"]
    if fault.startswith("ds_from_rounded_p"):
        ds = (p.to(dt).float() * dp * c["scale"]).to(dt).float()
    if fault.startswith("ds"):
        eq, other = (("bhqk,bqhd->bkhd", qf) if name == "dk"
                     else ("bhqk,bkhd->bqhd", kf))
        return name, torch.einsum(eq, ds, other).to(dt)
    bad = c["plain"][name].clone()   # live_row_*: element 0, head 0
    bad[0, c["key"] if name != "dq" else -1, 0] *= 1.05
    return name, bad


FAULTS = ["p_unrounded_o", "p_unrounded_dv", "ds_unrounded_dk",
          "ds_unrounded_dq", "ds_from_rounded_p_dk", "ds_from_rounded_p_dq",
          "live_row_dq", "live_row_dk", "live_row_dv"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("limit_case", LIMIT_PARAMS, indirect=True,
                         ids=_ids(LIMIT_PARAMS))
def test_half_limit_catches_planted_faults(limit_case, fault):
    c = limit_case
    name, bad = _planted(c, fault)
    if name == "o":
        ref = att.attention_pair_tiled_plain(
            c["q"], c["k"], c["v"], c["bias"], c["causal"], c["scale"])[0]
        r = att.half_result_check("o", bad, ref)
    else:
        r = att.half_result_check(name, bad, c["plain"][name], c["dead"],
                                  c["exact_dead"][name])
    assert not r.ok, (fault, r)


@pytest.mark.parametrize("limit_case", [("bf16", "rectangular"),
                                        ("fp16", "causal")], indirect=True,
                         ids=["bf16-rectangular", "fp16-causal"])
def test_dead_row_floor_covers_its_own_row_only(limit_case):
    """A dead row whose plain result is 0.5 from its exact sum may be off
    by up to 3 x 0.5; a dead row beside it, and a live row, may not."""
    c = limit_case
    ref = c["plain"]["dk"]
    exact = ref[c["dead"]].clone()
    exact[0, 5, 1] += 0.5               # dead key 5, head 1: floor 1.5
    floor = 3 * float((ref[c["dead"]][0, 5, 1].double()
                       - exact[0, 5, 1].double()).abs().max())
    got = ref.clone()
    got[1, 5, 1] += 1.0
    r = att.half_result_check("dk", got, ref, c["dead"], exact)
    assert r.ok and r.floor == floor, r
    other = got.clone()
    other[1, 6, 1] += 1.0               # the next dead key: no floor
    assert not att.half_result_check("dk", other, ref, c["dead"],
                                     exact).ok
    live = got.clone()
    live[0, c["key"], 0] *= 1.05        # a live key of element 0
    assert not att.half_result_check("dk", live, ref, c["dead"], exact).ok
    with pytest.raises(ValueError, match="no dead-row floor"):
        att.half_result_check("o", got, ref, c["dead"], exact)


# csrc/attention.cu's flip_limit (the P or |dS| from which one ulp of the
# dtype is at least 2^-13) and kTieUlps (how near a rounding tie of the
# dtype an fp32 P or dS must lie to be taken again in the plain chain)
FLIP_LIMIT = {torch.bfloat16: 1 / 64, torch.float16: 1 / 8}
TIE_ULPS = 2048


def test_flip_limits_are_the_kernel_source():
    src = (pathlib.Path(att.__file__).parent.parent / "csrc"
           / "attention.cu").read_text()
    assert ("return std::is_same<T, __half>::value ? 0.125f : 1.f / 64;"
            in src)
    assert f"constexpr int kTieUlps = {TIE_ULPS};" in src
    for dtype, limit in FLIP_LIMIT.items():
        ulp = torch.finfo(dtype).eps * limit     # of a value in [limit, 2x)
        assert ulp == 2.0 ** -13


def _retaken(p, ds, dtype):
    """The pairs the kernels take again in the plain chain: P or |dS| at
    least FLIP_LIMIT and within TIE_ULPS fp32 ulps of a rounding tie of
    the dtype."""
    drop = 16 if dtype == torch.bfloat16 else 13
    limit = FLIP_LIMIT[dtype]

    def near_tie(x):
        low = x.contiguous().view(torch.int32) & ((1 << drop) - 1)
        return (low - (1 << (drop - 1))).abs() < TIE_ULPS

    return (((p >= limit) & near_tie(p))
            | ((ds.abs() >= limit) & near_tie(ds)))


@pytest.mark.parametrize("case", ["dead", "peaked"])
@pytest.mark.parametrize("dtype", list(HALF.values()), ids=list(HALF))
def test_large_pairs_need_the_plain_chain(dtype, case):
    """Why the backward kernels take S and dP of the pairs with P or |dS| at
    least FLIP_LIMIT and near a rounding tie again with the plain version's
    fp32 chain: a rounding of P or dS that flips there moves a row of dV,
    dK or dQ by an ulp of P or dS times an operand, past the limit's atol
    where the row cancels near zero.  At bert_base's head shape, with a
    batch element whose keys are all masked (P = 1) or a peaked softmax (q
    x 4), S and dP summed in another order (the head dim's two halves
    apart, as a kernel's k16 steps split it) fail the limit; the same with
    those pairs' P and dS from the plain order passes, as the kernels
    compute them (the halves' sums differ from the chain's by fp32
    reordering, as the tensor cores' do)."""
    b, s, h, d = 2, 512, 12, 64
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen) for _ in range(4))
    bias = None
    if case == "peaked":
        q = q * 4
    else:
        bias = torch.zeros(b, s)
        bias[0, 3 * s // 4:] = -1e9
        bias[1] = -1e9
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    scale = d ** -0.5
    o, lse = att.attention_pair_plain(q, k, v, bias, False, scale)
    dl = att.delta(o, do)
    plain = att.attention_bwd_plain(q, k, v, bias, False, scale, o, lse, do)
    dead = att.dead_batch(bias)
    exact = (att.attention_exact_sums(*(t[dead] for t in (q, k, v, bias)),
                                      False, scale, do[dead], dl[dead],
                                      lse[dead]) if bias is not None
             else (None,) * 3)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))

    def p_ds(s_dots, dp_dots):    # P and dS from (B, H, Sq, Sk) dots
        p = torch.exp(att._scores(s_dots, q, k, bias, False, scale)
                      - lse[..., None])
        return p, p * (dp_dots - dl[..., None]) * scale

    def halves(x, y):
        return sum(torch.einsum("bqhd,bkhd->bhqk", x[..., i:i + d // 2],
                                y[..., i:i + d // 2]) for i in (d // 2, 0))

    chain = p_ds(torch.einsum("bqhd,bkhd->bhqk", qf, kf),
                 torch.einsum("bqhd,bkhd->bhqk", dof, vf))
    other = p_ds(halves(qf, kf), halves(dof, vf))
    large = _retaken(other[0], other[1], dtype)
    mixed = tuple(torch.where(large, c, o_) for c, o_ in zip(chain, other))
    for (p, ds), ok in ((other, False), (mixed, True)):
        ds = ds.to(dtype).float()
        grads = {"dq": torch.einsum("bhqk,bkhd->bqhd", ds, kf),
                 "dk": torch.einsum("bhqk,bqhd->bkhd", ds, qf),
                 "dv": torch.einsum("bhqk,bqhd->bkhd", p.to(dtype).float(),
                                    dof)}
        got = [att.half_result_check(n, grads[n].to(dtype), plain[i], dead,
                                     exact[i]).ok
               for i, n in enumerate(GRADS)]
        assert all(got) if ok else not all(got), (case, ok, got)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


QKV = (_meta(2, 64, 4, 64), _meta(2, 64, 4, 64), _meta(2, 64, 4, 64))


def test_wrapper_limits_are_the_kernel_sources():
    """MAX_D and TILE, which the wrappers check before a build, are the
    kMaxD and kTile that csrc/attention.cu compiles with; and the
    tensor-core forward's key tile kTcKeys is TILE too, the tile to whose
    rounding ``attention_pair_tiled_plain`` holds a half O."""
    src = pathlib.Path(att.__file__).parent.parent / "csrc" / "attention.cu"
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);",
                             src.read_text()))
    assert int(consts["kMaxD"]) == att.MAX_D
    assert int(consts["kTile"]) == att.TILE
    assert int(consts["kTcKeys"]) == att.TILE


@pytest.mark.parametrize("dp", [64, att.MAX_D])
def test_fp32_backward_tiles_fit_the_card(dp):
    """The fp32 dQ and dK/dV kernels' tiles (csrc/attention.cu kF32Rows*:
    rows a block owns, kF32Cols*: rows of a streamed tile, at a head dim
    padded to 64 and to kMaxD): their shared memory, ``F32Tiles::kSmem``
    floats, fits the 232,448 bytes an H100 block may take, and their grid
    keeps the wrappers' 65535 * TILE sequence limit (a block owns at least
    TILE rows, so the longest sequence takes at most 65535 blocks, the
    grid's y limit)."""
    src = pathlib.Path(att.__file__).parent.parent / "csrc" / "attention.cu"
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src.read_text())}
    rows, cols = consts[f"kF32Rows{dp}"], consts[f"kF32Cols{dp}"]
    # kSmem: K^T and V^T (or Q^T and dO^T), two ring stages of two
    # row-major tiles (row stride dp + 4) and two floats a streamed row, P
    # and dS ([col][row], row stride rows + 4), two floats a block row
    stage = 2 * cols * (dp + 4) + 2 * cols
    floats = 2 * dp * rows + 2 * stage + 2 * cols * (rows + 4) + 2 * rows
    assert 4 * floats <= 232_448
    assert rows >= att.TILE
    assert -(-65535 * att.TILE // rows) <= 65535
    # a thread's 8 x 8 accumulator tile covers the padded head dim, and a
    # tile's rows split evenly over the 128 threads of a group
    groups = 128 // (rows // 8)
    assert groups * 8 == dp and cols % groups == 0


@pytest.mark.parametrize("dp", [64, att.MAX_D])
def test_fp32_forward_tiles_fit_the_card(dp):
    """The fp32 forward's tiles (csrc/attention.cu: the backward's
    kF32Rows* queries a block against kF32Cols* keys a k/v tile, at a head
    dim padded to 64 and to kMaxD): its shared memory,
    ``F32Tiles::kFwdSmem`` floats, fits the 232,448 bytes an H100 block may
    take, and its grid keeps the wrappers' 65535 * TILE sequence limit."""
    src = pathlib.Path(att.__file__).parent.parent / "csrc" / "attention.cu"
    text = src.read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}
    rows, cols = consts[f"kF32Rows{dp}"], consts[f"kF32Cols{dp}"]
    # kFwdSmem: Q^T, two ring stages of K and V (row stride dp + 4) and two
    # floats a key, P twice ([key][query], row stride rows + 4), each
    # query's alpha twice and its l
    stage = 2 * cols * (dp + 4) + 2 * cols
    floats = dp * rows + 2 * stage + 2 * cols * (rows + 4) + 3 * rows
    assert "DP * kRows + 2 * kStage + 2 * kCols * kLdP + 3 * kRows" in text
    assert 4 * floats <= 232_448
    assert floats % 4 == 0          # zeroed as float4
    assert -(-65535 * att.TILE // rows) <= 65535
    # a row group's lanes lie in one warp (the softmax's shuffles), and a
    # thread's 8 x 8 O tile covers the padded head dim
    groups = 128 // (rows // 8)
    assert groups * 8 == dp and 32 % groups == 0 and cols % groups == 0


@pytest.mark.parametrize("args,kw,err,match", [
    ((_meta(2, 64, 4, 64, dtype=torch.float64),) * 3, {}, TypeError,
     "float32"),
    ((_meta(2, 64, 256), _meta(2, 64, 256), _meta(2, 64, 256)), {},
     ValueError, "B, S, H, D"),
    ((QKV[0], _meta(2, 64, 4, 32), QKV[2]), {}, ValueError, "k and v"),
    ((QKV[0], QKV[1], _meta(2, 64, 4, 64, dtype=torch.bfloat16)), {},
     ValueError, "k and v"),
    ((_meta(2, 64, 4, 60),) * 3, {}, ValueError, "multiple of 8"),
    ((_meta(2, 64, 4, 256),) * 3, {}, ValueError, "multiple of 8"),
    ((_meta(2, 128, 4, 64), QKV[1], QKV[2]), {"causal": True}, ValueError,
     "Sq <= Sk"),
    (QKV, {"bias": _meta(2, 32)}, ValueError, "bias must be"),
    (QKV, {"bias": _meta(2, 64, dtype=torch.bfloat16)}, ValueError,
     "bias must be"),
    (QKV, {}, ValueError, "CUDA"),                  # meta: not CUDA
])
def test_cuda_wrapper_raises_on_what_it_cannot_take(monkeypatch, args, kw,
                                                    err, match):
    def no_build(name):
        raise AssertionError(f"argument checks must raise before {name} "
                             "is built")
    monkeypatch.setattr(_build, "load", no_build)
    before = att.flash_attention_cuda.launches
    with pytest.raises(err, match=match):
        att.flash_attention_cuda(*args, **kw)
    assert att.flash_attention_cuda.launches == before


@pytest.mark.parametrize("wrapper", ["flash_attention_cuda",
                                     "flash_attention_dkdv_cuda",
                                     "flash_attention_dq_cuda"])
def test_wrappers_take_any_strides_up_to_the_device_check(monkeypatch,
                                                          wrapper):
    """bf16 q, k, v and dO whose head dim is not contiguous (every second
    element of a wider tensor), as the kernels took them before the
    tensor-core forward: each wrapper passes every argument check and
    raises only at the last, the device check."""
    monkeypatch.setattr(_build, "load", lambda name: None)
    q, k, v, do = (_meta(2, 64, 4, 128, dtype=torch.bfloat16)[..., ::2]
                   for _ in range(4))
    assert q.stride(-1) == 2 and not q.is_contiguous()
    rows = _meta(2, 4, 64)
    fn = getattr(att, wrapper)
    args = (q, k, v, None, True, 0.125) + (
        () if wrapper == "flash_attention_cuda" else (do, rows, rows))
    before = fn.launches
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        fn(*args)
    assert fn.launches == before


def test_backward_wrappers_check_their_row_tensors(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: None)
    q, k, v = QKV
    good = _meta(2, 4, 64)
    for fn in (att.flash_attention_dkdv_cuda, att.flash_attention_dq_cuda):
        with pytest.raises(ValueError, match="do must match"):
            fn(q, k, v, None, False, 0.125, _meta(2, 64, 4, 32), good, good)
        with pytest.raises(ValueError, match="lse must be"):
            fn(q, k, v, None, False, 0.125, q, _meta(2, 64, 4), good)
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, k, v, None, False, 0.125, q, good, good)


def test_dispatch_raises_instead_of_falling_back(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel's wrapper, which
    raises: the plain version is never a quiet stand-in."""
    def no_plain(*a, **k):
        raise AssertionError("plain version ran for a non-CPU tensor")
    monkeypatch.setattr(att, "attention_pair_plain", no_plain)
    monkeypatch.setattr(att, "attention_bwd_plain", no_plain)
    with pytest.raises(ValueError, match="CUDA"):
        att.flash_attention(*QKV)


def _fake_kernels(monkeypatch, calls):
    """The three wrappers replaced by shape-true stand-ins on meta
    tensors, recording what they were given."""
    def fwd(q, k, v, bias, causal, scale):
        calls.append(("fwd", torch.is_grad_enabled(), causal))
        b, sq, h, _ = q.shape
        return (torch.empty_like(q), torch.empty(b, h, sq, device=q.device))

    def dkdv(q, k, v, bias, causal, scale, do, lse, dl):
        calls.append(("dkdv", tuple(dl.shape)))
        return torch.empty_like(k), torch.empty_like(v)

    def dq(q, k, v, bias, causal, scale, do, lse, dl):
        calls.append(("dq", tuple(do.shape)))
        return torch.empty_like(q)

    monkeypatch.setattr(att, "flash_attention_cuda", fwd)
    monkeypatch.setattr(att, "flash_attention_dkdv_cuda", dkdv)
    monkeypatch.setattr(att, "flash_attention_dq_cuda", dq)


def test_card_route_output_carries_the_gradient(monkeypatch):
    """A bare ctypes launch leaves no grad_fn (the LayerNorm fault of the
    first slice): through FlashAttentionFunction the card's output carries
    one, and its backward runs the dK/dV and the dQ kernels once each."""
    calls = []
    _fake_kernels(monkeypatch, calls)
    q, k, v = (_meta(2, 64, 4, 64).requires_grad_() for _ in range(3))
    o = att.flash_attention(q, k, v, causal=True)
    assert o.requires_grad and o.grad_fn is not None
    assert o.shape == q.shape
    o.sum().backward()
    assert calls == [("fwd", False, True), ("dkdv", (2, 4, 64)),
                     ("dq", (2, 64, 4, 64))]
    for t in (q, k, v):
        assert t.grad is not None and t.grad.shape == t.shape


def test_no_grad_route_launches_no_backward(monkeypatch):
    calls = []
    _fake_kernels(monkeypatch, calls)
    with torch.no_grad():
        o = att.flash_attention(*QKV)
    assert not o.requires_grad
    assert calls == [("fwd", False, False)]
