"""The port's LM eval steps held against the JAX package's, on the CPU:
bert_tiny, gpt_tiny and transformer_xl_tiny, each with weights converted
from one flax init (convert.py), through workloads.make_bert_eval_step /
make_gpt_eval_step / make_txl_eval_step on both sides, on the same numpy
batches (the JAX ``mlm_batch`` / ``lm_batch``, eval indices).

- The JAX side runs its LayerNorm through its XLA reference form
  (``ops._config.force_xla``), which its Pallas kernel is tested against.
- At amp O0 (fp32 on both sides, sums in another order): each batch's loss
  rtol 1e-4; BERT's masked accuracy equal but for positions whose two
  largest logits lie within 1e-4 (an argmax tie may fall either way);
  Transformer-XL over two batches with its memory carried, each loss and
  the final perplexity exp(mean loss) rtol 1e-4.
- At O2 (bf16 over fp32 masters; the two frameworks round the bf16
  activations at other places) each loss rtol 2e-2, as the O2 trails.
- The eval steps touch no grad: the loss carries no graph and no
  parameter gains a ``.grad``.
- ``--eval`` through ``train.main`` for each LM arch prints the epoch's
  EVAL line (``masked_acc`` for BERT, ``ppl`` for GPT and Transformer-XL)
  after the epoch, and its stream passes ``tools/metrics_lint.py``.
"""

import contextlib
import functools
import io
import math
import os
import re
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_example_tpu import amp as jamp
from apex_example_tpu.amp.policy import get_policy
from apex_example_tpu.data.synthetic import lm_batch as jax_lm_batch
from apex_example_tpu.data.synthetic import mlm_batch as jax_mlm_batch
from apex_example_tpu.models.bert import bert_tiny as jax_bert_tiny
from apex_example_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from apex_example_tpu.models.transformer_xl import \
    transformer_xl_tiny as jax_txl_tiny
from apex_example_tpu.ops import _config as jax_ops_config
from apex_example_tpu.workloads import make_bert_eval_step as jax_bert_eval
from apex_example_tpu.workloads import make_gpt_eval_step as jax_gpt_eval
from apex_example_tpu.workloads import make_txl_eval_step as jax_txl_eval
from apex_example_tpu_torch import amp, train
from apex_example_tpu_torch.convert import (bert_params_from_flax,
                                            gpt_params_from_flax,
                                            txl_params_from_flax)
from apex_example_tpu_torch.models.bert import bert_tiny
from apex_example_tpu_torch.models.gpt import gpt_tiny
from apex_example_tpu_torch.models.transformer_xl import transformer_xl_tiny
from apex_example_tpu_torch.workloads import (make_bert_eval_step,
                                              make_gpt_eval_step,
                                              make_txl_eval_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, V, BATCHES = 4, 16, 256, 2
TOL = {"O0": 1e-4, "O2": 2e-2}
TIE = 1e-4
ARCHS = {"bert": (jax_bert_tiny, bert_tiny, bert_params_from_flax,
                  jax_bert_eval, make_bert_eval_step),
         "gpt": (jax_gpt_tiny, gpt_tiny, gpt_params_from_flax,
                 jax_gpt_eval, make_gpt_eval_step),
         "txl": (jax_txl_tiny, transformer_xl_tiny, txl_params_from_flax,
                 jax_txl_eval, make_txl_eval_step)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batches(arch):
    """The eval batches of epoch 0, as the trainers index them."""
    out = []
    for j in range(BATCHES):
        i = jnp.asarray(10_000_000 + j, jnp.int32)
        if arch == "bert":
            out.append(tuple(np.array(a) for a in jax_mlm_batch(
                i, batch_size=B, seq_len=S, vocab_size=V,
                mask_token_id=V - 1, seed=0)))
        else:
            toks = np.array(jax_lm_batch(i, batch_size=B, seq_len=S,
                                         vocab_size=V, seed=0))
            out.append((np.ascontiguousarray(toks[:, :-1]),
                        np.ascontiguousarray(toks[:, 1:])))
    return out


def _dtypes(md):
    return dict(dtype=md.compute, param_dtype=md.param, ln_dtype=md.ln_io,
                softmax_dtype=md.softmax)


def _as_jax(batch):
    if len(batch) == 3:
        ids, labels, w = batch
        return jnp.asarray(ids), (jnp.asarray(labels), jnp.asarray(w))
    return tuple(jnp.asarray(a) for a in batch)


def _as_torch(batch):
    if len(batch) == 3:
        ids, labels, w = batch
        return torch.from_numpy(ids), (torch.from_numpy(labels),
                                       torch.from_numpy(w))
    return tuple(torch.from_numpy(a) for a in batch)


def _ties(model, ids, weights) -> int:
    """Weighted positions whose two largest logits lie within TIE."""
    with torch.no_grad():
        top2 = model(torch.from_numpy(ids)).topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= TIE
    return int((near & torch.from_numpy(weights > 0)).sum())


@functools.lru_cache(maxsize=None)
def _flax_init(arch):
    """One flax init of ``arch``'s fp32 parameters (the masters of O0 and
    O2 alike), jitted: one program in place of one per op."""
    jm = ARCHS[arch][0]()
    ids = jnp.zeros((1, S), jnp.int32)
    kw = {} if arch == "txl" else {"train": False}
    with jax_ops_config.force_xla(True):
        variables = jax.jit(lambda key: jm.init(key, ids, **kw))(
            jax.random.PRNGKey(5))
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def _jax_eval(arch, level, batches):
    """JAX's eval step at ``level`` on each batch (Transformer-XL's memory
    carried), over the XLA reference forms of its kernels:
    [(metrics, new mems or None)]."""
    jfn, _, _, jeval, _ = ARCHS[arch]
    jm = jfn(**_dtypes(jamp.module_dtypes(get_policy(level))))
    params = _flax_init(arch)
    out = []
    with jax_ops_config.force_xla(True):
        step = jax.jit(jeval(jm))
        mems = jm.init_mems(B) if arch == "txl" else None
        for batch in batches:
            if mems is None:
                out.append((step(params, _as_jax(batch)), None))
            else:
                mems, met = step(params, mems, _as_jax(batch))
                out.append((met, mems))
    return out


@pytest.mark.parametrize("level", ["O0", "O2"])
@pytest.mark.parametrize("arch", ["bert", "gpt", "txl"])
def test_eval_step_matches_jax(arch, level):
    _, pfn, convert, _, peval = ARCHS[arch]
    batches = _batches(arch)
    jout = _jax_eval(arch, level, batches)
    ppolicy, _ = amp.initialize(level)
    pm = pfn(device="cpu", **_dtypes(amp.module_dtypes(ppolicy)))
    pm.load_state_dict(convert(_flax_init(arch)))
    state = types.SimpleNamespace(model=pm)
    pstep = peval()
    tol = TOL[level]
    pmems = pm.init_mems(B) if arch == "txl" else None
    jlosses, plosses = [], []
    for batch, (jmet, jmems) in zip(batches, jout):
        if arch == "txl":
            pmems, pmet = pstep(state, pmems, _as_torch(batch))
            np.testing.assert_allclose(
                pmems.float().numpy(), np.asarray(jmems, np.float32),
                rtol=tol, atol=tol)
        else:
            pmet = pstep(state, _as_torch(batch))
        assert not pmet["loss"].requires_grad
        np.testing.assert_allclose(float(pmet["loss"]), float(jmet["loss"]),
                                   rtol=tol)
        jlosses.append(float(jmet["loss"]))
        plosses.append(float(pmet["loss"]))
        if arch == "bert":
            assert set(pmet) == {"loss", "masked_acc"}
            if level == "O0":
                w = batch[2]
                slack = 100.0 * _ties(pm, batch[0], w) / max(w.sum(), 1.0)
                assert abs(float(pmet["masked_acc"])
                           - float(jmet["masked_acc"])) <= slack + 1e-4
        else:
            assert set(pmet) == {"loss"}
    np.testing.assert_allclose(math.exp(np.mean(plosses)),
                               math.exp(np.mean(jlosses)), rtol=tol)
    assert all(p.grad is None for p in pm.parameters())


@pytest.mark.parametrize("arch,metric", [("bert_tiny", "masked_acc"),
                                         ("gpt_tiny", "ppl"),
                                         ("transformer_xl_tiny", "ppl")])
def test_lm_cli_eval_prints_its_line_and_lints(tmp_path, arch, metric):
    stream = tmp_path / "eval.jsonl"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train.main(["--device", "cpu", "--arch", arch, "--opt", "adam",
                         "--lr", "1e-3", "--batch-size", "4", "--seq-len",
                         "16", "--steps-per-epoch", "2", "--print-freq",
                         "1", "--eval", "--eval-batches", "2",
                         "--metrics-jsonl", str(stream)])
    assert rc == 0
    lines = out.getvalue().splitlines()
    evals = [ln for ln in lines if " EVAL " in ln]
    assert len(evals) == 1, lines
    m = re.fullmatch(rf"epoch 0 EVAL loss (\S+) {metric} (\S+) "
                     r"\(2 batches\)", evals[0])
    assert m, evals[0]
    loss, value = float(m.group(1)), float(m.group(2))
    assert np.isfinite(loss) and loss > 0
    if metric == "ppl":
        np.testing.assert_allclose(value, math.exp(loss), rtol=1e-3)
    else:
        assert 0.0 <= value <= 100.0
    assert lines.index(evals[0]) > max(
        i for i, ln in enumerate(lines) if ln.startswith("epoch 0 step "))
    lint = subprocess.run(
        [sys.executable, "tools/metrics_lint.py", str(stream),
         "--require-summary"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert lint.returncode == 0, lint.stdout + lint.stderr
