"""The port's training slices held against the JAX package's, on the CPU:
bert_tiny MLM with FusedLAMB, gpt_tiny with FusedAdam (at amp O0 and O2,
on the einsum and the flash-attention routes) and transformer_xl_tiny with
the global-norm clip, FusedAdam and its memory carried from step to step,
at amp O0; ResNet-18 with FusedSGD at O0, O2 and
under dynamic loss scaling, and its eval step.

- 5-step loss trails: identical initial weights (the flax init, converted)
  and identical batches (the JAX ``mlm_batch`` / ``lm_batch``, as numpy)
  through the JAX ``make_train_step`` / ``make_txl_train_step`` (the XLA
  reference forms of their LayerNorm, L2-norm, scale, LAMB and Adam
  kernels, ``ops._config.force_xla``, which compile in a third of the
  interpreter's time; tests/test_torch_optim.py and the like hold the
  kernels themselves; Transformer-XL's Adam on its Pallas kernel) and
  through the port's steps.  Losses
  and grad norms rtol 1e-4, parameters after 5 steps rtol and atol 1e-4:
  fp32 on both sides, sums in another order, compounding over five steps.
- The CLI: ``python -m apex_example_tpu_torch.train --device cpu`` exits 0
  for bert_tiny, and ``train.main`` (what that command runs) returns 0
  in this process for gpt_tiny and transformer_xl_tiny; each
  ``--metrics-jsonl`` stream passes ``tools/metrics_lint.py
  --require-summary`` (the Transformer-XL stream carries ``ppl``); without
  ``--device`` it raises where torch sees no CUDA; the flags of paths not
  ported (``--pipeline-parallel``, ``--cost-model``,
  ``--context-parallel``, ``--tensor-parallel``, and beside ``--loss-scale``,
  which the LM archs take, ``--moe-experts``) and bad values of ported
  flags (``--numerics-check warn``, ``--preempt-grace 30``) are rejected
  by argparse.
  The reference's launcher flags (``--local_rank`` and ``--local-rank``,
  ``--workers``, ``--deterministic``, ``--num-devices 1``,
  ``--metrics-all-ranks``) are accepted, recorded in the run_header, and
  leave the three-step loss trail as it is; ``--num-devices 2`` in one
  process is refused.
- ResNet-18 (num_filters 4, the CIFAR stem, 16 px, batch 4) with
  FusedSGD: the same weights (numpy, in flax's tree, converted) and the
  JAX ``image_batch``'s images through the JAX ``make_train_step`` and the
  port's.  At O0 losses, grad norms and parameters as above, top-1 equal.
  At O2 (bf16 convolutions and BatchNorm I/O, fp32 statistics and master
  weights) the two frameworks round the bf16 activations at other places:
  each tensor of the port's first grads no more than twice as far from
  the fp32 grads as JAX's are, and three steps' losses rtol 2e-2.  Under
  ``--loss-scale dynamic`` with a step-decay schedule, a step whose scaled
  loss overflows (the loss times 1e38) is skipped by both: parameters,
  momentum, the learning rate the step count implies and the scale equal
  JAX's at every step.  The eval step's loss rtol 1e-4, top-1 and top-5
  equal.  The CLI trains ResNet-18 under O2 with dynamic scaling and
  ``--eval`` and its stream lints.
- gpt_tiny through the flash-attention route (``--fused-attention``):
  three steps at S = 256 against JAX's step with the model's Pallas
  kernels (interpreted; Adam on its XLA form), rtol 1e-4 as above; at amp
  O2 (bf16 over fp32 masters)
  at S = 128, held as ResNet-18's O2 (each tensor of the first grads no
  more than twice as far from fp32 as JAX's, the key biases, whose exact
  gradient is zero, aside; three steps' losses rtol 2e-2).  The CLI runs
  ``--fused-attention`` at O0 and O2 and its stream lints; it refuses
  ``--fused-attention`` at O3 and for transformer_xl and the image archs,
  and ``--numerics-check`` beside ``--fused-attention`` and O2 for
  transformer_xl (JAX's refusal and message); argparse rejects a bad
  ``--numerics-check`` mode and a value given to ``--preempt-grace``.
- ``train.main`` with ``--opt novograd`` (bert_tiny) and ``--opt
  adagrad`` (ResNet-18, num_filters 4): three steps on the CPU from the
  flax init, converted, against the JAX ``make_train_step`` with the JAX
  package's FusedNovoGrad / FusedAdagrad on the same batches (the port's
  generators, as numpy): losses and grad norms rtol 1e-4.  ``check_args``
  lets NovoGrad, Adagrad, FusedAdam and FusedLAMB through under O3 and
  ``--loss-scale dynamic`` on the image archs (their steps take the noop
  flag and one launch per dtype).
- The data generators keep the JAX generators' distributions; the image
  patterns are ``jax.image.resize``'s bilinear upsampling.
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

from torch_jax_ref import KernelScope, create_state
from apex_example_tpu import amp as jamp
from apex_example_tpu.amp.policy import get_policy
from apex_example_tpu.data.synthetic import image_batch as jax_image_batch
from apex_example_tpu.data.synthetic import lm_batch as jax_lm_batch
from apex_example_tpu.data.synthetic import mlm_batch as jax_mlm_batch
from apex_example_tpu.engine import TrainState as JaxTrainState
from apex_example_tpu.engine import cross_entropy_loss as jax_cross_entropy
from apex_example_tpu.engine import make_eval_step as jax_make_eval_step
from apex_example_tpu.engine import make_train_step as jax_make_step
from apex_example_tpu.models.bert import bert_tiny as jax_bert_tiny
from apex_example_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from apex_example_tpu.models.resnet import resnet18 as jax_resnet18
from apex_example_tpu.models.transformer_xl import \
    transformer_xl_tiny as jax_txl_tiny
from apex_example_tpu.optim.fused import FusedAdagrad as JaxAdagrad
from apex_example_tpu.optim.fused import FusedAdam as JaxAdam
from apex_example_tpu.optim.fused import FusedLAMB as JaxLAMB
from apex_example_tpu.optim.fused import FusedNovoGrad as JaxNovoGrad
from apex_example_tpu.optim.fused import FusedSGD as JaxSGD
from apex_example_tpu.optim.schedules import \
    build_schedule as jax_build_schedule
from apex_example_tpu.utils.meters import Throughput as JaxThroughput
from apex_example_tpu.ops import _config as jax_ops_config
from apex_example_tpu.workloads import lm_loss as jax_lm_loss
from apex_example_tpu.workloads import make_txl_train_step as jax_txl_step
from apex_example_tpu.workloads import mlm_loss as jax_mlm_loss
from apex_example_tpu_torch import amp, train
from apex_example_tpu_torch.convert import (bert_params_from_flax,
                                            gpt_params_from_flax,
                                            resnet_params_from_flax,
                                            txl_params_from_flax)
from apex_example_tpu_torch.data.synthetic import (image_batch, lm_batch,
                                                   mlm_batch,
                                                   resize_patterns)
from apex_example_tpu_torch.engine import (create_train_state,
                                           make_eval_step, make_train_step)
from apex_example_tpu_torch.models.bert import bert_tiny
from apex_example_tpu_torch.models.gpt import gpt_tiny
from apex_example_tpu_torch.models.resnet import resnet18
from apex_example_tpu_torch.models.transformer_xl import transformer_xl_tiny
from apex_example_tpu_torch.obs.metrics import JsonlSink
from apex_example_tpu_torch.obs.telemetry import TelemetryEmitter
from apex_example_tpu_torch.optim.fused import FusedAdam, FusedLAMB, FusedSGD
from apex_example_tpu_torch.optim.schedules import build_schedule
from apex_example_tpu_torch.utils.meters import AverageMeter, Throughput
from apex_example_tpu_torch.workloads import (lm_loss, make_txl_train_step,
                                              mlm_loss)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIL_TOL = 1e-4
B, S, V, STEPS = 4, 16, 256, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread; the JAX steps on their kernels' XLA reference
    forms (``ops._config.force_xla``).  The flash-attention trails take
    the model's Pallas kernels (``pallas_kernels``) beside the optimizer's
    XLA form; Transformer-XL's trail takes the Pallas Adam kernel, whose
    rounding its steps of about lr on grads of rounding size follow
    (``KernelScope``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with jax_ops_config.force_xla(True):
        yield
    torch.set_num_threads(before)


@pytest.fixture
def pallas_kernels():
    """The JAX side through its Pallas kernels, interpreted."""
    with jax_ops_config.force_xla(False):
        yield


def test_five_step_loss_trail_matches_jax():
    batches = [tuple(np.array(a) for a in jax_mlm_batch(
        jnp.asarray(i, jnp.int32), batch_size=B, seq_len=S, vocab_size=V,
        mask_token_id=V - 1, seed=0)) for i in range(STEPS)]
    schedule = dict(name="poly", base_lr=5e-3, total_steps=STEPS,
                    warmup_steps=2)

    jm = jax_bert_tiny()
    jopt = JaxLAMB(lr=jax_build_schedule(**schedule), weight_decay=0.01)
    policy = get_policy("O0")
    jstate = create_state(jax.random.PRNGKey(3), jm, jopt,
                          jnp.asarray(batches[0][0][:1]), policy)
    init = jax.tree_util.tree_map(np.asarray, jstate.params)
    jstep = jax.jit(jax_make_step(jm, jopt, policy, loss_fn=jax_mlm_loss,
                                  compute_accuracy=False))

    pm = bert_tiny(device="cpu")
    pm.load_state_dict(bert_params_from_flax(init))
    popt = FusedLAMB(pm.parameters(), lr=build_schedule(**schedule),
                     weight_decay=0.01)
    pstate = create_train_state(pm, popt)
    pstep = make_train_step(mlm_loss)

    for ids, labels, w in batches:
        jstate, jm_metrics = jstep(
            jstate, (jnp.asarray(ids), (jnp.asarray(labels),
                                        jnp.asarray(w))))
        pstate, pm_metrics = pstep(pstate, (
            torch.from_numpy(ids), (torch.from_numpy(labels),
                                    torch.from_numpy(w))))
        np.testing.assert_allclose(float(pm_metrics["loss"]),
                                   float(jm_metrics["loss"]), rtol=TRAIL_TOL)
        np.testing.assert_allclose(float(pm_metrics["grad_norm"]),
                                   float(jm_metrics["grad_norm"]),
                                   rtol=TRAIL_TOL)
        assert pm_metrics["scale"] == float(jm_metrics["scale"]) == 1.0
        assert pm_metrics["grads_finite"] == 1.0
    assert pstate.step == STEPS == int(jstate.step)
    want = bert_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                        jstate.params))
    start = bert_params_from_flax(init)
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=TRAIL_TOL, atol=TRAIL_TOL,
                                   err_msg=name)
    moved = max(float((want[k] - start[k]).abs().max()) for k in want)
    assert moved > 10 * TRAIL_TOL        # the trail moved the weights


def _lm_batches(seq):
    """(inputs, targets) numpy pairs from the JAX ``lm_batch``."""
    out = []
    for i in range(STEPS):
        toks = np.array(jax_lm_batch(jnp.asarray(i, jnp.int32),
                                     batch_size=B, seq_len=seq,
                                     vocab_size=V, seed=0))
        out.append((np.ascontiguousarray(toks[:, :-1]),
                    np.ascontiguousarray(toks[:, 1:])))
    return out


def _assert_params_follow(pm, jparams, init, convert):
    want = convert(jax.tree_util.tree_map(np.asarray, jparams))
    start = convert(init)
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=TRAIL_TOL, atol=TRAIL_TOL,
                                   err_msg=name)
    moved = max(float((want[k] - start[k]).abs().max()) for k in want)
    assert moved > 10 * TRAIL_TOL        # the trail moved the weights


ADAM = dict(name="cosine", base_lr=2e-3, total_steps=STEPS, warmup_steps=1)


def test_gpt_five_step_adam_trail_matches_jax():
    # eps 1e-6, not Adam's 1e-8: the key projection's bias has a gradient
    # of zero in exact arithmetic (softmax ignores a shift common to a
    # query's logits), so each side's is rounding noise of ~1e-9, which
    # eps 1e-8 would normalize into a step of random sign and size ~lr.
    batches = _lm_batches(S)
    jm = jax_gpt_tiny()
    jopt = JaxAdam(lr=jax_build_schedule(**ADAM), eps=1e-6,
                   weight_decay=0.01)
    policy = get_policy("O0")
    jstate = create_state(jax.random.PRNGKey(4), jm, jopt,
                          jnp.asarray(batches[0][0][:1]), policy)
    init = jax.tree_util.tree_map(np.asarray, jstate.params)
    jstep = jax.jit(jax_make_step(jm, jopt, policy, loss_fn=jax_lm_loss,
                                  compute_accuracy=False))

    pm = gpt_tiny(device="cpu")
    pm.load_state_dict(gpt_params_from_flax(init))
    pstate = create_train_state(pm, FusedAdam(
        pm.parameters(), lr=build_schedule(**ADAM), eps=1e-6,
        weight_decay=0.01))
    pstep = make_train_step(lm_loss)
    for x, y in batches:
        jstate, jmet = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        pstate, pmet = pstep(pstate, (torch.from_numpy(x),
                                      torch.from_numpy(y)))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(pmet[key]), float(jmet[key]),
                                       rtol=TRAIL_TOL, err_msg=key)
    assert pstate.step == STEPS == int(jstate.step)
    _assert_params_follow(pm, jstate.params, init, gpt_params_from_flax)


def test_txl_five_step_trail_with_carried_memory_matches_jax():
    batches = _lm_batches(S)
    jm = jax_txl_tiny()
    jopt = JaxAdam(lr=jax_build_schedule(**ADAM), weight_decay=0.01)
    policy = get_policy("O0")
    jstate = create_state(jax.random.PRNGKey(6), jm, jopt,
                          jnp.asarray(batches[0][0][:1]), policy,
                          train_kwargs={})
    init = jax.tree_util.tree_map(np.asarray, jstate.params)
    jstep = jax.jit(jax_txl_step(jm, KernelScope(jopt, xla=False), policy,
                                 max_grad_norm=0.25))
    jmems = jm.init_mems(B)

    pm = transformer_xl_tiny(device="cpu")
    pm.load_state_dict(txl_params_from_flax(init))
    pstate = create_train_state(pm, FusedAdam(
        pm.parameters(), lr=build_schedule(**ADAM), weight_decay=0.01))
    pstep = make_txl_train_step(max_grad_norm=0.25)
    pmems = pm.init_mems(B)
    for x, y in batches:
        jstate, jmems, jmet = jstep(jstate, jmems,
                                    (jnp.asarray(x), jnp.asarray(y)))
        pstate, pmems, pmet = pstep(pstate, pmems, (torch.from_numpy(x),
                                                    torch.from_numpy(y)))
        for key in ("loss", "grad_norm", "ppl"):
            np.testing.assert_allclose(float(pmet[key]), float(jmet[key]),
                                       rtol=TRAIL_TOL, err_msg=key)
        assert float(pmet["grad_norm"]) > 0.25         # the clip engaged
        assert pmet["scale"] == float(jmet["scale"]) == 1.0
        assert pmet["grads_finite"] == float(jmet["grads_finite"]) == 1.0
        assert not pmems.requires_grad
        np.testing.assert_allclose(pmems.numpy(), np.asarray(jmems),
                                   rtol=TRAIL_TOL, atol=TRAIL_TOL)
    assert pstate.step == STEPS == int(jstate.step)
    _assert_params_follow(pm, jstate.params, init, txl_params_from_flax)


def _gpt_batches(seq, b=2, steps=3):
    """(inputs, targets) numpy pairs of the JAX ``lm_batch`` at ``seq``."""
    out = []
    for i in range(steps):
        toks = np.array(jax_lm_batch(jnp.asarray(i, jnp.int32),
                                     batch_size=b, seq_len=seq,
                                     vocab_size=V, seed=0))
        out.append((np.ascontiguousarray(toks[:, :-1]),
                    np.ascontiguousarray(toks[:, 1:])))
    return out


def _gpt_pair(level, seq, fused, batch, lr=2e-3):
    """JAX and port gpt_tiny train states at amp ``level`` from one flax
    init, FusedAdam (eps 1e-6: see the five-step trail), the position
    table widened to ``seq``."""
    policy = get_policy(level)
    jmd = jamp.module_dtypes(policy)
    jm = jax_gpt_tiny(max_position=max(seq, 128), fused_attention=fused,
                      dtype=jmd.compute, param_dtype=jmd.param,
                      ln_dtype=jmd.ln_io, softmax_dtype=jmd.softmax)
    jopt = JaxAdam(lr=lr, eps=1e-6, weight_decay=0.01)
    jstate = create_state(jax.random.PRNGKey(4), jm, jopt,
                          jnp.asarray(batch[:1]), policy)
    init = jax.tree_util.tree_map(np.asarray, jstate.params)
    ppolicy, scaler = amp.initialize(level)
    md = amp.module_dtypes(ppolicy)
    pm = gpt_tiny(device="cpu", max_position=max(seq, 128),
                  fused_attention=fused, dtype=md.compute,
                  param_dtype=md.param, ln_dtype=md.ln_io,
                  softmax_dtype=md.softmax)
    pm.load_state_dict(gpt_params_from_flax(init))
    pstate = create_train_state(pm, FusedAdam(
        pm.parameters(), lr=lr, eps=1e-6, weight_decay=0.01), ppolicy,
        scaler)
    return jm, jopt, policy, jstate, init, pm, pstate


@pytest.mark.usefixtures("pallas_kernels")
def test_gpt_fused_attention_trail_matches_jax():
    """Three steps of gpt_tiny with ``--fused-attention`` at S = 256: the
    JAX step runs the Pallas flash kernels (interpreted), the port's the
    plain version of its kernels; loss and grad norm rtol 1e-4, the
    parameters after three steps 1e-4."""
    batches = _gpt_batches(256)
    jm, jopt, policy, jstate, init, pm, pstate = _gpt_pair(
        "O0", 256, True, batches[0][0])
    assert pm.layers[0].attention.uses_kernel(256)
    jstep = jax.jit(jax_make_step(jm, KernelScope(jopt, xla=True), policy,
                                  loss_fn=jax_lm_loss,
                                  compute_accuracy=False))
    pstep = make_train_step(lm_loss)
    for x, y in batches:
        jstate, jmet = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        pstate, pmet = pstep(pstate, (torch.from_numpy(x),
                                      torch.from_numpy(y)))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(pmet[key]), float(jmet[key]),
                                       rtol=TRAIL_TOL, err_msg=key)
    _assert_params_follow(pm, jstate.params, init, gpt_params_from_flax)


@pytest.mark.usefixtures("pallas_kernels")
def test_gpt_o2_fused_trail_follows_jax_within_bf16_rounding():
    """amp O2 (bf16 dense layers, embeddings, LayerNorm I/O and flash
    attention over fp32 masters) held as ResNet-18's O2 is: each tensor of
    the port's first O2 grads no more than twice as far from the fp32
    grads as JAX's O2 grads are, then three steps' losses rtol 2e-2.  The
    key projections' biases are left out: their exact gradient is zero
    (softmax ignores a shift common to a row's logits), so each side's is
    rounding noise and so is its distance."""
    batches = _gpt_batches(128)
    x, y = batches[0]
    _, _, _, _, _, pm0, _ = _gpt_pair("O0", 128, True, x)
    lm_loss(pm0(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    g32 = {n: p.grad for n, p in pm0.named_parameters()}
    jm, jopt, policy, jstate, _, pm, pstate = _gpt_pair("O2", 128, True, x)
    assert pm.layers[0].attention.query.weight.dtype == torch.float32
    jgrads = jax.jit(jax.grad(lambda p: jax_lm_loss(
        jm.apply({"params": p}, jnp.asarray(x)), jnp.asarray(y))))(
            jstate.params)
    j16 = gpt_params_from_flax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jgrads))
    lm_loss(pm(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    rel = lambda a, b: float((a - b).norm() / b.norm())     # noqa: E731
    for name, p in pm.named_parameters():
        if name.endswith("attention.key.bias"):
            continue
        assert p.grad.dtype == torch.float32
        assert rel(p.grad, g32[name]) <= 2 * rel(j16[name], g32[name]) \
            + 1e-3, name
    pm.zero_grad(set_to_none=False)
    jstep = jax.jit(jax_make_step(jm, KernelScope(jopt, xla=True), policy,
                                  loss_fn=jax_lm_loss,
                                  compute_accuracy=False))
    pstep = make_train_step(lm_loss)
    for x, y in batches:
        jstate, jmet = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        pstate, pmet = pstep(pstate, (torch.from_numpy(x),
                                      torch.from_numpy(y)))
        np.testing.assert_allclose(float(pmet["loss"]), float(jmet["loss"]),
                                   rtol=2e-2)
        assert float(pmet["scale"]) == 1.0
    assert all(p.dtype == torch.float32 for p in pm.parameters())


def test_step_records_carry_ppl(tmp_path):
    path = tmp_path / "s.jsonl"
    emitter = TelemetryEmitter(JsonlSink(str(path)), torch.device("cpu"))
    emitter.run_header(config={"arch": "transformer_xl_tiny"})
    rec = emitter.on_step(global_step=1, epoch=0, items=8, t_start=0.0,
                          metrics={"loss": torch.tensor(2.0),
                                   "ppl": torch.exp(torch.tensor(2.0)),
                                   "grad_norm": torch.tensor(0.5),
                                   "scale": 1.0, "grads_finite": 1.0})
    emitter.close()
    np.testing.assert_allclose(rec["ppl"], np.exp(2.0), rtol=1e-6)
    _lint(path)


def _main(argv):
    """``train.main(argv)`` in this process, which is what ``python -m
    apex_example_tpu_torch.train`` runs (test_cli_runs_on_the_cpu_and_its_
    stream_lints takes that route itself): its exit code and stdout."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = train.main(argv)
    return code, out.getvalue()


def _lint(stream):
    lint = subprocess.run(
        [sys.executable, "tools/metrics_lint.py", str(stream),
         "--require-summary"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert lint.returncode == 0, lint.stdout + lint.stderr


def _run_cli(tmp_path, arch, *extra):
    stream = tmp_path / f"{arch}.jsonl"
    code, stdout = _main(
        ["--device", "cpu", "--arch", arch, "--batch-size", "4",
         "--seq-len", "16", "--steps-per-epoch", "3", "--print-freq", "1",
         "--metrics-jsonl", str(stream), *extra])
    assert code == 0
    _lint(stream)
    lines = [ln for ln in stdout.splitlines()
             if ln.startswith("epoch 0 step ")]
    records = [json.loads(ln) for ln in stream.read_text().splitlines()]
    return stdout, lines, records


@pytest.mark.parametrize("arch", ["gpt_tiny", "transformer_xl_tiny"])
def test_lm_cli_runs_on_the_cpu_and_its_stream_lints(tmp_path, arch):
    out, lines, records = _run_cli(tmp_path, arch, "--opt", "adam",
                                   "--lr", "1e-3")
    assert f"model {arch}:" in out and "opt adam" in out
    assert len(lines) == 3 and lines[-1].endswith("scale 1")
    steps = [r for r in records if r["record"] == "step"]
    assert [r["step"] for r in steps] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0
               for r in steps)
    if arch == "transformer_xl_tiny":
        assert all(" ppl " in ln for ln in lines)
        for r in steps:
            np.testing.assert_allclose(r["ppl"], np.exp(r["loss"]),
                                       rtol=1e-5)
    else:
        assert not any(" ppl " in ln for ln in lines)
        assert all("ppl" not in r for r in steps)
    assert records[-1]["record"] == "run_summary"


@pytest.mark.parametrize("level", ["O0", "O2"])
def test_gpt_cli_with_fused_attention_lints(tmp_path, level):
    out, lines, records = _run_cli(tmp_path, "gpt_tiny", "--opt", "adam",
                                   "--lr", "1e-3", "--fused-attention",
                                   "--opt-level", level)
    assert "attention flash kernels" in out
    assert f"opt-level {level} (compute " + (
        "float32" if level == "O0" else "bfloat16") in out
    assert len(lines) == 3 and lines[-1].endswith("scale 1")
    assert records[0]["config"]["fused_attention"] is True
    steps = [r for r in records if r["record"] == "step"]
    assert all(np.isfinite(r["loss"]) for r in steps)


@pytest.mark.parametrize("argv,match", [
    (["--arch", "gpt_tiny", "--fused-attention", "--opt-level", "O3"],
     "fp32 softmax"),
    (["--arch", "transformer_xl_tiny", "--fused-attention"],
     "BERT/GPT archs only"),
    (["--arch", "resnet18", "--fused-attention"], "BERT/GPT archs only"),
    (["--arch", "gpt_tiny", "--fused-attention", "--opt-level", "O2",
      "--loss-scale", "dynamic", "--numerics-check", "warn"], "^2$"),
    (["--arch", "transformer_xl_tiny", "--opt-level", "O2",
      "--preempt-grace", "30"], "^2$"),
    (["--arch", "transformer_xl_tiny", "--opt-level", "O2",
      "--loss-scale", "dynamic", "--numerics-check", "overflow",
      "--metrics-jsonl", "x.jsonl"],
     "transformer_xl steps own their own grad pipelines")])
def test_fused_attention_and_amp_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        train.main(["--device", "cpu"] + argv)


def test_cli_runs_on_the_cpu_and_its_stream_lints(tmp_path):
    stream = tmp_path / "train.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "apex_example_tpu_torch.train", "--device",
         "cpu", "--arch", "bert_tiny", "--batch-size", "4", "--seq-len",
         "16", "--steps-per-epoch", "3", "--print-freq", "1", "--lr",
         "1e-3", "--warmup-steps", "2", "--lr-schedule", "poly",
         "--metrics-jsonl", str(stream)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("epoch 0 step ")]
    assert len(lines) == 3 and lines[-1].startswith("epoch 0 step 3/3 loss")
    assert lines[-1].endswith("scale 1")
    _lint(stream)
    records = [json.loads(ln) for ln in stream.read_text().splitlines()]
    assert records[0]["platform"] == "cpu"
    steps = [r for r in records if r["record"] == "step"]
    assert [r["step"] for r in steps] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0
               for r in steps)
    assert records[-1]["record"] == "run_summary"
    assert records[-1]["steps"] == 3


def test_cli_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "bert_tiny", "--steps-per-epoch", "1"])


@pytest.mark.parametrize("argv", [["--pipeline-parallel", "2"],
                                  ["--cost-model"],
                                  ["--context-parallel", "2"],
                                  ["--tensor-parallel", "2"]])
def test_flags_of_other_paths_are_rejected(argv):
    with pytest.raises(SystemExit) as exc:
        train.build_parser().parse_args(["--device", "cpu"] + argv)
    assert exc.value.code == 2


def test_train_rejects_non_positive_sizes():
    with pytest.raises(SystemExit, match="batch-size"):
        train.main(["--device", "cpu", "--arch", "bert_tiny",
                    "--batch-size", "0"])


def test_mlm_batch_distributions():
    ids, labels, w = mlm_batch(3, batch_size=64, seq_len=128,
                               vocab_size=1000, mask_token_id=999, seed=0)
    assert ids.shape == labels.shape == w.shape == (64, 128)
    assert ids.dtype == labels.dtype == np.int32 and w.dtype == np.float32
    again = mlm_batch(3, batch_size=64, seq_len=128, vocab_size=1000,
                      mask_token_id=999, seed=0)
    for a, b in zip((ids, labels, w), again):
        np.testing.assert_array_equal(a, b)          # (seed, step) decides
    other = mlm_batch(4, batch_size=64, seq_len=128, vocab_size=1000,
                      mask_token_id=999, seed=0)[0]
    assert not np.array_equal(ids, other)
    masked = w > 0
    assert abs(masked.mean() - 0.15) < 0.01
    as_mask = (ids == 999) & masked
    kept = (ids == labels) & masked
    assert abs(as_mask.sum() / masked.sum() - 0.8) < 0.03
    assert abs(kept.sum() / masked.sum() - 0.1) < 0.03      # (+ rand hits)
    assert (ids[~masked] == labels[~masked]).all()


def test_lm_batch_keeps_the_affine_bigram():
    toks = lm_batch(0, batch_size=32, seq_len=200, vocab_size=1000, seed=1)
    assert toks.shape == (32, 201) and toks.dtype == np.int32
    follows = toks[:, 1:] == (31 * toks[:, :-1] + 17) % 1000
    assert abs(follows.mean() - 0.9) < 0.02


def test_meters_match_the_jax_package():
    m = AverageMeter("loss")
    for v in (3.0, 1.0, 2.0):
        m.update(v)
    assert str(m) == "loss 2.0000 (2.0000)" and m.count == 3
    ours, theirs = Throughput(warmup_steps=2), JaxThroughput(warmup_steps=2)
    for _ in range(4):
        ours.step(10)
        theirs.step(10)
    assert ours.items == theirs.items == 20 and ours.rate > 0


IMG_CLASSES, IMG_SIZE, IMG_STEPS = 10, 16, 5


def _flax_weights(jm, seed):
    """The flax ``params`` / ``batch_stats`` of ``jm`` from numpy (He-normal
    kernels, BatchNorm around its init): ``jax.eval_shape`` gives the tree
    without running the init."""
    tree = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG_SIZE, IMG_SIZE, 3)),
        train=False))
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            std = np.sqrt(2.0 / np.prod(shape[:-1]))
            return (rs.randn(*shape) * std).astype(np.float32)
        base = {"scale": 1.0, "var": 1.0}.get(name, 0.0)
        return (base + 0.05 * rs.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _image_batches(n, start=0):
    return [tuple(np.array(a) for a in jax_image_batch(
        jnp.asarray(start + i, jnp.int32), batch_size=B,
        image_size=IMG_SIZE, num_classes=IMG_CLASSES, seed=0))
        for i in range(n)]


def _resnet_pair(level, lr, loss_scale=None, seed=2):
    """JAX and port ResNet-18 train states at ``level`` from one set of
    weights, with FusedSGD (momentum 0.9, weight decay 1e-4)."""
    jpolicy = get_policy(level, loss_scale=loss_scale)
    jmd = jamp.module_dtypes(jpolicy)
    jm = jax_resnet18(num_classes=IMG_CLASSES, num_filters=4,
                      small_stem=True, dtype=jmd.compute,
                      param_dtype=jmd.param, bn_dtype=jmd.bn_stats,
                      bn_io_dtype=jmd.bn_io)
    v = _flax_weights(jm, seed)
    jopt = JaxSGD(lr=lr if not isinstance(lr, dict) else
                  jax_build_schedule(**lr), momentum=0.9, weight_decay=1e-4)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        batch_stats=v["batch_stats"], opt_state=jopt.init(v["params"]),
        scaler=jamp.make_scaler(jpolicy))
    policy, scaler = amp.initialize(level, loss_scale=loss_scale)
    md = amp.module_dtypes(policy)
    pm = resnet18(num_classes=IMG_CLASSES, num_filters=4, small_stem=True,
                  dtype=md.compute, param_dtype=md.param,
                  bn_dtype=md.bn_stats, bn_io_dtype=md.bn_io, device="cpu")
    pm.load_state_dict(resnet_params_from_flax(v["params"],
                                               v["batch_stats"]))
    popt = FusedSGD(pm.parameters(), lr=lr if not isinstance(lr, dict) else
                    build_schedule(**lr), momentum=0.9, weight_decay=1e-4)
    pstate = create_train_state(pm, popt, policy, scaler)
    return jm, jopt, jpolicy, jstate, pm, popt, pstate


def _assert_resnet_follows(pm, jstate, tol):
    want = resnet_params_from_flax(
        jax.tree_util.tree_map(np.asarray, jstate.params),
        jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    for name, t in list(pm.named_parameters()) + list(pm.named_buffers()):
        np.testing.assert_allclose(t.detach().float().numpy(),
                                   want[name].float().numpy(), rtol=tol,
                                   atol=tol, err_msg=name)


@pytest.fixture(scope="module")
def resnet_o0_trail():
    jm, jopt, jpolicy, jstate, pm, popt, pstate = _resnet_pair("O0", 0.02)
    jstep = jax.jit(jax_make_step(jm, jopt, jpolicy))
    pstep = make_train_step()
    metrics = []
    for x, y in _image_batches(IMG_STEPS):
        jstate, jmet = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        pstate, pmet = pstep(pstate, (torch.from_numpy(x),
                                      torch.from_numpy(y).long()))
        metrics.append((jmet, pmet))
    return jm, jstate, pstate, metrics


def test_resnet18_five_step_sgd_trail_matches_jax(resnet_o0_trail):
    _, jstate, pstate, metrics = resnet_o0_trail
    for jmet, pmet in metrics:
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(pmet[key]), float(jmet[key]),
                                       rtol=TRAIL_TOL, err_msg=key)
        assert float(pmet["top1"]) == float(jmet["top1"])
        assert float(pmet["scale"]) == float(jmet["scale"]) == 1.0
        assert pmet["grads_finite"] == 1.0
    assert pstate.step == IMG_STEPS == int(jstate.step)
    assert pstate.optimizer.step_count == int(jstate.opt_state.step)
    _assert_resnet_follows(pstate.model, jstate, TRAIL_TOL)
    losses = [float(p["loss"]) for _, p in metrics]
    assert losses[-1] < losses[0]


def test_resnet18_eval_step_matches_jax(resnet_o0_trail):
    jm, jstate, pstate, _ = resnet_o0_trail
    jeval = jax.jit(jax_make_eval_step(jm))
    peval = make_eval_step()
    for x, y in _image_batches(2, start=10_000):
        jmet = jeval(jstate, (jnp.asarray(x), jnp.asarray(y)))
        pmet = peval(pstate, (torch.from_numpy(x),
                              torch.from_numpy(y).long()))
        np.testing.assert_allclose(float(pmet["loss"]), float(jmet["loss"]),
                                   rtol=TRAIL_TOL)
        for key in ("top1", "top5"):
            assert float(pmet[key]) == float(jmet[key]), key
    assert not pstate.model.training


def _first_grads(jm, jstate, pm, x, y):
    """The grads of one cross-entropy loss, JAX's and the port's, fp32."""
    def loss(params):
        logits, _ = jm.apply({"params": params,
                              "batch_stats": jstate.batch_stats},
                             jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
        return jax_cross_entropy(logits, jnp.asarray(y))

    g = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                               jax.jit(jax.grad(loss))(jstate.params))
    pm.train()
    torch.nn.functional.cross_entropy(
        pm(torch.from_numpy(x)), torch.from_numpy(y).long()).backward()
    got = {n: p.grad.detach().float().clone()
           for n, p in pm.named_parameters()}
    pm.zero_grad(set_to_none=False)
    return resnet_params_from_flax(g), got


def test_resnet18_o2_trail_follows_jax_within_bf16_rounding():
    # bf16 rounds each activation and cotangent to 8 bits, and the two
    # frameworks round at other places (XLA inside its fusions, PyTorch
    # after each op), so O2 is held to its distance from fp32: each
    # tensor of the port's O2 grads no more than twice as far from the
    # fp32 grads as JAX's O2 grads are (BatchNorm biases, sums of
    # cancelling bf16 cotangents, are 20-80% off in both).  Three steps
    # at a small lr: losses rtol 2e-2 (bf16 logits, through BatchNorm
    # over few rows).
    # The fp32 grads are the port's at O0, which equal JAX's (the O0 trail).
    (x, y), = _image_batches(1)
    _, _, _, _, pm0, _, _ = _resnet_pair("O0", 0.001)
    pm0.train()
    torch.nn.functional.cross_entropy(
        pm0(torch.from_numpy(x)), torch.from_numpy(y).long()).backward()
    g32 = {n: p.grad for n, p in pm0.named_parameters()}
    jm, jopt, jpolicy, jstate, pm, popt, pstate = _resnet_pair("O2", 0.001)
    j16, p16 = _first_grads(jm, jstate, pm, x, y)
    rel = lambda a, b: float((a - b).norm() / b.norm())     # noqa: E731
    for name, g in g32.items():
        assert rel(p16[name], g) <= 2 * rel(j16[name], g) + 1e-3, name
    jstep = jax.jit(jax_make_step(jm, jopt, jpolicy))
    pstep = make_train_step()
    assert pm.get_submodule("conv_init").weight.dtype == torch.float32
    for x, y in _image_batches(3):
        jstate, jmet = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        pstate, pmet = pstep(pstate, (torch.from_numpy(x),
                                      torch.from_numpy(y).long()))
        np.testing.assert_allclose(float(pmet["loss"]), float(jmet["loss"]),
                                   rtol=2e-2)
    assert all(p.dtype == torch.float32 for p in pm.parameters())


def test_dynamic_scaling_skips_an_overflow_step_as_jax_does():
    schedule = dict(name="step", base_lr=0.05, total_steps=6,
                    boundaries=[2, 4], gamma=0.5)
    jm, jopt, jpolicy, jstate, pm, popt, pstate = _resnet_pair(
        "O0", schedule, loss_scale="dynamic")
    jloss = lambda logits, y: jax_cross_entropy(logits, y[0]) * y[1]
    ploss = lambda logits, y: (                         # noqa: E731
        torch.nn.functional.cross_entropy(logits.float(), y[0]) * y[1])
    jstep = jax.jit(jax_make_step(jm, jopt, jpolicy, loss_fn=jloss))
    pstep = make_train_step(ploss)
    jlr = jax_build_schedule(**schedule)
    factors = [1.0, 1.0, 1e38, 1.0, 1.0, 1.0]         # step 3 overflows
    for (x, y), f in zip(_image_batches(len(factors)), factors):
        jstate, jmet = jstep(jstate, (jnp.asarray(x),
                                      (jnp.asarray(y), jnp.float32(f))))
        pstate, pmet = pstep(pstate, (torch.from_numpy(x), (
            torch.from_numpy(y).long(), torch.tensor(f, dtype=torch.float32))))
        skipped = f > 1.0
        assert float(pmet["grads_finite"]) == float(jmet["grads_finite"]) \
            == (0.0 if skipped else 1.0)
        assert float(pmet["scale"]) == float(jmet["scale"])
        assert popt.step_count == int(jstate.opt_state.step)
        np.testing.assert_allclose(
            float(popt.lr_tensor()),
            float(jlr(jstate.opt_state.step + 1)), rtol=1e-7)
        _assert_resnet_follows(pm, jstate, TRAIL_TOL)
        for i, (name, _) in enumerate(pm.named_parameters()):
            want = resnet_params_from_flax(jax.tree_util.tree_map(
                np.asarray, jstate.opt_state.momentum))[name]
            np.testing.assert_allclose(popt.momentum_buffer[i].numpy(),
                                       want.numpy(), rtol=TRAIL_TOL,
                                       atol=TRAIL_TOL, err_msg=name)
    assert float(pstate.scaler.scale) == 2.0 ** 15
    assert popt.step_count == 5 and pstate.step == 6


def test_image_cli_runs_o2_dynamic_with_eval_and_its_stream_lints(tmp_path):
    stream = tmp_path / "resnet.jsonl"
    code, stdout = _main(
        ["--device", "cpu", "--arch", "resnet18", "--dataset", "cifar10",
         "--opt-level", "O2", "--loss-scale", "dynamic", "--eval",
         "--eval-batches", "2", "--batch-size", "4", "--steps-per-epoch",
         "3", "--print-freq", "1", "--lr", "0.01", "--metrics-jsonl",
         str(stream)])
    assert code == 0
    lines = stdout.splitlines()
    steps = [ln for ln in lines if ln.startswith("epoch 0 step ")]
    assert len(steps) == 3 and all(" top1 " in ln and " img/s scale 65536"
                                   in ln for ln in steps)
    assert any(ln.startswith("epoch 0 EVAL loss ") and ln.endswith(
        "(2 batches)") for ln in lines)
    assert "opt-level O2 (compute bfloat16" in stdout
    _lint(stream)
    records = [json.loads(ln) for ln in stream.read_text().splitlines()]
    recs = [r for r in records if r["record"] == "step"]
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert all(r["scale"] == 65536.0 and "top1" in r and r["grads_finite"]
               == 1.0 for r in recs)
    assert records[-1]["record"] == "run_summary"


@pytest.mark.parametrize("argv", [["--opt-level", "O1", "--numerics-check",
                                   "warn"],
                                  ["--loss-scale", "dynamic",
                                   "--preempt-grace", "30"],
                                  ["--moe-experts", "2"]])
def test_lm_archs_refuse_amp_and_eval_until_their_slice(argv):
    with pytest.raises(SystemExit) as exc:
        train.main(["--device", "cpu", "--arch", "bert_tiny"] + argv)
    assert exc.value.code == 2


def test_reference_launcher_flags_are_accepted_and_change_nothing(tmp_path):
    def trail(extra):
        stream = tmp_path / f"{len(extra)}.jsonl"
        with contextlib.redirect_stdout(io.StringIO()):
            assert train.main(["--device", "cpu", "--arch", "bert_tiny",
                               "--opt", "lamb", "--lr", "1e-2",
                               "--batch-size", "4", "--seq-len", "16",
                               "--steps-per-epoch", "3", "--metrics-jsonl",
                               str(stream)] + extra) == 0
        records = [json.loads(ln) for ln in stream.read_text().splitlines()]
        return records[0], [r["loss"] for r in records
                            if r["record"] == "step"]
    plain_header, plain = trail([])
    for flags in (["--local_rank", "3", "--workers", "8", "--deterministic",
                   "--num-devices", "1", "--metrics-all-ranks"],
                  ["--local-rank", "3"]):
        header, losses = trail(flags)
        assert losses == plain and len(plain) == 3
        assert header["config"]["local_rank"] == 3
    assert header["process_index"] == 0 and header["num_processes"] == 1
    assert plain_header["config"]["local_rank"] == 0
    assert not list(tmp_path.glob("*.rank*"))    # one process, one file
    with pytest.raises(SystemExit, match="start 2 processes"):
        train.main(["--device", "cpu", "--arch", "bert_tiny",
                    "--num-devices", "2"])


def test_image_patterns_are_jax_image_resize():
    low = np.random.RandomState(0).randn(3, 8, 8, 2).astype(np.float32)
    for size in (32, 224):
        want = jax.image.resize(jnp.asarray(low), (3, size, size, 2),
                                "bilinear")
        got = resize_patterns(torch.from_numpy(low), size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_image_batch_is_deterministic_per_step_on_its_device():
    imgs, labels = image_batch(3, batch_size=64, image_size=32, seed=0)
    again = image_batch(3, batch_size=64, image_size=32, seed=0)
    other = image_batch(4, batch_size=64, image_size=32, seed=0)
    assert imgs.shape == (64, 32, 32, 3) and imgs.dtype == torch.float32
    assert labels.dtype == torch.int64 and labels.shape == (64,)
    assert int(labels.min()) >= 0 and int(labels.max()) < 10
    assert torch.equal(imgs, again[0]) and torch.equal(labels, again[1])
    assert not torch.equal(imgs, other[0])
    noisy = image_batch(3, batch_size=4096, image_size=8, seed=0,
                        label_noise=0.5)[1]
    clean = image_batch(3, batch_size=4096, image_size=8, seed=0)[1]
    assert torch.equal(noisy[:0], clean[:0])
    changed = float((noisy != clean).float().mean())
    assert 0.35 < changed < 0.55         # p (1 - 1 / classes) = 0.45


def _main_records(monkeypatch, tmp_path, argv, make_model):
    """``train.main`` on the CPU with the model ``make_model(args, device,
    policy)`` builds; its step records."""
    monkeypatch.setattr(train, "build_model", make_model)
    stream = tmp_path / "main.jsonl"
    assert train.main(["--device", "cpu"] + argv
                      + ["--metrics-jsonl", str(stream)]) == 0
    records = [json.loads(ln) for ln in stream.read_text().splitlines()]
    return [r for r in records if r["record"] == "step"]


def _assert_follow_jax(steps, jstep, jstate, batches):
    assert len(steps) == len(batches)
    for rec, batch in zip(steps, batches):
        jstate, jmet = jstep(jstate, batch)
        np.testing.assert_allclose(rec["loss"], float(jmet["loss"]),
                                   rtol=TRAIL_TOL)
        np.testing.assert_allclose(rec["grad_norm"],
                                   float(jmet["grad_norm"]), rtol=TRAIL_TOL)


def test_main_novograd_bert_tiny_follows_jax(monkeypatch, tmp_path):
    argv = ["--arch", "bert_tiny", "--opt", "novograd", "--lr", "0.05",
            "--weight-decay", "0.01", "--batch-size", str(B), "--seq-len",
            str(S), "--steps-per-epoch", "3", "--print-freq", "1"]
    args = train.build_parser().parse_args(argv)
    batches = []
    for i in range(3):
        ids, (labels, w) = train.batch_fn(args, V, i, "cpu")
        batches.append((jnp.asarray(ids.numpy()),
                        (jnp.asarray(labels.numpy()), jnp.asarray(w.numpy()))))
    jm = jax_bert_tiny()
    jopt = JaxNovoGrad(lr=0.05, weight_decay=0.01)
    policy = get_policy("O0")
    jstate = create_state(jax.random.PRNGKey(4), jm, jopt,
                          batches[0][0][:1], policy)
    weights = bert_params_from_flax(
        jax.tree_util.tree_map(np.asarray, jstate.params))

    def make_model(args, device, policy=None):
        model = bert_tiny(device=device)
        model.load_state_dict(weights)
        return model

    steps = _main_records(monkeypatch, tmp_path, argv, make_model)
    jstep = jax.jit(jax_make_step(jm, jopt, policy, loss_fn=jax_mlm_loss,
                                  compute_accuracy=False))
    _assert_follow_jax(steps, jstep, jstate, batches)


def test_main_adagrad_resnet18_follows_jax(monkeypatch, tmp_path):
    argv = ["--arch", "resnet18", "--dataset", "cifar10", "--opt",
            "adagrad", "--lr", "0.01", "--batch-size", str(B),
            "--steps-per-epoch", "3", "--print-freq", "1"]
    args = train.build_parser().parse_args(argv)
    batches = [tuple(jnp.asarray(t.numpy()) for t in
                     train.batch_fn(args, 0, i, "cpu")) for i in range(3)]
    jpolicy = get_policy("O0")
    jm = jax_resnet18(num_classes=IMG_CLASSES, num_filters=4,
                      small_stem=True)
    v = _flax_weights(jm, 3)
    jopt = JaxAdagrad(lr=0.01, weight_decay=1e-4)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        batch_stats=v["batch_stats"], opt_state=jopt.init(v["params"]),
        scaler=jamp.make_scaler(jpolicy))
    weights = resnet_params_from_flax(v["params"], v["batch_stats"])

    def make_model(args, device, policy=None):
        model = resnet18(num_classes=IMG_CLASSES, num_filters=4,
                         small_stem=True, device=device)
        model.load_state_dict(weights)
        return model

    steps = _main_records(monkeypatch, tmp_path, argv, make_model)
    _assert_follow_jax(steps, jax.jit(jax_make_step(jm, jopt, jpolicy)),
                       jstate, batches)


@pytest.mark.parametrize("opt", ["novograd", "adagrad", "adam", "lamb"])
@pytest.mark.parametrize("flag", [["--opt-level", "O3"],
                                  ["--opt-level", "O2", "--loss-scale",
                                   "dynamic"]])
def test_check_args_takes_the_noop_flag_optimizers_on_images(opt, flag):
    args = train.build_parser().parse_args(
        ["--device", "cpu", "--arch", "resnet18", "--opt", opt] + flag)
    train.check_args(args)
