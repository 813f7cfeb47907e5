"""The port's training slices held against the JAX package's at amp O0, on
the CPU: bert_tiny MLM with FusedLAMB, gpt_tiny with FusedAdam and
transformer_xl_tiny with the global-norm clip, FusedAdam and its memory
carried from step to step.

- 5-step loss trails: identical initial weights (the flax init, converted)
  and identical batches (the JAX ``mlm_batch`` / ``lm_batch``, as numpy)
  through the JAX ``make_train_step`` / ``make_txl_train_step`` (their
  Pallas LayerNorm, L2-norm, scale, LAMB and Adam kernels through the
  interpreter, tests/conftest.py) and through the port's steps.  Losses
  and grad norms rtol 1e-4, parameters after 5 steps rtol and atol 1e-4:
  fp32 on both sides, sums in another order, compounding over five steps.
- The CLI: ``python -m apex_example_tpu_torch.train --device cpu`` exits 0
  for bert_tiny, gpt_tiny and transformer_xl_tiny, and its
  ``--metrics-jsonl`` stream passes ``tools/metrics_lint.py
  --require-summary`` (the Transformer-XL stream carries ``ppl``); without
  ``--device`` it raises where torch sees no CUDA; the flags of paths not
  ported (``--opt sgd``, ``--opt-level O2``, ``--arch resnet18``,
  ``--tensor-parallel``) are rejected by argparse.
- The numpy data generators keep the JAX generators' distributions.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_example_tpu.amp.policy import get_policy
from apex_example_tpu.data.synthetic import lm_batch as jax_lm_batch
from apex_example_tpu.data.synthetic import mlm_batch as jax_mlm_batch
from apex_example_tpu.engine import create_train_state as jax_create_state
from apex_example_tpu.engine import make_train_step as jax_make_step
from apex_example_tpu.models.bert import bert_tiny as jax_bert_tiny
from apex_example_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from apex_example_tpu.models.transformer_xl import \
    transformer_xl_tiny as jax_txl_tiny
from apex_example_tpu.optim.fused import FusedAdam as JaxAdam
from apex_example_tpu.optim.fused import FusedLAMB as JaxLAMB
from apex_example_tpu.optim.schedules import \
    build_schedule as jax_build_schedule
from apex_example_tpu.utils.meters import Throughput as JaxThroughput
from apex_example_tpu.workloads import lm_loss as jax_lm_loss
from apex_example_tpu.workloads import make_txl_train_step as jax_txl_step
from apex_example_tpu.workloads import mlm_loss as jax_mlm_loss
from apex_example_tpu_torch import train
from apex_example_tpu_torch.convert import (bert_params_from_flax,
                                            gpt_params_from_flax,
                                            txl_params_from_flax)
from apex_example_tpu_torch.data.synthetic import lm_batch, mlm_batch
from apex_example_tpu_torch.engine import create_train_state, make_train_step
from apex_example_tpu_torch.models.bert import bert_tiny
from apex_example_tpu_torch.models.gpt import gpt_tiny
from apex_example_tpu_torch.models.transformer_xl import transformer_xl_tiny
from apex_example_tpu_torch.obs.metrics import JsonlSink
from apex_example_tpu_torch.obs.telemetry import TelemetryEmitter
from apex_example_tpu_torch.optim.fused import FusedAdam, FusedLAMB
from apex_example_tpu_torch.optim.schedules import build_schedule
from apex_example_tpu_torch.utils.meters import AverageMeter, Throughput
from apex_example_tpu_torch.workloads import (lm_loss, make_txl_train_step,
                                              mlm_loss)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIL_TOL = 1e-4
B, S, V, STEPS = 4, 16, 256, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_five_step_loss_trail_matches_jax():
    batches = [tuple(np.array(a) for a in jax_mlm_batch(
        jnp.asarray(i, jnp.int32), batch_size=B, seq_len=S, vocab_size=V,
        mask_token_id=V - 1, seed=0)) for i in range(STEPS)]
    schedule = dict(name="poly", base_lr=5e-3, total_steps=STEPS,
                    warmup_steps=2)

    jm = jax_bert_tiny()
    jopt = JaxLAMB(lr=jax_build_schedule(**schedule), weight_decay=0.01)
    policy = get_policy("O0")
    jstate = jax_create_state(jax.random.PRNGKey(3), jm, jopt,
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
    jstate = jax_create_state(jax.random.PRNGKey(4), jm, jopt,
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
    jstate = jax_create_state(jax.random.PRNGKey(6), jm, jopt,
                              jnp.asarray(batches[0][0][:1]), policy,
                              train_kwargs={})
    init = jax.tree_util.tree_map(np.asarray, jstate.params)
    jstep = jax.jit(jax_txl_step(jm, jopt, policy, max_grad_norm=0.25))
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
    lint = subprocess.run(
        [sys.executable, "tools/metrics_lint.py", str(path),
         "--require-summary"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert lint.returncode == 0, lint.stdout + lint.stderr


def _run_cli(tmp_path, arch, *extra):
    stream = tmp_path / f"{arch}.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "apex_example_tpu_torch.train", "--device",
         "cpu", "--arch", arch, "--batch-size", "4", "--seq-len", "16",
         "--steps-per-epoch", "3", "--print-freq", "1",
         "--metrics-jsonl", str(stream), *extra],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lint = subprocess.run(
        [sys.executable, "tools/metrics_lint.py", str(stream),
         "--require-summary"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert lint.returncode == 0, lint.stdout + lint.stderr
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("epoch 0 step ")]
    records = [json.loads(ln) for ln in stream.read_text().splitlines()]
    return proc.stdout, lines, records


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
    lint = subprocess.run(
        [sys.executable, "tools/metrics_lint.py", str(stream),
         "--require-summary"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert lint.returncode == 0, lint.stdout + lint.stderr
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


@pytest.mark.parametrize("argv", [["--opt", "sgd"], ["--opt-level", "O2"],
                                  ["--arch", "resnet18"],
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
