"""The port's training slice held against the JAX package's: bert_tiny MLM
with FusedLAMB at amp O0, on the CPU.

- A 5-step loss trail: identical initial weights (the flax init, converted)
  and identical batches (the JAX ``mlm_batch``, as numpy) through the JAX
  ``make_train_step`` (its Pallas LayerNorm and LAMB kernels through the
  interpreter, tests/conftest.py) and through the port's step.  Losses rtol
  1e-4, parameters after 5 steps rtol and atol 1e-4: fp32 on both sides,
  sums in another order, compounding over five steps.
- The CLI: ``python -m apex_example_tpu_torch.train --device cpu`` exits 0
  and its ``--metrics-jsonl`` stream passes ``tools/metrics_lint.py
  --require-summary``; without ``--device`` it raises where torch sees no
  CUDA; the flags of other paths (``--opt adam``, ``--opt-level O2``) are
  rejected by argparse.
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
from apex_example_tpu.data.synthetic import mlm_batch as jax_mlm_batch
from apex_example_tpu.engine import create_train_state as jax_create_state
from apex_example_tpu.engine import make_train_step as jax_make_step
from apex_example_tpu.models.bert import bert_tiny as jax_bert_tiny
from apex_example_tpu.optim.fused import FusedLAMB as JaxLAMB
from apex_example_tpu.optim.schedules import \
    build_schedule as jax_build_schedule
from apex_example_tpu.utils.meters import Throughput as JaxThroughput
from apex_example_tpu.workloads import mlm_loss as jax_mlm_loss
from apex_example_tpu_torch import train
from apex_example_tpu_torch.convert import bert_params_from_flax
from apex_example_tpu_torch.data.synthetic import lm_batch, mlm_batch
from apex_example_tpu_torch.engine import create_train_state, make_train_step
from apex_example_tpu_torch.models.bert import bert_tiny
from apex_example_tpu_torch.optim.fused import FusedLAMB
from apex_example_tpu_torch.optim.schedules import build_schedule
from apex_example_tpu_torch.utils.meters import AverageMeter, Throughput
from apex_example_tpu_torch.workloads import mlm_loss

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


@pytest.mark.parametrize("argv", [["--opt", "adam"], ["--opt-level", "O2"],
                                  ["--arch", "gpt_tiny"],
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
