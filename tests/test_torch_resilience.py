"""The port's resilience held against the JAX package's, on the CPU.

- ``FaultPlan``: parses and refusals with JAX's messages, fire-once on
  equality for the training kinds, the ``nan`` kind's batch with NaN in
  exactly JAX's floating leaves (an int-only batch refused with JAX's
  message), ``hang`` sleeping ``HANG_SECONDS`` as read when the plan is
  made.  ``PreemptionHandler``: the flag, the signal's name, a second
  signal ignored, SIGTERM taken over from the flight recorder (which then
  writes nothing) and every disposition restored on close, as JAX's.
- The trainer's drills, ``train.main`` in this process at the smallest
  size (bert_tiny): ``--preempt-grace --inject-fault sigterm@2`` returns
  75 with a ``preemption`` record and an un-aborted summary, after a save
  joined behind ``--async-checkpoint`` or, at a ``--save-every-steps``
  boundary, the sidecar refreshed; ``--resume`` then continues bitwise the
  unbroken trail.  ``crash@2`` under ``--flight-recorder`` writes a
  ``crash_dump`` with the traceback and the last steps, and an aborted
  summary.
- Two subprocesses: SIGTERM without ``--preempt-grace`` exits 143 with a
  ``crash_dump``; ``tools/supervise.py`` over ``python -m
  apex_example_tpu_torch.train`` restarts it once with ``--resume`` after
  the grace exit and it finishes.
Every stream passes ``tools/metrics_lint.py --require-summary`` (the
supervisor's own too).  The data-parallel loop wires these flags as the
single-process one does (no multi-process case here).
"""

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_example_tpu import obs as jobs
from apex_example_tpu.resilience import faults as jfaults
from apex_example_tpu.resilience import preemption as jpreemption
from apex_example_tpu_torch import train
from apex_example_tpu_torch.obs.flight import FlightRecorder
from apex_example_tpu_torch.obs.metrics import JsonlSink
from apex_example_tpu_torch.obs.telemetry import TelemetryEmitter
from apex_example_tpu_torch.resilience import (EX_TEMPFAIL, FaultInjected,
                                               FaultPlan, PreemptionHandler,
                                               faults)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = ["--device", "cpu", "--arch", "bert_tiny", "--batch-size", "2",
      "--seq-len", "8", "--steps-per-epoch", "4", "--print-freq", "4",
      "--opt", "lamb", "--lr", "1e-2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as the other port tests: the drills' steps stay
    quick beside the suite's other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _main(argv):
    with contextlib.redirect_stdout(io.StringIO()):
        return train.main(argv)


def _records(path):
    lint = subprocess.run(
        [sys.executable, "tools/metrics_lint.py", str(path),
         "--require-summary"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert lint.returncode == 0, lint.stdout + lint.stderr
    return [json.loads(ln) for ln in open(path)]


def _losses(records):
    return {r["step"]: r["loss"] for r in records if r["record"] == "step"}


def test_fault_plan_equals_jax(monkeypatch):
    for spec in ("crash@3", "sigterm@1", "hang@12", "nan@2"):
        ours, theirs = FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
        assert (ours.kind, ours.step, repr(ours)) \
            == (theirs.kind, theirs.step, repr(theirs))
    for spec in ("crash", "@3", "crash@", "boom@3", "crash@x", "crash@0",
                 "slot_fail@2"):
        with pytest.raises(ValueError) as ours:
            FaultPlan.parse(spec)
        with pytest.raises(ValueError) as theirs:
            jfaults.FaultPlan.parse(spec, kinds=jfaults.KINDS)
        assert str(ours.value) == str(theirs.value), spec
    assert faults.KINDS == jfaults.KINDS

    plan = FaultPlan("crash", 3)
    plan.maybe_fire(2)
    with pytest.raises(FaultInjected, match="injected crash at step 3"):
        plan.maybe_fire(3)
    plan.maybe_fire(3)                               # once
    kills, naps = [], []
    monkeypatch.setattr(os, "kill", lambda pid, sig: kills.append(sig))
    monkeypatch.setattr(time, "sleep", naps.append)
    FaultPlan("sigterm", 2).maybe_fire(2)
    monkeypatch.setattr(faults, "HANG_SECONDS", 2.5)
    plan = FaultPlan("hang", 1)
    monkeypatch.setattr(faults, "HANG_SECONDS", 99.0)
    plan.maybe_fire(1)
    assert kills == [signal.SIGTERM] and naps == [2.5]

    rs = np.random.RandomState(0)
    images, labels = rs.randn(2, 4, 4, 3).astype(np.float32), \
        np.arange(2, dtype=np.int32)
    ids, weights = np.ones((2, 5), np.int32), np.ones((2, 5), np.float32)
    for batch in ((images, labels), (ids, (labels, weights))):
        port = FaultPlan("nan", 2).maybe_poison(2, jax_to_torch(batch))
        jax_b = jfaults.FaultPlan("nan", 2).maybe_poison(
            2, jax_tree(batch))
        flat_p, flat_j = flatten(port), flatten(jax_b)
        for p, j in zip(flat_p, flat_j):
            np.testing.assert_array_equal(p.numpy(), np.asarray(j))
        assert any(np.isnan(p.numpy()).all() for p in flat_p)
    plan = FaultPlan("nan", 2)
    assert plan.maybe_poison(1, (torch.ones(2),))[0].isfinite().all()
    tokens = (torch.ones(2, 3, dtype=torch.int32),) * 2
    with pytest.raises(FaultInjected) as ours:
        FaultPlan("nan", 2).maybe_poison(2, tokens)
    with pytest.raises(jfaults.FaultInjected) as theirs:
        jfaults.FaultPlan("nan", 2).maybe_poison(
            2, (jnp.ones((2, 3), jnp.int32),) * 2)
    assert str(ours.value) == str(theirs.value)


def jax_to_torch(tree):
    if isinstance(tree, tuple):
        return tuple(jax_to_torch(t) for t in tree)
    return torch.from_numpy(tree)


def jax_tree(tree):
    if isinstance(tree, tuple):
        return tuple(jax_tree(t) for t in tree)
    return jnp.asarray(tree)


def flatten(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in flatten(t)]
    return [tree]


def test_preemption_handler_takes_sigterm_from_the_recorder(tmp_path):
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                               signal.SIGUSR1,
                                               signal.SIGINT)}
    for handler_mod in (jpreemption, None):
        sink = JsonlSink(str(tmp_path / f"{handler_mod is None}.jsonl"))
        recorder = FlightRecorder(TelemetryEmitter(sink, torch.device("cpu")),
                                  config={})
        recorder.install()
        handler = (PreemptionHandler(recorder=recorder) if handler_mod
                   is None else handler_mod.PreemptionHandler(
                       recorder=recorder))
        handler.install()
        assert handler.installed and not handler.preempted
        os.kill(os.getpid(), signal.SIGUSR1)
        os.kill(os.getpid(), signal.SIGTERM)         # ignored: flag set
        assert handler.preempted and handler.signal_name == "SIGUSR1"
        handler.close()
        recorder.close()
        sink.close()
        assert {s: signal.getsignal(s) for s in before} == before
        assert not os.path.exists(sink.path)         # no crash_dump


@pytest.mark.parametrize("save", [["--async-checkpoint"],
                                  ["--save-every-steps", "2"]])
def test_grace_exit_then_resume_continues_bitwise(tmp_path, save):
    full = tmp_path / "full.jsonl"
    assert _main(LM + ["--metrics-jsonl", str(full)]) == 0
    ck, first, second = tmp_path / "ck", tmp_path / "a.jsonl", \
        tmp_path / "b.jsonl"
    assert _main(LM + save + [
        "--metrics-jsonl", str(first), "--checkpoint-dir", str(ck),
        "--preempt-grace", "--flight-recorder",
        "--inject-fault", "sigterm@2"]) == EX_TEMPFAIL == 75
    records = _records(first)
    kinds = [r["record"] for r in records]
    assert kinds[-2:] == ["preemption", "run_summary"]
    assert "crash_dump" not in kinds and "aborted" not in records[-1]
    pre = records[-2]
    assert (pre["signal"], pre["step"], pre["saved"],
            pre["checkpoint_step"]) == ("SIGTERM", 2, True, 2)
    hs = json.load(open(ck / "host_state-2.json"))
    assert (hs["step"], hs["step_in_epoch"]) == (2, 2)
    assert sorted(os.listdir(ck)) == ["2", "host_state-2.json"]
    assert _main(LM + ["--metrics-jsonl", str(second), "--resume", str(ck),
                       "--checkpoint-dir", str(ck)]) == 0
    trail = {**_losses(records), **_losses(_records(second))}
    assert trail == _losses(_records(full))          # bitwise
    assert sorted(_losses(_records(second))) == [3, 4]


def test_crash_drill_writes_forensics(tmp_path):
    stream = tmp_path / "c.jsonl"
    with pytest.raises(FaultInjected, match="injected crash at step 2"):
        _main(LM + ["--metrics-jsonl", str(stream), "--flight-recorder",
                    "--inject-fault", "crash@2"])
    records = _records(stream)
    assert [r["record"] for r in records] == [
        "run_header", "step", "step", "crash_dump", "run_summary"]
    dump = records[3]
    assert dump["reason"] == "exception:FaultInjected"
    assert "FaultInjected: injected crash at step 2" in dump["traceback"]
    assert [r["step"] for r in dump["last_steps"]] == [1, 2]
    assert dump["step"] == 2 and dump["env"]["torch"] == torch.__version__
    assert dump["run_id"] == records[0]["run_id"]
    assert records[-1]["aborted"] is True
    assert records[-1]["abort_reason"] == "exception:FaultInjected"
    assert sys.excepthook is sys.__excepthook__     # disarmed


def _cli(*argv):
    return [sys.executable, "-m", "apex_example_tpu_torch.train"] + LM + \
        list(argv)


def test_sigterm_without_grace_exits_143_with_a_crash_dump(tmp_path):
    stream = tmp_path / "t.jsonl"
    proc = subprocess.run(
        _cli("--metrics-jsonl", str(stream), "--flight-recorder",
             "--inject-fault", "sigterm@2"),
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == -signal.SIGTERM, proc.stderr   # 143 in a shell
    records = _records(stream)
    dump = next(r for r in records if r["record"] == "crash_dump")
    assert dump["reason"] == "signal:SIGTERM" and dump["step"] == 2
    assert "maybe_fire" in dump["thread_stacks"]
    assert records[-1]["aborted"] is True


def test_supervise_restarts_the_port_trainer_once(tmp_path):
    sup, child, ck = (tmp_path / "sup.jsonl", tmp_path / "child.jsonl",
                      tmp_path / "ck")
    proc = subprocess.run(
        [sys.executable, "tools/supervise.py", "--metrics-jsonl", str(sup),
         "--max-restarts", "2", "--backoff", "0.1", "--"] + _cli(
            "--metrics-jsonl", str(child), "--checkpoint-dir", str(ck),
            "--preempt-grace", "--inject-fault", "sigterm@2"),
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    records = _records(sup)
    assert [r["record"] for r in records] == [
        "run_header", "restart", "resume", "run_summary"]
    restart, resume = records[1], records[2]
    assert (restart["exit_code"], restart["reason"],
            restart["classification"], restart["last_step"],
            restart["checkpoint_step"]) == (75, "preemption", "preempted",
                                            2, 2)
    assert (resume["attempt"], resume["checkpoint_step"]) == (1, 2)
    assert records[-1]["restart_count"] == 1 and records[-1]["exit_code"] == 0
    first = _records(child)
    again = _records(str(child) + ".attempt1")
    assert next(r for r in first if r["record"] == "preemption")["saved"]
    assert sorted(_losses(first)) == [1, 2]
    assert sorted(_losses(again)) == [3, 4]
    assert again[-1]["record"] == "run_summary" and "aborted" not in again[-1]
    assert jobs.read_jsonl(str(sup))[0]["config"]["checkpoint_dir"] \
        == str(ck)
