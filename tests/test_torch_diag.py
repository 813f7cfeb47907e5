"""The port's diagnostics held against the JAX package's, on the CPU.

- Records and parses equal JAX's for the same inputs (both sides pure
  standard library): the Tracer's ``trace_event`` / ``clock_sync`` records
  (the clock anchor's own readings aside), the TickProfiler's
  ``tick_profile`` and ``overhead_summary`` records (``time`` aside).
- ``module_grad_stats`` on the same grads: a flax tree of numpy arrays
  (``jax.eval_shape`` of the init, no model init) with infs and NaNs
  planted, through JAX's function and, converted to the port's names
  (``convert.*_params_from_flax``) and mapped back to modules
  (``convert.flax_module_name``), through the port's: the same modules,
  counts exact, norms rtol 1e-6 (fp32 sums in another order); the port
  model's own parameter names map onto the same modules.
- ``utils/flops``: every arch the trainer builds, equal to JAX's to the
  last bit (the same closed forms over the port's modules), the card's
  peaks, an unknown card refused.
- ``--tensorboard``: the port's standard-library event file, read back by
  the ``tensorboard`` package, holds the tags, steps and values that JAX's
  TensorBoardAdapter hands its writer for the same scalars (a recording
  writer on the JAX side); CRC-32C on its check value.
- The trainer's drills, ``train.main`` in this process at the smallest
  sizes (ResNet-18 at 4 filters, bert_tiny): the numerics drill
  (``--inject-fault nan@2`` under dynamic scaling) writes one
  overflow_event naming JAX's modules, reads the stats on that step only,
  skips the step and recovers on the next (a NaN running mean no longer
  poisons the composite BatchNorm, ROADMAP C); a run with the diagnostics
  armed closes clean (``always``: each step's module norms make its grad
  norm; no crash_dump, no stall; the tick phases sum to the wall within
  1%; its spans and the profile window's phase ranges nest under
  ``step``; tools/trace_export.py, telemetry_report.py and
  fleet_report.py read the stream); a hang under ``--stall-timeout``
  writes one stall record with the stacks and a trace; the refusals carry
  JAX's messages.  Every stream passes ``tools/metrics_lint.py
  --require-summary``.
"""

import contextlib
import functools
import io
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train as jax_train
from apex_example_tpu import obs as jobs
from apex_example_tpu.models import bert as jbert
from apex_example_tpu.models import gpt as jgpt
from apex_example_tpu.models import resnet as jresnet
from apex_example_tpu.models import transformer_xl as jtxl
from apex_example_tpu.obs import tickprof as jtickprof
from apex_example_tpu.obs import trace as jtrace
from apex_example_tpu.utils import flops as jflops
from apex_example_tpu_torch import train
from apex_example_tpu_torch.convert import (bert_params_from_flax,
                                            flax_module_name,
                                            resnet_params_from_flax)
from apex_example_tpu_torch.models import bert as pbert
from apex_example_tpu_torch.models import gpt as pgpt
from apex_example_tpu_torch.models import transformer_xl as ptxl
from apex_example_tpu_torch.models.resnet import ARCHS as PORT_RESNETS
from apex_example_tpu_torch.obs import metrics, tickprof, trace
from apex_example_tpu_torch.obs import profiler as port_profiler
from apex_example_tpu_torch.obs import numerics
from apex_example_tpu_torch.obs.numerics import module_grad_stats
from apex_example_tpu_torch.resilience import faults
from apex_example_tpu_torch.utils import flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE = ["--device", "cpu", "--arch", "resnet18", "--batch-size", "2",
         "--steps-per-epoch", "3", "--print-freq", "1", "--lr", "0.01"]
LM = ["--device", "cpu", "--arch", "bert_tiny", "--batch-size", "2",
      "--seq-len", "8", "--steps-per-epoch", "3", "--print-freq", "3",
      "--opt", "lamb", "--lr", "1e-2"]


@pytest.fixture(autouse=True)
def _small(tmp_path, monkeypatch):
    """Traces into tmp_path; the CLI's ResNet-18 at 4 filters (its modules
    and names are the 64-filter one's)."""
    monkeypatch.setattr(port_profiler, "DEFAULT_TRACE_DIR",
                        str(tmp_path / "trace"))
    monkeypatch.setitem(train.IMAGE_ARCHS, "resnet18", functools.partial(
        PORT_RESNETS["resnet18"], num_filters=4))


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
    records = [json.loads(ln) for ln in open(path)]
    lint = subprocess.run(
        [sys.executable, "tools/metrics_lint.py", str(path),
         "--require-summary"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert lint.returncode == 0, lint.stdout + lint.stderr
    return records


def _kinds(records):
    return [r["record"] for r in records]


class _List(list):
    write = list.append


def test_tracer_and_tick_profiler_records_equal_jax(monkeypatch):
    def events(mod):
        sink = _List()
        tr = mod.Tracer(sink, run_id="r1")
        sid = tr.begin("tick", ts=1.0, args={"n": 1})
        tr.complete("data", 1.0, 0.25, cat="span", tid="MainThread",
                    parent_id=sid)
        tr.complete("late", 2.0, -1.0)              # clamped to 0
        tr.instant("mark", ts=1.5, cat="x")
        tr.end("tick", ts=2.0)
        with pytest.raises(ValueError, match="ph must be"):
            tr.event("Q", "bad")
        for rec in sink:
            if rec["record"] == "clock_sync":       # readings of the clock
                rec.pop("time"), rec.pop("ts")
        return sink, tr.events

    monkeypatch.setenv(trace.TRACE_ID_ENV, "t-parent")
    assert events(trace) == events(jtrace)
    assert events(trace)[0][0]["trace_id"] == "t-parent"

    walls = [10.0, 12.5, 0.0, 7.25, 30.0]
    phases = [dict(data_wait=1.0, dispatch=2.0, device=6.0, telemetry=1.0),
              dict(data_wait=0.5, dispatch=2.0, device=9.0, telemetry=0.5,
                   checkpoint=0.5),
              {}, dict(device=7.25), dict(dispatch=29.0, telemetry=1.0)]

    def profile(mod):
        out = _List()
        kind = {} if mod is tickprof else {"kind": "train"}
        tp = mod.TickProfiler(sample_every=2, emit=out.write, run_id="r",
                              **kind)
        for i, (wall, ph) in enumerate(zip(walls, phases)):
            tp.observe_tick(float(i), wall, **ph)
        with pytest.raises(ValueError, match="unknown phase"):
            tp.observe_tick(9.0, 1.0, admit=1.0)
        out.append(tp.summary_record())
        for rec in out:
            rec.pop("time")
        return out, tp.host_overhead_frac()

    assert profile(tickprof) == profile(jtickprof)
    with pytest.raises(ValueError):
        tickprof.TickProfiler(sample_every=0)


def _flax_tree(arch):
    """(flax params of numpy arrays with planted non-finites, the port
    converter, the port model of the same shapes)."""
    if arch == "resnet18":
        jm = jresnet.resnet18(num_classes=10, num_filters=4)
        sample, convert = jnp.zeros((1, 16, 16, 3)), resnet_params_from_flax
        port = PORT_RESNETS["resnet18"](num_classes=10, num_filters=4,
                                        device="cpu")
        kw = {"train": False}
    else:
        jm = jbert.bert_tiny()
        sample, convert = jnp.zeros((1, 8), jnp.int32), bert_params_from_flax
        port = pbert.bert_tiny(device="cpu")
        kw = {}
    tree = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), sample,
                                          **kw))["params"]
    rs = np.random.RandomState(0)
    tree = jax.tree_util.tree_map(
        lambda leaf: rs.randn(*leaf.shape).astype(np.float32), tree)
    leaves = jax.tree_util.tree_leaves(tree)
    leaves[0].reshape(-1)[1] = np.inf                   # first module
    leaves[len(leaves) // 2].reshape(-1)[:3] = np.nan   # a middle one
    leaves[-1].reshape(-1)[0] = -np.inf                 # the last module
    leaves[-1].reshape(-1)[-1] = np.nan
    return tree, convert, port


def test_module_grad_stats_match_jax_and_name_its_modules():
    for arch in ("resnet18", "bert_tiny"):
        tree, convert, port = _flax_tree(arch)
        want = {name: (int(s["nonfinite"]), float(s["grad_norm"]))
                for name, s in jax.jit(jobs.module_grad_stats)(
                    tree).items()}
        got = module_grad_stats(
            (flax_module_name(name), t)
            for name, t in convert(tree).items())
        assert sorted(got) == sorted(want) == sorted(tree), arch
        assert sum(s["nonfinite"] > 0 for s in got.values()) >= 2, arch
        for name, (count, norm) in want.items():
            assert got[name]["nonfinite"] == count, (arch, name)
            np.testing.assert_allclose(got[name]["grad_norm"], norm,
                                       rtol=1e-6, err_msg=name)
        assert {flax_module_name(n) for n, _ in port.named_parameters()} \
            == set(tree), arch


def test_flops_equal_jax_for_every_arch(monkeypatch):
    for arch in ("resnet18", "resnet34", "resnet50", "resnet101",
                 "resnet152"):
        for size, classes in ((32, 10), (224, 1000)):
            assert flops.resnet_train_flops_per_image(arch, size, classes) \
                == jflops.resnet_train_flops_per_image(arch, size, classes)
    # the base models' structure without their init (what flops reads)
    monkeypatch.setattr(pbert, "init_bert_weights", lambda m, s: None)
    monkeypatch.setattr(pgpt, "_init_weights", lambda m, s: None)
    monkeypatch.setattr(ptxl, "init_txl_weights", lambda m, s: None)
    pairs = [(pbert.bert_tiny, jbert.bert_tiny), (pbert.bert_base,
                                                  jbert.bert_base),
             (pgpt.gpt_tiny, jgpt.gpt_tiny), (pgpt.gpt_base, jgpt.gpt_base),
             (ptxl.transformer_xl_tiny, jtxl.transformer_xl_tiny),
             (ptxl.transformer_xl_base, jtxl.transformer_xl_base)]
    for port_arch, jax_arch in pairs:
        pm, jm = port_arch(device="cpu"), jax_arch()
        for seq in (16, 128, 2048):
            assert flops.model_train_flops_per_token(pm, seq) \
                == jflops.model_train_flops_per_token(jm, seq)
        del pm
    assert flops.peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert flops.peak_flops("NVIDIA H100 80GB HBM3", torch.float16) \
        == 989.4e12
    assert flops.peak_flops("NVIDIA H100 80GB HBM3", torch.float32) \
        == 66.9e12
    with pytest.raises(ValueError, match="no peak"):
        flops.peak_flops("NVIDIA A100-SXM4-80GB")
    assert flops.mfu_pct(1000.0, 3e9, 989.4e12) \
        == jflops.mfu_pct(1000.0, 3e9, peak_flops=989.4e12)


def test_tensorboard_event_file_holds_jax_scalars(tmp_path):
    assert metrics.crc32c(b"123456789") == 0xE3069283      # the check value

    class Recording:
        calls = []

        def add_scalar(self, tag, value, step):
            self.calls.append((tag, value, step))

        def close(self):
            pass

    scalars = [({"train/loss": 2.5, "train/top1": 12.5,
                 "train/img_per_sec": 1234.5678}, 10),
               ({"train/loss": 1.875, "train/top1": 25.0,
                 "train/img_per_sec": 2048.0}, 20),
               ({"eval/loss": 1.5, "eval/top1": 30.0, "eval/top5": 70.0},
                20)]
    jax_writer = Recording()
    jax_tb = jobs.TensorBoardAdapter(jax_writer)
    port_tb = metrics.TensorBoardAdapter(
        metrics.EventFileWriter(str(tmp_path / "tb")))
    for values, step in scalars:
        jax_tb.scalars(values, step)
        port_tb.scalars(values, step)
    port_tb.close()
    metrics.TensorBoardAdapter(None).scalars({"x": 1.0}, 1)   # no writer
    read = subprocess.run([sys.executable, "-c", (
        "import json, sys, types\n"
        "sys.modules['tensorboard.compat.notf'] = "
        "types.ModuleType('notf')\n"
        "from tensorboard.backend.event_processing.event_accumulator "
        "import EventAccumulator\n"
        "ea = EventAccumulator(sys.argv[1]); ea.Reload()\n"
        "print(json.dumps({t: [[e.step, e.value] for e in ea.Scalars(t)] "
        "for t in ea.Tags()['scalars']}))\n"), str(tmp_path / "tb")],
        capture_output=True, text=True, timeout=120)
    assert read.returncode == 0, read.stderr
    got = json.loads(read.stdout.splitlines()[-1])
    want = {}
    for tag, value, step in jax_writer.calls:
        want.setdefault(tag, []).append([step, float(np.float32(value))])
    assert got == want


def test_numerics_drill_names_jax_modules_and_skips_the_step(tmp_path,
                                                            monkeypatch):
    stream, ck = tmp_path / "n.jsonl", tmp_path / "ck"
    stats, reads = numerics.optimizer_grad_stats, []

    def counted(*args):               # the stats: read on step 2 only
        reads.append(args)
        return stats(*args)

    monkeypatch.setattr(numerics, "optimizer_grad_stats", counted)
    assert _main(IMAGE + [
        "--loss-scale", "dynamic", "--numerics-check", "overflow",
        "--inject-fault", "nan@2", "--metrics-jsonl", str(stream),
        "--checkpoint-dir", str(ck), "--save-every-steps", "1"]) == 0
    records = _records(stream)
    events = [r for r in records if r["record"] == "overflow_event"]
    steps = [r for r in records if r["record"] == "step"]
    assert [e["step"] for e in events] == [2] and len(reads) == 1
    jm = jresnet.resnet18(num_classes=10)
    modules = sorted(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        train=False))["params"])
    assert events[0]["modules"] == modules     # a NaN batch reaches all
    assert events[0]["mode"] == "overflow"
    assert all(s["nonfinite"] > 0 for s in events[0]["module_stats"].values())
    assert [s["grads_finite"] for s in steps] == [1.0, 0.0, 1.0]
    assert [s["scale"] for s in steps] == [65536.0, 32768.0, 32768.0]
    assert math.isnan(steps[1]["loss"]) and math.isfinite(steps[2]["loss"])
    # skipped: step 2's parameters and momenta are step 1's, bitwise
    at = {s: torch.load(ck / str(s) / f"{part}.pt") for s in (1, 2)
          for part in ("model",)}
    opt = [torch.load(ck / str(s) / "optimizer.pt") for s in (1, 2)]
    for name, t in at[1].items():
        if name.endswith(("mean", "var")):             # not rolled back
            continue
        assert torch.equal(t, at[2][name]), name
    for a, b in zip(opt[0]["momentum_buffer"], opt[1]["momentum_buffer"]):
        assert torch.equal(a, b)


def test_clean_run_with_diagnostics_armed(tmp_path):
    stream = tmp_path / "c.jsonl"
    assert _main(IMAGE + [
        "--metrics-jsonl", str(stream), "--trace", "--tick-profile",
        "--tick-profile-every", "1", "--profile-window", "2:3",
        "--flight-recorder", "--stall-timeout", "60",
        "--numerics-check", "always"]) == 0
    records = _records(stream)
    kinds = _kinds(records)
    assert "crash_dump" not in kinds and "stall" not in kinds
    assert kinds.count("overflow_event") == 3       # always: every step
    # the stats are of the grads the step took: their norm is the step's
    for event, step in zip(*([r for r in records if r["record"] == kind]
                             for kind in ("overflow_event", "step"))):
        assert event["step"] == step["step"] and event["modules"] == []
        norm = math.sqrt(sum(m["grad_norm"] ** 2
                             for m in event["module_stats"].values()))
        assert norm == pytest.approx(step["grad_norm"], rel=1e-5)
    ticks = [r for r in records if r["record"] == "tick_profile"]
    assert len(ticks) == 3
    for t in ticks:
        assert abs(sum(t["phases"].values()) - t["wall_ms"]) \
            <= 0.01 * t["wall_ms"]
    summary = next(r for r in records if r["record"] == "overhead_summary")
    total = sum(p["total_ms"] for p in summary["phases"].values())
    assert abs(total - summary["wall_ms"]) <= 0.01 * summary["wall_ms"]
    assert summary["ticks"] == 3 and kinds.index("overhead_summary") \
        < kinds.index("run_summary")
    spans = [r for r in records if r["record"] == "trace_event"]
    assert [s["name"] for s in spans] == ["data", "step"] * 3
    assert all("parent_id" not in s for s in spans)
    assert all(a["ts"] + a["dur"] <= b["ts"] for a, b in zip(spans,
                                                              spans[1:]))
    assert set(records[-1]["spans"]) == {"span.data", "span.step"}
    for tool in (["trace_export.py", "--check"], ["telemetry_report.py"],
                 ["fleet_report.py"]):           # the JAX package's tools
        proc = subprocess.run(
            [sys.executable, os.path.join("tools", tool[0]), str(stream)]
            + tool[1:], cwd=REPO, capture_output=True, text=True,
            timeout=120)
        assert proc.returncode == 0, (tool, proc.stdout + proc.stderr)
    # the window's trace: steps 2 and 3, their phases inside "step"
    (path,) = (tmp_path / "trace").glob("window_2_3.*.pt.trace.json")
    events = [e for e in json.load(open(path))["traceEvents"]
              if e.get("ph") == "X"]
    step_ranges = [e for e in events if e["name"] == "step"]
    assert len(step_ranges) == 2
    for phase in ("fwd_bwd", "unscale_check", "optimizer"):
        ranges = [e for e in events if e["name"] == phase]
        assert len(ranges) == 2, phase
        assert all(any(s["ts"] <= e["ts"] and e["ts"] + e["dur"]
                       <= s["ts"] + s["dur"] for s in step_ranges)
                   for e in ranges), phase


def test_hang_under_the_stall_watchdog(tmp_path, monkeypatch):
    assert _main(LM + ["--steps-per-epoch", "1"]) == 0   # one-off init
    monkeypatch.setattr(faults, "HANG_SECONDS", 2.5)
    stream = tmp_path / "h.jsonl"
    assert _main(LM + ["--metrics-jsonl", str(stream), "--inject-fault",
                       "hang@2", "--stall-timeout", "1",
                       "--stall-trace"]) == 0
    records = _records(stream)
    stalls = [r for r in records if r["record"] == "stall"]
    assert len(stalls) == 1 and stalls[0]["step"] == 2
    assert stalls[0]["seconds_since_step"] >= 1.0
    assert "maybe_fire" in stalls[0]["thread_stacks"]
    assert stalls[0]["trace_dir"] == str(tmp_path / "trace")
    assert len(list((tmp_path / "trace").glob("stall.*.pt.trace.json"))) \
        == 1
    assert _kinds(records).count("step") == 3


REFUSALS = [
    ["--prof", "--profile-window", "1:2"],
    ["--flight-recorder"],
    ["--numerics-check", "always"],
    ["--trace"],
    ["--metrics-jsonl", "x.jsonl", "--stall-trace"],
    ["--inject-fault", "boom@2"],
    ["--inject-fault", "crash@x"],
    ["--inject-fault", "crash@0"],
    ["--metrics-jsonl", "x.jsonl", "--numerics-check", "overflow",
     "--arch", "transformer_xl_tiny"],
    ["--metrics-jsonl", "x.jsonl", "--profile-window", "3:2"],
]


def test_refusals_carry_jax_messages(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for argv in REFUSALS:
        with pytest.raises(SystemExit) as jax_exit:
            jax_train.main(argv)
        with pytest.raises(SystemExit) as port_exit:
            train.main(["--device", "cpu"] + argv)
        assert str(port_exit.value) == str(jax_exit.value), argv
        assert isinstance(port_exit.value.code, str), argv
    with pytest.raises(SystemExit, match="torch.profiler has no such "
                                         "server"):
        train.main(["--device", "cpu", "--prof-server", "9012"])
    with pytest.raises(SystemExit, match="^--tick-profile requires "
                                         "--metrics-jsonl"):
        _main(IMAGE + ["--tick-profile"])
    for argv in (["--cost-model"], ["--tensor-parallel", "2"]):
        with pytest.raises(SystemExit) as exc:       # argparse: not ported
            train.build_parser().parse_args(argv)
        assert exc.value.code == 2
    assert not os.listdir(tmp_path)                  # refused before a run
