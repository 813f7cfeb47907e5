"""Per-step telemetry of the training loop: port of ``TelemetryEmitter``
(:58) of apex_example_tpu/obs/telemetry.py.

Writes ``run_header`` (:99), one ``step`` record per step (:119) and a
closing ``run_summary`` (:170) to the port's JsonlSink, with schema 18 and
only fields that apex_example_tpu/obs/schema.py declares, so
tools/metrics_lint.py and tools/telemetry_report.py read the stream as
they read the JAX package's.  ``platform`` is "gpu" or "cpu";
``memory`` comes from ``torch.cuda.memory_stats`` on the card.

Fetching the step's metrics to Python floats waits for the device, so
``step_time_ms``, measured after the fetch, covers the device's work.
The first step's time includes one-off work (the kernels' build and load,
the allocator's growth); ``compile_est_ms`` is its excess over the median.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from apex_example_tpu_torch.obs.metrics import SCHEMA_VERSION, JsonlSink

# torch.cuda.memory_stats keys -> the JAX stream's memory keys
_MEMORY_KEYS = {"allocated_bytes.all.current": "bytes_in_use",
                "allocated_bytes.all.peak": "peak_bytes_in_use"}


def device_memory_stats(device: torch.device) -> Optional[Dict[str, int]]:
    """The card's allocator counters, or None on the CPU."""
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    out = {name: int(stats[key]) for key, name in _MEMORY_KEYS.items()
           if key in stats}
    out["bytes_limit"] = int(torch.cuda.get_device_properties(
        device).total_memory)
    return out


def _scalar_metrics(metrics: Dict[str, Any]) -> Dict[str, float]:
    """Every scalar of a step's metrics as a Python float (a device sync
    for the tensors among them)."""
    out = {}
    for key, value in metrics.items():
        try:
            out[key] = float(value)
        except (TypeError, ValueError, RuntimeError):
            continue
    return out


class TelemetryEmitter:
    """run_header / step / run_summary records to a JsonlSink."""

    def __init__(self, sink: JsonlSink, device: torch.device,
                 memory_every: int = 10):
        self.sink = sink
        self.device = device
        self.memory_every = memory_every
        self.run_id = uuid.uuid4().hex[:12]
        self._step_times_ms: List[float] = []
        self._overflows = 0
        self._steps = 0
        self._items = 0
        self._t_run0 = time.perf_counter()
        self._closed = False

    def run_header(self, config: Dict[str, Any],
                   argv: Optional[list] = None, **extra) -> Dict[str, Any]:
        cuda = self.device.type == "cuda"
        world = dist.get_world_size() if dist.is_initialized() else 1
        rec: Dict[str, Any] = {
            "record": "run_header",
            "schema": SCHEMA_VERSION,
            "time": time.time(),
            "run_id": self.run_id,
            "num_devices": torch.cuda.device_count() if cuda else 1,
            "num_processes": world,
            "process_index": self.sink.rank,
            "platform": "gpu" if cuda else "cpu",
            "config": {k: v for k, v in config.items()
                       if isinstance(v, (str, int, float, bool, type(None)))},
        }
        if argv is not None:
            rec["argv"] = [str(a) for a in argv]
        rec.update(extra)
        self.sink.write(rec)
        return rec

    def on_step(self, *, global_step: int, epoch: int,
                metrics: Dict[str, Any], items: int,
                t_start: float) -> Dict[str, Any]:
        """Fetch, record, emit one step; ``t_start`` is the perf_counter
        taken just before the step was issued."""
        values = _scalar_metrics(metrics)
        elapsed_ms = (time.perf_counter() - t_start) * 1e3
        self._steps += 1
        self._items += items
        self._step_times_ms.append(elapsed_ms)
        if values.get("grads_finite", 1.0) < 1.0:
            self._overflows += 1
        rec: Dict[str, Any] = {
            "record": "step",
            "time": time.time(),
            "step": int(global_step),
            "epoch": int(epoch),
            "step_time_ms": round(elapsed_ms, 3),
            "items_per_sec": round(items / max(elapsed_ms / 1e3, 1e-9), 1),
            "overflow_count": self._overflows,
            "loss": values.get("loss", 0.0),
            "scale": values.get("scale", 1.0),
        }
        for key in ("grad_norm", "grads_finite", "top1", "ppl", "lr"):
            if key in values:
                rec[key] = values[key]
        if self.memory_every and (self._steps - 1) % self.memory_every == 0:
            mem = device_memory_stats(self.device)
            if mem:
                rec["memory"] = mem
        self.sink.write(rec)
        return rec

    def summary(self) -> Dict[str, Any]:
        rec: Dict[str, Any] = {
            "record": "run_summary",
            "time": time.time(),
            "steps": self._steps,
            "overflow_count": self._overflows,
        }
        if self._step_times_ms:
            first = self._step_times_ms[0]
            rec["first_step_ms"] = round(first, 3)
            rest = sorted(self._step_times_ms[1:])
            if rest:
                steady = rest[len(rest) // 2]
                rec["steady_step_ms"] = round(steady, 3)
                rec["compile_est_ms"] = round(max(first - steady, 0.0), 3)
            wall_s = time.perf_counter() - self._t_run0
            rec["items_per_sec"] = round(self._items / max(wall_s, 1e-9), 1)
        return rec

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._steps:
            self.sink.write(self.summary())
        self.sink.close()
