"""Hot-path overhead attribution of the training loop: port of
apex_example_tpu/obs/tickprof.py (``TickProfiler`` :107) for the train
kind only, standard library only.

``--tick-profile`` splits every step of the image loop into five phases
(``TRAIN_PHASES``)::

    data_wait   the batch: made on the card, or the host pipeline's next
    dispatch    the train step's call up to its return (PyTorch queues
                the kernels and returns before the card has run them)
    device      a ``torch.cuda.synchronize`` the loop inserts only when
                the flag is armed: the card's remaining work (on the CPU
                the step ran inside dispatch, and this reads about 0)
    telemetry   the step record (its metric fetch) and printing
    checkpoint  the --save-every-steps window (0.0 when it skips)

and folds each into a log-bucket quantile sketch.  The caller measures
the step's wall time with one perf_counter pair and passes the phases
it timed between contiguous boundaries, so they telescope to the wall
(``tools/perf_ledger.py`` checks agreement within 1%).

Records, the JAX package's (schema v15): a ``tick_profile`` every
``sample_every``-th step (per-phase ms, the wall and its ``host_gap_ms``,
wall minus the device phase, with a perf_counter ``ts``) and one closing
``overhead_summary`` (per-phase totals and sketch summaries, the
cumulative ``host_gap_ms`` and ``host_overhead_frac`` = host gap / wall).

The sketch helpers below are a copy of ``sketch_new``, ``sketch_add``
and ``sketch_summary`` of apex_example_tpu/obs/slo.py (:66-135).
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, Optional

DEFAULT_ALPHA = 0.01
KIND = "train"            # the records' kind: the port profiles training

TRAIN_PHASES = ("data_wait", "dispatch", "device", "checkpoint",
                "telemetry")
# The phase whose time is the card's; the others are host overhead.
DEVICE_PHASE = "device"

DEFAULT_SAMPLE_EVERY = 16


def _gamma(alpha: float) -> float:
    return (1.0 + alpha) / (1.0 - alpha)


def sketch_new() -> Dict[str, Any]:
    """A fresh empty sketch (the JSON-native dict form), of relative
    error DEFAULT_ALPHA."""
    return {"alpha": DEFAULT_ALPHA, "count": 0, "zero": 0, "buckets": {},
            "min": None, "max": None}


def sketch_add(sk: Dict[str, Any], value) -> Dict[str, Any]:
    """Fold one observation of ``value`` into ``sk`` (in place)."""
    v = float(value)
    sk["count"] += 1
    sk["min"] = v if sk["min"] is None else min(sk["min"], v)
    sk["max"] = v if sk["max"] is None else max(sk["max"], v)
    if v <= 0.0:
        sk["zero"] += 1
        return sk
    idx = math.ceil(math.log(v) / math.log(_gamma(sk["alpha"])))
    key = str(idx)
    sk["buckets"][key] = sk["buckets"].get(key, 0) + 1
    return sk


def sketch_percentile(sk: Dict[str, Any], q: float) -> float:
    """Nearest-rank percentile estimate: the bucket holding the
    ``ceil(q/100 * n)``-th observation at its log-midpoint, within
    relative error ``alpha``; 0.0 when empty or inside the zero bucket."""
    n = sk["count"]
    if n == 0:
        return 0.0
    rank = min(max(math.ceil(q / 100.0 * n), 1), n)
    if rank <= sk["zero"]:
        return 0.0
    seen = sk["zero"]
    g = _gamma(sk["alpha"])
    for idx in sorted(int(k) for k in sk["buckets"]):
        seen += sk["buckets"][str(idx)]
        if seen >= rank:
            return 2.0 * (g ** idx) / (g + 1.0)
    return sk["max"] if sk["max"] is not None else 0.0


def sketch_summary(sk: Dict[str, Any]) -> Dict[str, Any]:
    """The percentile dict the records embed (JSON-safe)."""
    return {"count": sk["count"],
            "p50": sketch_percentile(sk, 50),
            "p90": sketch_percentile(sk, 90),
            "p99": sketch_percentile(sk, 99),
            "min": sk["min"] if sk["min"] is not None else 0.0,
            "max": sk["max"] if sk["max"] is not None else 0.0}


class TickProfiler:
    """Per-step phase accounting and cumulative sketches.

    ``observe_tick(ts, wall_ms, **phase_ms)`` folds one step; every
    ``sample_every``-th call emits a ``tick_profile`` record through
    ``emit`` (a JsonlSink's ``write``, or None).  ``summary_record()``
    builds the closing ``overhead_summary``."""

    def __init__(self, sample_every: int = DEFAULT_SAMPLE_EVERY,
                 emit: Optional[Callable[[Dict[str, Any]], Any]] = None,
                 run_id: Optional[str] = None):
        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1, "
                             f"got {sample_every}")
        self.phases = TRAIN_PHASES
        self.sample_every = int(sample_every)
        self.emit = emit
        self.run_id = run_id
        self.ticks = 0
        self.sampled = 0
        self.wall_ms = 0.0
        self._totals = {p: 0.0 for p in self.phases}
        self._sk = {p: sketch_new() for p in self.phases}
        self._wall_sk = sketch_new()
        self._gap_sk = sketch_new()

    def observe_tick(self, ts: float, wall_ms: float,
                     **phase_ms: float) -> Optional[Dict[str, Any]]:
        """Fold one step.  ``ts``: perf_counter at its start; ``wall_ms``:
        its wall time, measured on its own; keyword arguments: per-phase
        ms (a missing phase counts 0.0, an unknown one raises).  Returns
        the ``tick_profile`` record on sampled steps, else None."""
        unknown = set(phase_ms) - set(self.phases)
        if unknown:
            raise ValueError(f"unknown phase(s) {sorted(unknown)}; "
                             f"{KIND} phases are {self.phases}")
        wall = float(wall_ms)
        self.wall_ms += wall
        sketch_add(self._wall_sk, wall)
        tick_phases: Dict[str, float] = {}
        for p in self.phases:
            v = float(phase_ms.get(p, 0.0))
            tick_phases[p] = v
            self._totals[p] += v
            sketch_add(self._sk[p], v)
        gap = wall - tick_phases[DEVICE_PHASE]
        sketch_add(self._gap_sk, gap)
        tick = self.ticks
        self.ticks += 1
        if self.emit is None or tick % self.sample_every:
            return None
        self.sampled += 1
        rec = {
            "record": "tick_profile",
            "time": time.time(),
            "ts": float(ts),
            "kind": KIND,
            "tick": tick,
            "wall_ms": wall,
            "host_gap_ms": gap,
            "phases": tick_phases,
        }
        if self.run_id is not None:
            rec["run_id"] = self.run_id
        self.emit(rec)
        return rec

    def device_ms(self) -> float:
        """Cumulative device-phase ms."""
        return self._totals[DEVICE_PHASE]

    def host_gap_ms(self) -> float:
        """Cumulative wall minus device-phase ms."""
        return self.wall_ms - self.device_ms()

    def host_overhead_frac(self) -> float:
        """host_gap / wall over the run (0.0 before any step)."""
        if self.wall_ms <= 0.0:
            return 0.0
        return self.host_gap_ms() / self.wall_ms

    def phase_summary(self) -> Dict[str, Dict[str, Any]]:
        """phase -> sketch summary and its cumulative ``total_ms``."""
        out: Dict[str, Dict[str, Any]] = {}
        for p in self.phases:
            s = sketch_summary(self._sk[p])
            s["total_ms"] = self._totals[p]
            out[p] = s
        return out

    def summary_record(self) -> Dict[str, Any]:
        """The closing ``overhead_summary`` record."""
        rec = {
            "record": "overhead_summary",
            "time": time.time(),
            "kind": KIND,
            "ticks": self.ticks,
            "wall_ms": self.wall_ms,
            "device_ms": self.device_ms(),
            "host_gap_ms": self.host_gap_ms(),
            "host_overhead_frac": self.host_overhead_frac(),
            "phases": self.phase_summary(),
            "sample_every": self.sample_every,
            "sampled": self.sampled,
            "wall": sketch_summary(self._wall_sk),
            "host_gap": sketch_summary(self._gap_sk),
        }
        if self.run_id is not None:
            rec["run_id"] = self.run_id
        return rec
