"""Metrics pieces the serving engine uses: the port's copy of
``nearest_rank``, ``Histogram`` and ``JsonlSink`` from
apex_example_tpu/obs/metrics.py.

The port runs as one process, so the sink writes its one file and has no
rank logic.  Records follow the JSONL schema apex_example_tpu/obs/schema.py
declares (version ``SCHEMA_VERSION``), so tools/metrics_lint.py and
tools/serve_report.py read the port's streams as they are.
"""

from __future__ import annotations

import json
import math
import os
import threading
from typing import Any, Dict, List

SCHEMA_VERSION = 18


def nearest_rank(sorted_vals, q: float) -> float:
    """Nearest-rank percentile over a PRE-SORTED sequence: the
    ceil(q/100 * n)-th value (1-based), clamped."""
    if not sorted_vals:
        return 0.0
    idx = math.ceil(q / 100.0 * len(sorted_vals)) - 1
    return sorted_vals[min(max(idx, 0), len(sorted_vals) - 1)]


class Histogram:
    """Streaming distribution: exact count/sum/min/max plus a bounded
    sample for percentiles."""

    def __init__(self, name: str, max_samples: int = 4096):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._max_samples = max_samples
        self._samples: List[float] = []

    def observe(self, value) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        if len(self._samples) < self._max_samples:
            self._samples.append(value)
        else:
            # Bounded trailing window (ring buffer): percentiles reflect
            # the most recent max_samples observations; count/sum/min/max
            # stay exact over the full run.
            self._samples[self.count % self._max_samples] = value

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        return nearest_rank(sorted(self._samples), q)

    def summary(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0}
        return {"count": self.count, "mean": self.mean, "sum": self.sum,
                "min": self.min, "max": self.max, "p50": self.percentile(50),
                "p95": self.percentile(95)}


class JsonlSink:
    """JSONL writer, one file per run: one JSON object per line, flushed
    per record so a killed run keeps every record it emitted."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None                         # guarded-by: _lock
        self._opened = False                    # guarded-by: _lock
        self._lock = threading.RLock()
        self.records_written = 0                # guarded-by: _lock

    def write(self, record: Dict[str, Any]) -> bool:
        """Write one record.  The file is truncated at first open; a
        write after close() re-opens it in append mode."""
        with self._lock:
            if self._fh is None:
                parent = os.path.dirname(self.path)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                self._fh = open(self.path, "a" if self._opened else "w")
                self._opened = True
            self._fh.write(json.dumps(record, separators=(",", ":")) + "\n")
            self._fh.flush()
            self.records_written += 1
        return True

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
