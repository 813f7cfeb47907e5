"""Metrics pieces the serving engine uses: the port's copy of
``nearest_rank``, ``Histogram`` and ``JsonlSink`` from
apex_example_tpu/obs/metrics.py.

The sink follows the reference harness's logging rule: only rank 0 of the
process group writes, unless ``all_ranks``, when rank K > 0 writes its own
``PATH.rank<K>`` (the JAX sink's naming, :239-266); the rank is read from
torch.distributed at the first use.  Records follow the JSONL schema
apex_example_tpu/obs/schema.py declares (version ``SCHEMA_VERSION``), so
tools/metrics_lint.py and tools/serve_report.py read the port's streams as
they are.
"""

from __future__ import annotations

import json
import math
import os
import threading
from typing import Any, Dict, List, Optional

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
    """Rank-aware JSONL writer, one file per run: one JSON object per line,
    flushed per record so a killed run keeps every record it emitted."""

    def __init__(self, path: str, all_ranks: bool = False):
        self.path = path
        self.all_ranks = all_ranks
        self._rank: Optional[int] = None
        self._fh = None                         # guarded-by: _lock
        self._opened = False                    # guarded-by: _lock
        self._lock = threading.RLock()
        self.records_written = 0                # guarded-by: _lock

    @property
    def rank(self) -> int:
        """This process's rank in the default process group, 0 without
        one."""
        if self._rank is None:
            import torch.distributed as dist
            self._rank = dist.get_rank() if dist.is_initialized() else 0
        return self._rank

    @property
    def active(self) -> bool:
        """Whether this process writes: rank 0, or every rank under
        ``all_ranks``."""
        return self.all_ranks or self.rank == 0

    def resolved_path(self) -> str:
        return self.path if self.rank == 0 else f"{self.path}.rank{self.rank}"

    def write(self, record: Dict[str, Any]) -> bool:
        """Write one record; False where this rank does not write.  The
        file is truncated at first open; a write after close() re-opens it
        in append mode."""
        if not self.active:
            return False
        with self._lock:
            if self._fh is None:
                path = self.resolved_path()
                parent = os.path.dirname(path)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                self._fh = open(path, "a" if self._opened else "w")
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
