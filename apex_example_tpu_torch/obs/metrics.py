"""Metrics: the port's copy of apex_example_tpu/obs/metrics.py's
``Counter``, ``Gauge`` (:29-53), ``nearest_rank``, ``Histogram``,
``MetricsRegistry`` (:194), ``JsonlSink``, ``read_jsonl`` (:305),
``TensorBoardAdapter`` (:317) and ``now`` (:337), and a standard-library
writer of TensorBoard event files for ``--tensorboard``.

The sink follows the reference harness's logging rule: only rank 0 of the
process group writes, unless ``all_ranks``, when rank K > 0 writes its own
``PATH.rank<K>`` (the JAX sink's naming, :239-266); the rank is read from
torch.distributed at the first use.  Records follow the JSONL schema
apex_example_tpu/obs/schema.py declares (version ``SCHEMA_VERSION``), so
tools/metrics_lint.py and tools/serve_report.py read the port's streams as
they are.

The registry is host-side: plain Python numbers, no device sync.  The
span layer (obs/spans.py) feeds its ``span.<path>`` histograms, which the
run_summary carries.

``--tensorboard DIR``: the JAX trainer writes through tensorboardX; the
port may import neither it nor ``tensorboard``, so :class:`EventFileWriter`
writes the event file itself (``DIR/events.out.tfevents.<time>.<host>``):
TFRecord framing (a little-endian uint64 length, its masked CRC-32C, the
bytes, their masked CRC-32C; CRC-32C is Castagnoli's, from a table built
here), a first ``Event{wall_time, file_version: "brain.Event:2"}``, then
one ``Event{wall_time, step, summary{value{tag, simple_value}}}`` a
scalar, each a hand-encoded protocol buffer.  TensorBoard reads it as it
reads tensorboardX's scalars.
"""

from __future__ import annotations

import json
import math
import os
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional

SCHEMA_VERSION = 18


def nearest_rank(sorted_vals, q: float) -> float:
    """Nearest-rank percentile over a PRE-SORTED sequence: the
    ceil(q/100 * n)-th value (1-based), clamped."""
    if not sorted_vals:
        return 0.0
    idx = math.ceil(q / 100.0 * len(sorted_vals)) - 1
    return sorted_vals[min(max(idx, 0), len(sorted_vals) - 1)]


class Counter:
    """Monotonic count (steps, items, records)."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> int:
        if n < 0:
            raise ValueError(f"counter {self.name}: inc({n}) < 0")
        self.value += n
        return self.value


class Gauge:
    """Last value wins (loss scale, loss, grad norm)."""

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None

    def set(self, value) -> float:
        self.value = float(value)
        return self.value


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


class MetricsRegistry:
    """Named instruments, get-or-create, one namespace; a name registered
    as one type and asked for as another raises."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name)
        elif not isinstance(m, cls):
            raise ValueError(f"metric {name!r} already registered as "
                             f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> Dict[str, Any]:
        """Counters and gauges to their value, histograms to their
        summary: JSON-ready."""
        out: Dict[str, Any] = {}
        for name, m in sorted(self._metrics.items()):
            out[name] = m.summary() if isinstance(m, Histogram) else m.value
        return out


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


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """A sink file's records."""
    records = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def now() -> float:
    """Wall-clock time of a record."""
    return time.time()


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
        table.append(crc)
    return table


_CRC32C_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, reflected polynomial 0x82F63B78)."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's mask of the CRC: rotate right by 15, add 0xa282ead8."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _field_bytes(number: int, payload: bytes) -> bytes:
    """A length-delimited field (wire type 2)."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def encode_event(wall_time: float, step: Optional[int] = None,
                 file_version: Optional[str] = None,
                 scalar: Optional[tuple] = None) -> bytes:
    """A ``tensorflow.Event``: wall_time (1, double), step (2, int64),
    file_version (3, string) or summary (5) holding one
    ``Summary.Value{tag (1), simple_value (2, float)}``."""
    out = bytes([1 << 3 | 1]) + struct.pack("<d", wall_time)
    if step is not None:
        out += _varint(2 << 3) + _varint(int(step) & (2 ** 64 - 1))
    if file_version is not None:
        out += _field_bytes(3, file_version.encode())
    if scalar is not None:
        tag, value = scalar
        val = _field_bytes(1, tag.encode()) + bytes([2 << 3 | 5]) \
            + struct.pack("<f", float(value))
        out += _field_bytes(5, _field_bytes(1, val))
    return out


def tfrecord(data: bytes) -> bytes:
    """One TFRecord: length, its masked CRC, the data, its masked CRC."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


class EventFileWriter:
    """The ``add_scalar(tag, value, step)`` / ``close()`` surface of
    tensorboardX's SummaryWriter, over an event file in ``logdir``
    written with the standard library; each scalar is flushed as it is
    written."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(time.time())}."
                    f"{socket.gethostname()}")
        self._fh = open(self.path, "wb")
        self._write(encode_event(time.time(), file_version="brain.Event:2"))

    def _write(self, event: bytes) -> None:
        self._fh.write(tfrecord(event))
        self._fh.flush()

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._write(encode_event(time.time(), step=step,
                                 scalar=(tag, float(value))))

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()


class TensorBoardAdapter:
    """Feeds a writer from a metrics dict: the trainer's scalar sites are
    one ``scalars()`` call each.  A ``None`` writer makes every method do
    nothing."""

    def __init__(self, writer=None):
        self.writer = writer

    def scalars(self, values: Dict[str, float], step: int) -> None:
        if self.writer is None:
            return
        for tag, value in values.items():
            self.writer.add_scalar(tag, value, step)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
