"""The trace-event emitter: a copy of apex_example_tpu/obs/trace.py
(``Tracer`` :56, ``set_default`` / ``get_default`` :174-181), standard
library only.

A :class:`Tracer` turns host spans (obs/spans.py) into ``trace_event``
records on the run's metrics stream, flag-gated (``--trace``), so the
default path writes nothing.  The records are the JAX stream's, and
``tools/trace_export.py`` renders the port's stream as it renders JAX's:

``ph: "B"/"E"``  begin/end of a nested region on one ``tid`` row;
``ph: "X"``      a complete span, ``ts`` and ``dur`` known at emission
                 (what the span layer writes);
``ph: "i"``      an instant.

``span_id`` / ``parent_id`` are stream-local; ``trace_id`` groups
streams: a supervising parent passes it in ``APEX_TRACE_ID``
(tools/supervise.py), so a preempted run and its restart render as one
timeline.  Every ``ts`` / ``dur`` is ``time.perf_counter()`` seconds; the
stream's one ``clock_sync`` record pairs a perf_counter reading with
``time.time()``, the anchor the exporter places the stream by.
"""

from __future__ import annotations

import itertools
import os
import time
import uuid
from typing import Any, Dict, Optional

TRACE_ID_ENV = "APEX_TRACE_ID"

_PHASES = ("B", "E", "X", "i")


class Tracer:
    """Emits ``trace_event`` records to a sink (anything with
    ``write(dict)``: the port's JsonlSink).

    ``trace_id`` is the ``APEX_TRACE_ID`` environment variable
    (set by a supervising parent), else a fresh uuid — a
    standalone run is its own one-stream trace.  The ``clock_sync``
    anchor is written lazily with the first event, so arming a tracer
    on a run that never traces anything leaves the stream untouched.
    """

    def __init__(self, sink, run_id: Optional[str] = None):
        self.sink = sink
        self.trace_id = (os.environ.get(TRACE_ID_ENV)
                         or uuid.uuid4().hex[:12])
        self.run_id = run_id
        self.events = 0
        self._ids = itertools.count(1)
        self._synced = False

    # ------------------------------------------------------------ core

    def next_id(self) -> str:
        """A fresh stream-local span id."""
        return f"s{next(self._ids)}"

    def _clock_sync(self) -> None:
        """The per-stream clock anchor: one wall-clock reading paired
        with one monotonic reading, taken back-to-back.  Everything
        else in the stream is monotonic; the exporter maps via
        ``wall = time + (ts - this.ts)``."""
        rec: Dict[str, Any] = {
            "record": "clock_sync",
            "time": time.time(),
            "ts": time.perf_counter(),
            "trace_id": self.trace_id,
        }
        if self.run_id:
            rec["run_id"] = self.run_id
        self.sink.write(rec)
        self._synced = True

    def event(self, ph: str, name: str, *, ts: Optional[float] = None,
              dur: Optional[float] = None, tid: str = "main",
              cat: Optional[str] = None, span_id: Optional[str] = None,
              parent_id: Optional[str] = None,
              args: Optional[Dict[str, Any]] = None) -> None:
        """Emit one trace_event.  ``ts``/``dur`` are perf_counter
        seconds (``ts`` defaults to now)."""
        if ph not in _PHASES:
            raise ValueError(f"ph must be one of {_PHASES}, got {ph!r}")
        if not self._synced:
            self._clock_sync()
        rec: Dict[str, Any] = {
            "record": "trace_event",
            "ph": ph,
            "name": name,
            "ts": time.perf_counter() if ts is None else ts,
            "tid": tid,
            "trace_id": self.trace_id,
        }
        if dur is not None:
            rec["dur"] = dur
        if cat is not None:
            rec["cat"] = cat
        if span_id is not None:
            rec["span_id"] = span_id
        if parent_id is not None:
            rec["parent_id"] = parent_id
        if args:
            rec["args"] = args
        if self.run_id:
            rec["run_id"] = self.run_id
        self.sink.write(rec)
        self.events += 1

    # ------------------------------------------------------- sugar

    def begin(self, name: str, *, ts: Optional[float] = None,
              tid: str = "main", cat=None,
              span_id: Optional[str] = None, parent_id=None,
              args=None) -> str:
        """Open a nested region on ``tid``; returns its span id (pass
        it to children as ``parent_id``).  Must be closed by ``end`` on
        the same tid — stack-wise, like the Chrome B/E contract."""
        sid = span_id or self.next_id()
        self.event("B", name, ts=ts, tid=tid, cat=cat, span_id=sid,
                   parent_id=parent_id, args=args)
        return sid

    def end(self, name: str, *, ts: Optional[float] = None,
            tid: str = "main", args=None) -> None:
        self.event("E", name, ts=ts, tid=tid, args=args)

    def complete(self, name: str, ts: float, dur: float, *,
                 tid: str = "main", cat=None,
                 span_id: Optional[str] = None, parent_id=None,
                 args=None) -> str:
        """A complete span, timestamps known at emission (the
        reconstruct-after-the-fact shape)."""
        sid = span_id or self.next_id()
        self.event("X", name, ts=ts, dur=max(dur, 0.0), tid=tid, cat=cat,
                   span_id=sid, parent_id=parent_id, args=args)
        return sid

    def instant(self, name: str, *, ts: Optional[float] = None,
                tid: str = "main", cat=None, parent_id=None,
                args=None) -> None:
        self.event("i", name, ts=ts, tid=tid, cat=cat,
                   parent_id=parent_id, args=args)


# Process-default instance: the trainer installs one under --trace and
# the span layer consults it, so call sites stay flag-free.
_default: Optional[Tracer] = None


def set_default(tracer: Optional[Tracer]) -> None:
    global _default
    _default = tracer


def get_default() -> Optional[Tracer]:
    return _default
