"""The stall watchdog: port of apex_example_tpu/obs/watchdog.py
(``StallWatchdog`` :34).

A daemon thread watches the time since the last completed step; past a
deadline (``--stall-timeout S``) it writes one ``stall`` record with every
thread's stack to the run's JSONL sink and stays quiet until a step
completes, then re-arms.  A clean ``close()`` disarms it, so a run that
ends is no stall.  The deadline covers the first step's one-off work
(the kernels' build and load).

``--stall-trace`` arms a one-shot torch.profiler trace from the first
stall to the first step that recovers (or ``close()``), written as a
Chrome trace into ``trace_dir`` (the profiler is started and stopped
once on the constructing, main thread first, which initialises its
backend there).  The watchdog thread both starts and
stops it: torch.profiler keeps its state per thread (a profiler started
on one thread cannot be stopped on another), and the main thread is the
one that hangs.  A step's completion only flags the stop, which the
watchdog's next poll carries out after waiting for the card.  The
trace's host operators are the watchdog thread's (the profiler records
operators on the thread that started it), but CUDA's activity, which
CUPTI collects for the whole process, holds the recovered step's
kernels.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from apex_example_tpu_torch.obs import metrics as metrics_lib
from apex_example_tpu_torch.obs import profiler as profiler_lib
from apex_example_tpu_torch.obs.flight import format_thread_stacks


class StallWatchdog:
    """Host-side stall detector bound to a run's JSONL sink::

        watchdog = StallWatchdog(sink, deadline_s=120)
        watchdog.start()
        emitter.add_observer(watchdog.on_record)   # a step's heartbeat
        ...
        watchdog.close()                           # clean end: disarm
    """

    def __init__(self, sink: metrics_lib.JsonlSink, deadline_s: float,
                 run_id: Optional[str] = None,
                 trace_dir: Optional[str] = None, device=None):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.sink = sink
        self.deadline_s = float(deadline_s)
        self.run_id = run_id
        self.trace_dir = trace_dir
        self.device = device
        # often enough to resolve the deadline without busy-waiting
        self._poll_s = min(max(self.deadline_s / 4.0, 0.01), 1.0)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._last = time.perf_counter()        # guarded-by: _lock
        self._last_step = 0                     # guarded-by: _lock
        self._fired = False                     # guarded-by: _lock
        self._recovered = False                 # guarded-by: _lock
        self._prof = None                       # watchdog thread only
        self._trace_used = False                # watchdog thread only
        self.stall_count = 0                    # guarded-by: _lock
        self._thread = threading.Thread(target=self._run,
                                        name="apex-stall-watchdog",
                                        daemon=True)
        if trace_dir:
            # the profiler's backend initialises on the first thread that
            # starts it and expects that thread to be the main one
            profiler_lib.start_trace(device).stop()

    def start(self) -> None:
        self._thread.start()

    def on_record(self, record, metrics=None) -> None:
        """TelemetryEmitter observer form of :meth:`notify_step`."""
        if record.get("record") == "step":
            self.notify_step(int(record.get("step", 0)))

    def notify_step(self, step: int) -> None:
        """A step completed: reset the deadline, re-arm, and flag an armed
        trace for its stop."""
        with self._lock:
            self._last = time.perf_counter()
            self._last_step = step
            self._fired = False
            self._recovered = True

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            # check and mark under one hold, so a step landing between
            # them cannot have its re-arm overwritten
            with self._lock:
                gap = time.perf_counter() - self._last
                step = self._last_step
                fire = gap >= self.deadline_s and not self._fired
                if fire:
                    self._fired = True
                    self._recovered = False
                    self.stall_count += 1
                recovered = self._recovered
            if self._prof is not None and recovered:
                self._stop_trace()
            if fire:
                self._emit_stall(gap, step)
        if self._prof is not None:
            self._stop_trace()

    def _emit_stall(self, gap: float, step: int) -> None:
        rec = {"record": "stall",
               "time": metrics_lib.now(),
               "seconds_since_step": round(gap, 3),
               "step": int(step),
               "deadline_s": self.deadline_s,
               "thread_stacks": format_thread_stacks()}
        if self.run_id:
            rec["run_id"] = self.run_id
        if self.trace_dir and not self._trace_used:
            # one-shot: a flapping run must not pile up traces
            self._trace_used = True
            try:
                self._prof = profiler_lib.start_trace(self.device)
            except Exception:
                self._prof = None
            else:
                rec["trace_dir"] = self.trace_dir
        self.sink.write(rec)

    def _stop_trace(self) -> None:
        prof, self._prof = self._prof, None
        try:
            profiler_lib.stop_trace(prof, self.trace_dir, "stall",
                                    self.device)
        except Exception:  # pragma: no cover
            pass

    def close(self) -> None:
        """Clean-end disarm: stop the thread (which stops and writes a
        still-armed trace); a run that ends is not a stall."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=30.0)
