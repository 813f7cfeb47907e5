"""The flight recorder: port of apex_example_tpu/obs/flight.py
(``format_thread_stacks`` :52, ``FlightRecorder`` :71).

It keeps a ring of the last K step records and a snapshot of the config
and environment, installs the process's failure hooks (``faulthandler``,
SIGTERM and SIGINT handlers, ``sys.excepthook``, ``atexit``), and on an
abnormal end writes two records to the run's JSONL sink:

- a ``crash_dump``: the reason, the traceback or every thread's stack,
  the ring, the metrics registry's snapshot, the card's memory
  (``torch.cuda.memory_stats``), the config and the environment (Python,
  torch, the CUDA runtime and the card's name);
- the run's ``run_summary`` marked ``aborted`` (``TelemetryEmitter.abort``).

A clean ``close()`` disarms everything.  The first hook to fire wins (a
signal, the trainer's ``finally`` seeing an exception unwind, the
excepthook, atexit); the rest do nothing.

SIGTERM writes the dump, restores the disposition that preceded the
recorder and delivers the signal again: the process still dies with 143.
SIGINT chains to Python's handler (KeyboardInterrupt unwinds, so
``finally`` blocks run).  ``release_signal`` hands a signal over to the
preemption grace path (resilience/preemption.py).
"""

from __future__ import annotations

import atexit
import collections
import faulthandler
import os
import platform
import signal
import sys
import threading
import traceback
from typing import Any, Dict, Optional

import torch

from apex_example_tpu_torch.obs import metrics as metrics_lib
from apex_example_tpu_torch.obs.telemetry import (TelemetryEmitter,
                                                  device_memory_stats)

# Bounded dump payloads: a crash record must stay one JSONL line that
# tools can parse, not a core file.
_MAX_TRACEBACK_CHARS = 16_000
_MAX_STACKS_CHARS = 16_000
DEFAULT_KEEP = 64
SIGNALS = (signal.SIGTERM, signal.SIGINT)     # the signals install() hooks


def format_thread_stacks() -> str:
    """One string with every live thread's current stack — the python-side
    analog of faulthandler's dump, but capturable into a JSON record.
    (Shared with obs/watchdog.py's stall records.)"""
    names = {t.ident: t.name for t in threading.enumerate()}
    parts = []
    for ident, frame in sorted(sys._current_frames().items()):
        name = names.get(ident, "?")
        parts.append(f"--- thread {name} ({ident}) ---\n"
                     + "".join(traceback.format_stack(frame)))
    out = "\n".join(parts)
    return out[-_MAX_STACKS_CHARS:]


def _json_safe_config(config: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    return {k: v for k, v in (config or {}).items()
            if isinstance(v, (str, int, float, bool, type(None)))}


class FlightRecorder:
    """Crash forensics bound to a run's JSONL sink.

    ``emitter`` is the run's TelemetryEmitter (the trainer's): the
    recorder rides its sink, snapshots its registry, reads the card's
    memory on its device and writes the aborted summary through
    ``emitter.abort``.

    The trainer's wiring (train.make_telemetry)::

        recorder = FlightRecorder(emitter, config=vars(args))
        recorder.install()
        emitter.add_observer(recorder.on_record)   # feeds the ring
        ...
        recorder.close()                           # clean exit: disarm
    """

    def __init__(self, emitter: TelemetryEmitter, keep: int = DEFAULT_KEEP,
                 config: Optional[Dict[str, Any]] = None):
        self.emitter = emitter
        self.sink = emitter.sink
        self.device = emitter.device
        self.ring: collections.deque = collections.deque(maxlen=max(keep, 1))
        self.config = _json_safe_config(config)
        self._prev_signal: Dict[int, Any] = {}
        self._prev_excepthook = None
        self._installed = False
        self._closed = False
        self._dumped = False

    # ------------------------------------------------------------- feed

    def on_record(self, record: Dict[str, Any], metrics=None) -> None:
        """TelemetryEmitter observer: keep the last K step records."""
        if record.get("record") == "step":
            self.ring.append(record)

    # ------------------------------------------------------------ hooks

    def install(self) -> None:
        """Arm the failure hooks: faulthandler, SIGNALS' handlers, the
        excepthook and atexit.  Signal handlers only install from the
        main thread (CPython's constraint); embedders running the loop in
        a worker thread keep the excepthook/atexit coverage."""
        if self._installed:
            return
        self._installed = True
        if not faulthandler.is_enabled():
            # Native faults (SIGSEGV/SIGABRT from a kernel or the runtime)
            # can't run python code — stderr stacks are the best possible.
            faulthandler.enable()
        if threading.current_thread() is threading.main_thread():
            for sig in SIGNALS:
                try:
                    self._prev_signal[sig] = signal.signal(sig,
                                                           self._on_signal)
                except (ValueError, OSError):  # pragma: no cover
                    pass
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._on_excepthook
        atexit.register(self._on_atexit)

    def release_signal(self, sig) -> None:
        """Hand ownership of ``sig`` back: restore the disposition that
        preceded ``install()`` and forget the signal, so a later
        ``close()`` cannot clobber whoever installs over it.  Used by the
        preemption grace path (resilience/preemption.py) to take over
        SIGTERM/SIGUSR1 — a preempted run must save and exit 75, not
        crash-dump and die 143; the recorder keeps the excepthook/atexit/
        faulthandler coverage for real crashes."""
        prev = self._prev_signal.pop(sig, None)
        if prev is None:
            return
        try:
            if signal.getsignal(sig) == self._on_signal:
                signal.signal(sig, prev)
        except (ValueError, OSError):  # pragma: no cover
            pass

    def close(self) -> None:
        """Clean-exit disarm: restore handlers, unregister atexit.  After
        this, no hook writes anything."""
        if self._closed:
            return
        self._closed = True
        for sig, prev in self._prev_signal.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):  # pragma: no cover
                pass
        self._prev_signal.clear()
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None
        atexit.unregister(self._on_atexit)

    # ------------------------------------------------------------- dump

    def environment(self) -> Dict[str, str]:
        env = {"python": platform.python_version(),
               "platform": platform.platform(),
               "argv": " ".join(sys.argv)}
        env["torch"] = torch.__version__
        if torch.version.cuda:
            env["cuda"] = torch.version.cuda
        if self.device.type == "cuda":
            try:
                env["device"] = torch.cuda.get_device_name(self.device)
            except Exception:  # pragma: no cover
                pass
        return env

    def crash_dump(self, reason: str, exc_info=None,
                   thread_stacks: bool = False) -> Optional[Dict[str, Any]]:
        """Write the ``crash_dump`` record + the aborted run summary.
        Idempotent: the first caller wins (every hook funnels here)."""
        if self._dumped:
            return None
        self._dumped = True
        rec: Dict[str, Any] = {
            "record": "crash_dump",
            "time": metrics_lib.now(),
            "reason": reason,
            "env": self.environment(),
        }
        if self.config:
            rec["config"] = self.config
        if self.ring:
            rec["step"] = int(self.ring[-1].get("step", 0))
            rec["last_steps"] = list(self.ring)
        rec["run_id"] = self.emitter.run_id
        try:
            rec["registry"] = self.emitter.registry.snapshot()
        except Exception:  # pragma: no cover
            pass
        if exc_info is not None:
            tb = "".join(traceback.format_exception(*exc_info))
            rec["traceback"] = tb[-_MAX_TRACEBACK_CHARS:]
        if thread_stacks:
            rec["thread_stacks"] = format_thread_stacks()
        try:
            mem = device_memory_stats(self.device)
        except Exception:  # pragma: no cover
            mem = None
        if mem:
            rec["memory"] = mem
        self.sink.write(rec)
        self.emitter.abort(reason)
        return rec

    # ---------------------------------------------------- hook targets

    def _on_signal(self, signum, frame) -> None:
        name = signal.Signals(signum).name
        self.crash_dump(f"signal:{name}", thread_stacks=True)
        prev = self._prev_signal.get(signum, signal.SIG_DFL)
        try:
            signal.signal(signum, prev if not callable(prev)
                          else signal.SIG_DFL)
        except (ValueError, OSError):  # pragma: no cover
            pass
        if callable(prev):
            # SIGINT's default is signal.default_int_handler — chaining
            # raises KeyboardInterrupt here, so finally blocks still run.
            prev(signum, frame)
        else:
            # Re-deliver with the prior disposition restored: the process
            # exits with the conventional 128+signum status.
            os.kill(os.getpid(), signum)

    def _on_excepthook(self, etype, value, tb) -> None:
        # Backstop for exceptions that escape without passing a finally
        # that calls crash_dump (the trainer's close_telemetry normally
        # beats this hook).  SystemExit is a normal CLI exit, not a crash.
        if not issubclass(etype, SystemExit):
            self.crash_dump(f"exception:{etype.__name__}",
                            exc_info=(etype, value, tb))
        prev = self._prev_excepthook or sys.__excepthook__
        prev(etype, value, tb)

    def _on_atexit(self) -> None:
        # Interpreter teardown without close(): os._exit-adjacent paths,
        # sys.exit deep in a library, a worker dropping the run on the
        # floor.  A clean close() unregisters this.
        self.crash_dump("atexit:run never closed")
