"""The preemption grace path: a copy of apex_example_tpu/resilience/
preemption.py (``EX_TEMPFAIL`` :36, ``PreemptionHandler`` :43).

With ``--preempt-grace`` the handler only sets a flag on SIGTERM or
SIGUSR1; the trainer polls it at the next step boundary and, outside the
signal's context, joins a pending async checkpoint write, saves a final
checkpoint with its host-state sidecar, writes a ``preemption`` record and
returns ``EX_TEMPFAIL`` (75), so a supervisor (tools/supervise.py)
restarts the run instead of declaring it broken.

The flight recorder (obs/flight.py) wants SIGTERM too; the handler takes
it over with ``FlightRecorder.release_signal``, so a preempted run saves
and exits 75 where an unsupervised one would crash-dump and die with 143,
while a real crash still reaches the recorder's other hooks.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Optional, Tuple

# sysexits.h EX_TEMPFAIL, "temporary failure; retry": the literal 75 is
# the contract the supervisor matches on.
EX_TEMPFAIL = getattr(os, "EX_TEMPFAIL", 75)

DEFAULT_SIGNALS: Tuple[int, ...] = (signal.SIGTERM, signal.SIGUSR1)


class PreemptionHandler:
    """Flag-only signal handler of the graceful-preemption path::

        preempt = PreemptionHandler(recorder=recorder)   # or None
        preempt.install()
        for step ...:
            ...
            if preempt.preempted:
                break                       # the grace sequence follows
        preempt.close()                     # restore the dispositions

    The handler records the signal's name and nothing else.
    A second delivery while the flag is set is ignored, so a repeated
    SIGTERM cannot turn a grace save into a crash."""

    def __init__(self, recorder=None):
        self.signals = DEFAULT_SIGNALS
        self.recorder = recorder
        self._prev = {}
        self._installed = False
        self._closed = False
        self._preempted = False
        self.signal_name: Optional[str] = None

    @property
    def preempted(self) -> bool:
        return self._preempted

    @property
    def installed(self) -> bool:
        return self._installed

    def install(self) -> None:
        """Arm the handlers.  Python installs signal handlers only from
        the main thread; elsewhere this does nothing and ``installed``
        stays False."""
        if self._installed or self._closed:
            return
        if threading.current_thread() is not threading.main_thread():
            return
        for sig in self.signals:
            if self.recorder is not None:
                # the recorder restores what preceded it and forgets the
                # signal, so its close() cannot clobber this handler
                self.recorder.release_signal(sig)
            try:
                self._prev[sig] = signal.signal(sig, self._on_signal)
            except (ValueError, OSError):  # pragma: no cover
                continue
        self._installed = bool(self._prev)

    def close(self) -> None:
        """Restore the dispositions that preceded ``install()``."""
        if self._closed:
            return
        self._closed = True
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):  # pragma: no cover
                pass
        self._prev.clear()

    def _on_signal(self, signum, frame) -> None:
        if self._preempted:
            return
        self._preempted = True
        self.signal_name = signal.Signals(signum).name
