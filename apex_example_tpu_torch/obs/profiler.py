"""torch.profiler traces of the training loop: port of
apex_example_tpu/obs/profiler.py (``parse_window`` :32, ``ProfilerWindow``
:48, ``make_profiler_window`` :91) on ``torch.profiler.profile``.

``--profile-window N:M`` traces the run-relative steps N..M (1-based,
inclusive; a resumed run counts from its resume point); ``--prof`` traces
the whole run (:func:`start_trace` / :func:`stop_trace`).  Each trace
records the host's operators and, on the card, CUDA's activity
(``activities=[CPU, CUDA]``) and is written as Chrome-trace JSON into
``DEFAULT_TRACE_DIR``, ``build/trace/`` at the root of the checkout
(listed in .gitignore).  The step's phase ranges
(obs/spans.py ``device_span``: ``fwd_bwd``, ``unscale_check``,
``optimizer``, ...) are ``record_function`` ranges in it.

The step returns before the card has run its kernels, so a stop first
waits for the card (``torch.cuda.synchronize``), where JAX's stop blocks
on the step's outputs.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

from apex_example_tpu_torch.obs.logging import rank_print

DEFAULT_TRACE_DIR = str(Path(__file__).resolve().parents[2] / "build"
                        / "trace")


def parse_window(spec: str) -> Tuple[int, int]:
    """``"N:M"`` -> (N, M), 1-based inclusive; a malformed spec raises
    ValueError with the flag's message."""
    parts = spec.split(":")
    if len(parts) != 2:
        raise ValueError(f"--profile-window {spec!r}: expected N:M")
    try:
        start, stop = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(f"--profile-window {spec!r}: N and M must be "
                         "integers") from None
    if start < 1 or stop < start:
        raise ValueError(f"--profile-window {spec!r}: need 1 <= N <= M")
    return start, stop


def start_trace(device=None) -> torch.profiler.profile:
    """A started profiler: the host's operators, and CUDA's activity when
    ``device`` is a card."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, logdir: str, name: str,
               device=None) -> str:
    """Wait for the card, stop ``prof`` and write its Chrome trace as
    ``logdir/<name>.<pid>.<ms>.pt.trace.json``; returns the path.  Stop it
    on the thread that started it: the profiler's state is per thread."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"{name}.{os.getpid()}."
                                f"{int(time.time() * 1e3)}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


class ProfilerWindow:
    """Start and stop a trace around the run-relative steps N..M: call
    ``on_step_start(i)`` before step ``i`` (1-based) and
    ``on_step_end(i)`` after it.  ``close()`` stops a trace a short run
    left open."""

    def __init__(self, spec: str, device=None):
        self.start, self.stop = parse_window(spec)
        self.logdir = DEFAULT_TRACE_DIR
        self.device = device
        self.active = False
        self.done = False
        self.path: Optional[str] = None
        self._prof = None

    def on_step_start(self, step_index: int) -> None:
        if self.done or self.active or step_index != self.start:
            return
        self._prof = start_trace(self.device)
        self.active = True

    def _finish(self) -> None:
        self.path = stop_trace(self._prof, self.logdir,
                               f"window_{self.start}_{self.stop}",
                               self.device)
        self._prof = None
        self.active = False
        self.done = True

    def on_step_end(self, step_index: int) -> None:
        if not self.active or step_index < self.stop:
            return
        self._finish()
        rank_print(f"profile window [{self.start}:{self.stop}] written to "
                   f"{self.path}")

    def close(self) -> None:
        if self.active:
            self._finish()
            rank_print(f"profile window truncated (run ended before step "
                       f"{self.stop}) — partial trace in {self.path}")


def make_profiler_window(spec: Optional[str], device=None
                         ) -> Optional[ProfilerWindow]:
    """A :class:`ProfilerWindow` of ``spec``, None without one."""
    return ProfilerWindow(spec, device) if spec else None
