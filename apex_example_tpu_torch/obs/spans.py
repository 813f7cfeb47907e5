"""Host spans and the step's phase ranges, one vocabulary: port of
apex_example_tpu/obs/spans.py (``PHASES`` :38, ``span`` :93).

- The step's phases (``fwd_bwd``, ``grad_allreduce``, ``unscale_check``,
  ``optimizer``): ``device_span`` is ``torch.profiler.record_function``,
  JAX's ``jax.named_scope``.  engine.make_train_step (and so the
  data-parallel step), workloads.make_txl_train_step and
  optim/distributed.make_zero_train_step wrap their phases in it, so a
  torch.profiler trace of a step carries JAX's phase names; outside a
  profiler it records nothing.
- The loop's host regions (``data``, ``step``, ``checkpoint``): :func:`span`
  times them with ``perf_counter``, nests, feeds a ``span.<dotted.path>``
  histogram of a :class:`~apex_example_tpu_torch.obs.metrics.
  MetricsRegistry` (the run_summary's ``spans``) and, with a default
  Tracer armed (``--trace``), writes each as a ``trace_event`` (ph "X",
  tid the thread's name, parented on the enclosing span).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import List, Optional

from torch.profiler import record_function

from apex_example_tpu_torch.obs import trace as trace_lib

PHASES = (
    "data",             # host: the batch (made on the card, or fetched)
    "step",             # host: the step's call (and its record's fetch)
    "fwd_bwd",          # device: forward and scaled backward
    "grad_allreduce",   # device: the data-parallel grad reduction
    "unscale_check",    # device: unscale and the finite check
    "optimizer",        # device: the fused optimizer's step
)

device_span = record_function

_tls = threading.local()
_default_registry = None


def set_default_registry(registry) -> None:
    """The registry every later span records into (None: none)."""
    global _default_registry
    _default_registry = registry


class Span:
    """One timed host region; ``dur_ms`` is set when the context exits."""

    __slots__ = ("name", "t0", "dur_ms", "children", "span_id")

    def __init__(self, name: str):
        self.name = name
        self.t0 = time.perf_counter()
        self.dur_ms: Optional[float] = None
        self.children: List["Span"] = []
        # allocated on entry under --trace: children exit first and name
        # their parent's id
        self.span_id: Optional[str] = None


def _stack() -> List[Span]:
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


def current_span() -> Optional[Span]:
    stack = _stack()
    return stack[-1] if stack else None


@contextmanager
def span(name: str, device: bool = False):
    """Time a host region; yields its :class:`Span` (``dur_ms`` after the
    ``with``).  Nested spans attach to their parent; a finished span feeds
    ``span.<dotted.path>`` in the default registry (if one is set) and,
    with a default Tracer, lands as a ``trace_event``.  ``device=True``
    also opens a ``record_function`` range of the same name."""
    stack = _stack()
    sp = Span(name)
    parent = stack[-1] if stack else None
    if parent is not None:
        parent.children.append(sp)
    tracer = trace_lib.get_default()
    if tracer is not None:
        sp.span_id = tracer.next_id()
    stack.append(sp)
    scope = record_function(name) if device else None
    if scope is not None:
        scope.__enter__()
    try:
        yield sp
    finally:
        if scope is not None:
            scope.__exit__(None, None, None)
        sp.dur_ms = (time.perf_counter() - sp.t0) * 1e3
        stack.pop()
        if _default_registry is not None:
            path = ".".join([s.name for s in stack] + [name])
            _default_registry.histogram(f"span.{path}").observe(sp.dur_ms)
        if tracer is not None:
            tracer.complete(
                name, sp.t0, sp.dur_ms / 1e3, cat="span",
                tid=threading.current_thread().name,
                span_id=sp.span_id,
                parent_id=parent.span_id if parent is not None else None)
