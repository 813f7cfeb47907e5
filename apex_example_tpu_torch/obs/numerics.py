"""Overflow provenance, which module's grads went non-finite: port of
apex_example_tpu/obs/numerics.py (``module_grad_stats`` :34,
``NumericsMonitor`` :62).

:func:`module_grad_stats` gives, for each top-level module, the count of
non-finite grad elements and the fp32 L2 norm of its grads.  The
monitor takes them from the grads the optimizer took: unscaled, after
any all-reduce and accumulation (O2's fp32 masters' grads, O3's half
grads counted and normed in fp32).  JAX computes them inside its jitted
step (engine.py :113, :273-278), where the grads live; here the grads
stay in ``.grad`` after the step, unchanged by the optimizer (no
optimizer kernel writes them) until the next step zeroes them, so the
monitor reads them after the step, from the step record's observer, and
only on a step it reports.  The module names are the flax tree's
top-level keys (convert.flax_module_name: the port's ``layers.{i}.…`` is
JAX's ``layer_{i}``; ``word_embeddings``, ``conv_init``, ``Bottleneck_3``,
``fc`` are both's), so a drill on either stack names the same modules.
JAX leaves these reductions to XLA; here they are plain PyTorch ops on
the card, a few launches for each module (not for each tensor), stacked
into one fp64 table (counts exact to 2^53) that the host reads in one
transfer.

Modes (``--numerics-check``):

- ``off``       nothing computed, nothing read, no records (default).
- ``overflow``  on a step whose grads were not finite (the record's
                ``grads_finite``, which the step record has already
                fetched), the stats and an ``overflow_event``; a clean
                step computes and reads nothing.
- ``always``    the stats and one ``overflow_event`` every step.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from apex_example_tpu_torch.convert import flax_module_name

MODES = ("off", "overflow", "always")
MAX_EVENTS = 1000         # overflow_event records a run at most


def module_grad_stats(named_grads: Iterable[Tuple[str, torch.Tensor]]
                      ) -> Dict[str, Dict[str, Any]]:
    """Per-module non-finite counts and fp32 grad norms of
    ``(module name, grad)`` pairs: ``{module: {"nonfinite": int,
    "grad_norm": float}}``, the modules in order of first appearance.
    Each module's grads of one dtype are one group: flattened together
    (one copy where there are several), then one count of the finite
    elements and one fp32 norm a group, on the grads' device; the host
    reads the stacked (groups, 2) fp64 table in one transfer and sums it
    by module.  So a model of G groups costs about 4 G launches, whatever
    its tensor count."""
    groups: Dict[Tuple[str, torch.dtype], List[torch.Tensor]] = {}
    for name, g in named_grads:
        groups.setdefault((name, g.dtype), []).append(g)
    if not groups:
        raise ValueError("module_grad_stats needs at least one grad")
    finite, norms = [], []
    for grads in groups.values():
        flat = (grads[0].reshape(-1) if len(grads) == 1
                else torch.cat([g.reshape(-1) for g in grads]))
        finite.append(torch.isfinite(flat).sum())
        norms.append(torch.linalg.vector_norm(flat, dtype=torch.float32))
    table = torch.stack([torch.stack(finite).double(),
                         torch.stack(norms).double().square()], dim=1)
    out = {name: [0, 0.0] for name, _ in groups}
    for ((name, _), grads), (ok, sq) in zip(groups.items(), table.tolist()):
        out[name][0] += sum(g.numel() for g in grads) - int(ok)
        out[name][1] += sq
    return {name: {"nonfinite": bad, "grad_norm": math.sqrt(sq)}
            for name, (bad, sq) in out.items()}


def optimizer_grad_stats(model: torch.nn.Module,
                         optimizer) -> Dict[str, Dict[str, Any]]:
    """:func:`module_grad_stats` of ``optimizer``'s grads (``.grad`` of
    its parameters, in its order), each named by the flax module of
    ``model`` that holds it."""
    by_id = {id(p): flax_module_name(n) for n, p in model.named_parameters()}
    return module_grad_stats((by_id[id(p)], p.grad)
                             for p in optimizer.params)


class NumericsMonitor:
    """Host side: on a step it reports, reads the stats of ``state``'s
    grads and writes an ``overflow_event`` naming the modules with
    non-finite grads::

        monitor = NumericsMonitor(sink, state, mode="overflow")
        emitter.add_observer(monitor.on_record)

    It runs as the step record's observer, after the step and before the
    next one zeroes the grads.  At most MAX_EVENTS records a run (a run
    that overflows every step)."""

    def __init__(self, sink, state, mode: str = "overflow",
                 run_id: Optional[str] = None):
        if mode not in MODES:
            raise ValueError(f"numerics mode {mode!r}: expected one of "
                             f"{MODES}")
        self.sink = sink
        self.state = state
        self.mode = mode
        self.run_id = run_id
        self.events_emitted = 0

    def on_record(self, record, metrics=None) -> Optional[Dict[str, Any]]:
        """TelemetryEmitter observer: inspect one step record (its
        fetched ``grads_finite``, ``scale`` and ``loss``); returns the
        record written, or None."""
        if self.mode == "off" or record.get("record") != "step":
            return None
        finite = record.get("grads_finite")
        if self.mode == "overflow" and (finite is None or finite >= 1.0):
            return None
        if self.events_emitted >= MAX_EVENTS:
            return None
        fetched = optimizer_grad_stats(self.state.model,
                                       self.state.optimizer)
        modules = sorted(name for name, s in fetched.items()
                         if s["nonfinite"] > 0)
        rec: Dict[str, Any] = {
            "record": "overflow_event",
            "time": time.time(),
            "step": int(record.get("step", 0)),
            "modules": modules,
            "module_stats": fetched,
            "mode": self.mode,
        }
        if self.run_id:
            rec["run_id"] = self.run_id
        for key in ("scale", "loss"):
            if key in record:
                rec[key] = float(record[key])
        self.sink.write(rec)
        self.events_emitted += 1
        return rec
