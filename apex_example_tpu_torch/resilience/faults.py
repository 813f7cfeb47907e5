"""Deterministic fault injection (``--inject-fault kind@step``): port of
apex_example_tpu/resilience/faults.py (``KINDS`` :102, ``FaultInjected``
:118, ``FaultPlan`` :124) for the training kinds.

A ``FaultPlan`` fires one fault at one 1-based global step:

``crash``    raise :class:`FaultInjected` (a RuntimeError) after the
             step completes: the flight recorder's exception path and the
             supervisor's crash restart.
``sigterm``  ``os.kill(self, SIGTERM)`` after the step completes: under
             ``--preempt-grace`` the loop sees the flag at the boundary
             and runs the grace save; without it the flight recorder's
             143 path.
``hang``     ``time.sleep`` after the step completes (``HANG_SECONDS``,
             read when the plan is made): the stall watchdog.
``nan``      every floating tensor of the step's batch replaced by NaN
             once it is on the device (after the pinned copy under
             ``--host-pipeline``): the grads go non-finite, the overflow
             path and ``--numerics-check``.  A batch with no floating
             tensor (GPT's and Transformer-XL's tokens) is refused when
             the fault fires, as in JAX; images and BERT's label weights
             carry NaN.

The training kinds fire on equality, once, so a resumed run whose step is
already past the fault's never fires it again.  The serving and handoff
kinds of the JAX module are not ported (ROADMAP A.12).
"""

from __future__ import annotations

import os
import signal
import time

import torch

KINDS = ("crash", "sigterm", "hang", "nan")

# Long enough that a hung step looks like a real wedge to the watchdog and
# the supervisor, bounded so an unsupervised run still ends.
HANG_SECONDS = 3600.0


class FaultInjected(RuntimeError):
    """The injected crash: a RuntimeError, so crash handling treats it as
    any other failure, of its own type, so a reader tells drill from
    disease."""


def _poison(tree, poisoned: list):
    if torch.is_tensor(tree):
        if tree.is_floating_point():
            poisoned.append(True)
            return torch.full_like(tree, float("nan"))
        return tree
    return type(tree)(_poison(t, poisoned) for t in tree)


class FaultPlan:
    """One fault, one step, fired once."""

    def __init__(self, kind: str, step: int):
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(expected one of {KINDS})")
        if step < 1:
            raise ValueError(f"fault step must be >= 1, got {step}")
        self.kind = kind
        self.step = int(step)
        self.hang_s = HANG_SECONDS
        self.fired = False

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """``kind@step``, e.g. ``sigterm@12``."""
        kind, sep, step_s = spec.partition("@")
        if not sep or not kind or not step_s:
            raise ValueError(f"--inject-fault {spec!r}: expected kind@step "
                             f"(kinds: {', '.join(KINDS)})")
        try:
            step = int(step_s)
        except ValueError:
            raise ValueError(f"--inject-fault {spec!r}: step {step_s!r} is "
                             "not an integer")
        return cls(kind, step)

    def __repr__(self) -> str:
        return f"FaultPlan({self.kind}@{self.step})"

    def maybe_poison(self, step: int, batch):
        """The ``nan`` kind, given the 1-based global step about to
        consume ``batch`` (a tensor or nested tuples of them): at the
        fault's step, the batch with every floating tensor NaN."""
        if self.kind != "nan" or self.fired or step != self.step:
            return batch
        self.fired = True
        poisoned: list = []
        batch = _poison(batch, poisoned)
        if not poisoned:
            raise FaultInjected(
                f"nan fault at step {self.step}: the batch carries no "
                "floating-point leaf to poison (int-only token batches "
                "cannot carry NaN — use the image or MLM workloads)")
        return batch

    def maybe_fire(self, step: int) -> None:
        """The crash, sigterm and hang kinds, given the 1-based global step
        that just completed (after its record and any interval save, so
        the forensics hold the last good step)."""
        if self.kind not in ("crash", "sigterm", "hang") or self.fired \
                or step != self.step:
            return
        self.fired = True
        if self.kind == "crash":
            raise FaultInjected(f"injected crash at step {self.step}")
        if self.kind == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
            return
        time.sleep(self.hang_s)
