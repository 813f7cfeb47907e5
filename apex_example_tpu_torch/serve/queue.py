"""Request queue + request/completion records: the port's copy of
apex_example_tpu/serve/queue.py (stdlib only, kept as it is there).

Pure host-side bookkeeping (no jax import): the engine thread pops
admissible requests, the load generator (or any producer thread) submits
them.  Every latency metric the serving stack reports — TTFT, TPOT, queue
wait — is derived from the four timestamps a request accumulates on its
way through (arrival, admission, first token, completion), so they live
here next to the dataclasses rather than in the engine.

Arrival gating supports two clocks:

- wall clock (the serving default): a producer thread submits when the
  request "arrives"; the engine admits whatever is in the queue.
- virtual step time (``arrival_step``): the request is submitted up
  front but becomes admissible only once the engine's step counter
  reaches ``arrival_step``.  Deterministic staggered arrivals — what the
  tier-1 continuous-batching test pins (tests/test_serve.py).

Request deadlines mirror the two clocks: ``deadline_s`` is a wall-clock
TTL from arrival (the production knob), ``deadline_step`` an absolute
engine tick by which the request must have finished (the deterministic
testing knob — no wall-clock sleeps needed to exercise the timeout
path).  Both are honored while queued (expire without admitting) AND
while decoding (the engine evicts the slot mid-flight).

Admission control: ``max_pending`` bounds the ARRIVED backlog — requests
whose gate has passed (or that never had one).  Future-gated requests
don't count; they haven't arrived yet.  When an arrival pushes the
backlog past the bound the overflow is shed deterministically
(``shed_policy``: "newest" rejects the most recently submitted arrivals,
the default; "oldest" drops the head so fresh traffic wins).  Shedding
happens at arrival evaluation inside the engine tick, so the engine owns
the ``shed`` records and Completions.

Every request terminates in a first-class :class:`Completion` whose
``status`` is one of ``ok`` / ``timeout`` / ``shed`` / ``cancelled`` /
``failed`` / ``drained`` / ``rejected`` — the serving stack never loses
a request silently (``rejected`` is the admission-time verdict for
requests the engine could never serve).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

_uid = itertools.count()

# Terminal request statuses (Completion.status).  "ok" is the only
# success; "drained" means the request was never admitted before a
# graceful drain and was handed back for requeueing on another replica;
# "rejected" means admission determined the request can NEVER be served
# by this engine (prompt fills the whole cache so the output budget is
# zero, or the worst-case block need exceeds the arena) — terminated
# first-class at admission instead of occupying a slot to emit nothing;
# "handoff" means a prefill-role engine finished the prompt, sampled
# the first token and shipped the request's KV blocks to a decode
# worker (serve/disagg.py) — like "drained", the request continues
# elsewhere, so it sits outside the availability denominator.
# "migrated" is the live-migration counterpart: a MID-FLIGHT
# request whose KV blocks, generated tokens and sampler state were
# snapshotted (ServeEngine.extract_live) and shipped to a peer that
# resumes it token-identically — again outside the availability
# denominator (the destination owns the terminal).
STATUSES = ("ok", "timeout", "shed", "cancelled", "failed", "drained",
            "rejected", "handoff", "migrated")


def _next_uid() -> str:
    return f"req-{next(_uid):06d}"


@dataclass
class Request:
    """One generation request.  ``prompt`` is a token-id list; sampling is
    per-request (temperature 0 = greedy, top_k 0 = full softmax) — the
    engine batches mixed sampling configs in one compiled step."""

    prompt: Sequence[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    eos_id: Optional[int] = None
    # Multi-tenant identity: which lane the fair scheduler
    # files this under, and an intra-lane priority bump (higher admits
    # first within the tenant, stable among equals).  Defaults keep
    # legacy single-tenant construction — and its emitted records —
    # byte-identical.
    tenant: str = "default"
    priority: int = 0
    uid: str = field(default_factory=_next_uid)
    # Virtual-time admission gate (None = admissible immediately).
    arrival_step: Optional[int] = None
    # Deadlines: wall-clock TTL from arrival, and/or an absolute engine
    # tick by which the request must have COMPLETED (at tick >=
    # deadline_step an unfinished request is expired — queued or
    # decoding).  Either, both, or neither may be set.
    deadline_s: Optional[float] = None
    deadline_step: Optional[int] = None
    # Wall-clock arrival.  For ungated requests this is submission time;
    # for arrival_step-gated ones RequestQueue.mature() RE-STAMPS it at
    # the tick the gate passes — the request "arrives" then, and TTFT /
    # queue-wait must not charge the virtual pre-arrival wait to the
    # engine (the load generator builds all requests up front).
    t_arrival: float = field(default_factory=time.perf_counter)
    # Client-side submission stamp (perf_counter), set by the producer
    # that BUILT the request (serve/loadgen.py) before it reached the
    # queue: the loadgen->queue handoff then shows as its own "submit"
    # span on a --trace timeline instead of folding into queue wait.
    # None (the default) means the request was built at submission.
    t_submit: Optional[float] = None
    _arrival_stamped: bool = field(default=False, repr=False)

    def __post_init__(self):
        if len(self.prompt) < 1:
            raise ValueError(f"{self.uid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"{self.uid}: max_new_tokens must be >= 1")
        if self.temperature < 0:
            raise ValueError(f"{self.uid}: temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError(f"{self.uid}: top_k must be >= 0")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"{self.uid}: deadline_s must be > 0")
        if self.deadline_step is not None and self.deadline_step < 1:
            raise ValueError(f"{self.uid}: deadline_step must be >= 1")

    def arrived(self, step: int) -> bool:
        """Has this request arrived by engine tick ``step``?"""
        return self.arrival_step is None or self.arrival_step <= step

    def expired(self, step: int, now: float) -> bool:
        """Deadline check, on either clock.  Only meaningful once the
        request has arrived (the engine never asks earlier)."""
        if self.deadline_step is not None and step >= self.deadline_step:
            return True
        if self.deadline_s is not None \
                and now - self.t_arrival > self.deadline_s:
            return True
        return False


@dataclass
class Completion:
    """A terminated request: its status, the generated tokens (prompt
    excluded — possibly partial, possibly empty for never-admitted
    requests) plus the slot/step/timestamp trail the serving metrics are
    computed from.

    ``status`` "ok" keeps the original contract (``finish_reason`` is
    "eos" or "length", all timestamps set).  Non-success statuses use
    ``finish_reason == status``; a request that never reached a slot has
    ``slot == -1`` and ``t_admitted``/``t_first_token`` None.
    """

    request: Request
    tokens: List[int]
    finish_reason: str          # "eos" | "length" | a non-ok status
    slot: int
    admitted_step: int
    finished_step: int
    t_admitted: Optional[float]
    t_first_token: Optional[float]
    t_finish: float
    status: str = "ok"
    error: Optional[str] = None  # traceback digest for status "failed"

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token, measured from ARRIVAL (queue wait is part
        of the latency a caller sees).  None before/without a first
        token (shed, queued-timeout, drained)."""
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.request.t_arrival

    @property
    def tpot_s(self) -> float:
        """Time per output token after the first (0 for <=1-token
        outputs)."""
        n = len(self.tokens)
        if n <= 1 or self.t_first_token is None:
            return 0.0
        return (self.t_finish - self.t_first_token) / (n - 1)

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.t_admitted is None:
            return None
        return self.t_admitted - self.request.t_arrival

    @property
    def e2e_s(self) -> float:
        return self.t_finish - self.request.t_arrival


class RequestQueue:
    """Thread-safe FIFO with virtual-time admission gating, an optional
    pending bound (admission control) and deadline bookkeeping.

    ``pop(step)`` returns the head request if it is admissible at engine
    step ``step`` (its ``arrival_step`` gate has passed), else None —
    FIFO order is preserved: a gated head blocks later requests even if
    their gates passed, matching a real ingress queue.

    ``max_pending`` bounds the arrived backlog; the engine calls
    ``shed_overflow(step)`` once per tick (after ``mature``) and owns the
    records for whatever comes back.  ``expire(step, now)`` returns
    arrived-but-unadmitted requests whose deadline passed — expired
    without ever occupying a slot.
    """

    def __init__(self, max_pending: Optional[int] = None,
                 shed_policy: str = "newest"):
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        if shed_policy not in ("newest", "oldest"):
            raise ValueError(f"shed_policy must be 'newest' or 'oldest', "
                             f"got {shed_policy!r}")
        self.max_pending = max_pending
        self.shed_policy = shed_policy
        self._q: deque = deque()                # guarded-by: _lock
        self._lock = threading.Lock()
        self._closed = False                    # guarded-by: _lock
        # Sticky: set once any deadline-carrying request is submitted,
        # so the per-tick expire() scan is skipped entirely on the
        # (default) deadline-free path — a 20k-request backlog must not
        # pay an O(n) no-op scan under the lock every engine tick.
        self._has_deadlines = False             # guarded-by: _lock

    def submit(self, request: Request) -> None:
        with self._lock:
            if self._closed:
                raise RuntimeError("queue is closed")
            if request.deadline_s is not None \
                    or request.deadline_step is not None:
                self._has_deadlines = True
            # An ungated request "arrives" NOW — at submission, as the
            # t_arrival docstring has always said — not at whatever
            # earlier moment the dataclass was constructed: the
            # build->submit gap is the client's (the "submit" span on
            # a --trace timeline, when t_submit is stamped), and queue
            # wait must not absorb it.  Gated requests re-stamp at
            # their virtual gate instead (mature()).
            if request.arrival_step is None \
                    and not request._arrival_stamped:
                request.t_arrival = time.perf_counter()
                request._arrival_stamped = True
            self._q.append(request)

    def submit_all(self, requests) -> None:
        for r in requests:
            self.submit(r)

    def mature(self, step: int) -> None:
        """Stamp wall-clock arrival on every gated request whose
        ``arrival_step`` has been reached at engine tick ``step`` — even
        the ones not yet poppable (all slots busy): time spent waiting
        AFTER the gate passes is genuine queue wait and must count.
        ``t_submit`` is re-stamped with it: a virtually-gated request
        was built up front by the load generator, so the build->gate
        delay is deliberate staggering, not client handoff — charging
        it to a "submit" span would reintroduce under a new name the
        exact pre-arrival wait this re-stamp exists to exclude (real
        handoff survives only on ungated, wall-clock submissions).
        The engine calls this once per tick, before admission."""
        now = time.perf_counter()
        with self._lock:
            for req in self._q:
                if (req.arrival_step is not None and not
                        req._arrival_stamped and req.arrival_step <= step):
                    req.t_arrival = now
                    if req.t_submit is not None:
                        req.t_submit = now
                    req._arrival_stamped = True

    def shed_overflow(self, step: int) -> List[Request]:
        """Admission control: requests shed because the arrived backlog
        exceeds ``max_pending`` at tick ``step``.  Deterministic —
        "newest" rejects the latest arrivals (back of the queue),
        "oldest" drops the head.  No-op without a bound."""
        if self.max_pending is None:
            return []
        with self._lock:
            if len(self._q) <= self.max_pending:
                return []              # O(1): arrived <= total <= bound
            arrived = [i for i, r in enumerate(self._q) if r.arrived(step)]
            excess = len(arrived) - self.max_pending
            if excess <= 0:
                return []
            victims = set(arrived[-excess:] if self.shed_policy == "newest"
                          else arrived[:excess])
            shed = [r for i, r in enumerate(self._q) if i in victims]
            self._q = deque(r for i, r in enumerate(self._q)
                            if i not in victims)
            return shed

    def expire(self, step: int, now: float) -> List[Request]:
        """Arrived-but-unadmitted requests whose deadline has passed at
        tick ``step`` — removed and returned so the engine can terminate
        them with status "timeout" without ever admitting them."""
        with self._lock:
            # Sticky-flag fast path INSIDE the lock: the flag is set by
            # producer threads (submit) and read here by the engine —
            # graftlint's lock-discipline rule caught the original
            # unguarded read.  The O(n) scan is still skipped
            # on the deadline-free path; the uncontended acquire is the
            # whole cost.
            if not self._has_deadlines:
                return []
            dead = [r for r in self._q
                    if r.arrived(step) and r.expired(step, now)]
            if dead:
                gone = set(id(r) for r in dead)
                self._q = deque(r for r in self._q if id(r) not in gone)
            return dead

    def cancel(self, uid: str) -> Optional[Request]:
        """Remove a queued request by uid (None if not queued — it may
        already be decoding; the engine handles that side)."""
        with self._lock:
            for r in self._q:
                if r.uid == uid:
                    self._q.remove(r)
                    return r
            return None

    def pop(self, step: int) -> Optional[Request]:
        with self._lock:
            if not self._q:
                return None
            head = self._q[0]
            if head.arrival_step is not None and head.arrival_step > step:
                return None
            return self._q.popleft()

    def push_front(self, request: Request) -> None:
        """Hand a popped request back to the HEAD of the queue — the
        engine's deterministic out-of-blocks queueing (head-of-line:
        FIFO order is preserved while the head waits for KV blocks).
        Allowed on a closed queue: this is the engine returning work it
        already owns, not a new submission."""
        with self._lock:
            self._q.appendleft(request)

    def pending(self) -> int:
        with self._lock:
            return len(self._q)

    def arrived_pending(self, step: int) -> int:
        """The ARRIVED backlog at tick ``step`` — what ``max_pending``
        bounds (future-gated requests are queued but have not arrived,
        so they must not be reported against the bound)."""
        with self._lock:
            return sum(1 for r in self._q if r.arrived(step))

    def close(self) -> None:
        """No more submissions; the engine drains what is queued and
        exits its loop when the queue is empty and every slot is free."""
        with self._lock:
            self._closed = True

    def drain(self) -> List[Request]:
        """Graceful-drain takeover: close the queue and hand back every
        still-queued request (admitted requests are the engine's to
        finish or deadline-evict).  The caller requeues them elsewhere —
        status "drained", not lost."""
        with self._lock:
            self._closed = True
            out = list(self._q)
            self._q.clear()
            return out

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def drained(self) -> bool:
        with self._lock:
            return self._closed and not self._q
