"""Synthetic request stream: the port's copy of
apex_example_tpu/serve/loadgen.py (``substream``, ``synthetic_requests``,
``parse_range``).  The same numpy RandomState draws, so a seed gives the
same requests as in the JAX package.

Deterministic under a seed: prompt contents, lengths, output budgets and
arrival staggering all come from one RandomState, so a serving run is
reproducible end-to-end (the checkpoint→serve round-trip test and the
CLI's --seed rely on this).

Arrivals are expressed in VIRTUAL engine steps (``Request.arrival_step``)
— the engine's admission gate compares against its tick counter, which
makes "staggered arrivals" deterministic regardless of host speed.  A
wall-clock producer thread can instead submit these same requests late
and leave ``arrival_step`` None.

Overload is deterministic too: ``burst`` groups arrivals — requests
land ``burst`` at a time every ``stagger`` ticks, so a burst sized past
``num_slots + max_pending`` reproducibly exercises the shed path, and
``deadline_steps`` gives every request a virtual-step deadline
(``arrival + deadline_steps``) so the timeout path needs no wall-clock
sleeps.
"""

from __future__ import annotations

import time
import zlib
from typing import List, Optional, Tuple

import numpy as np

from apex_example_tpu_torch.serve.queue import Request


def substream(seed: int, index: int) -> int:
    """Derive the ``index``-th independent seed from a base ``seed``.

    Replica i of a fleet handed one ``--seed`` derives
    ``substream(seed, i)``, so the replicas serve different prompt sets
    rather than one workload N times: disjoint with overwhelming
    probability across indices, yet a pure function of (seed, index),
    so fleet workloads stay exactly reproducible.  ``index`` 0 is NOT
    the identity on purpose — a one-replica substreamed run must not
    silently alias the un-substreamed workload for a different reason
    than replica 1 differs from it.  stdlib-only (crc32), so jax-free
    consumers can mirror the derivation."""
    if index < 0:
        raise ValueError(f"substream index must be >= 0, got {index}")
    return zlib.crc32(f"{seed}/{index}".encode()) & 0x7FFFFFFF


def synthetic_requests(n: int, *, vocab_size: int, seed: int = 0,
                       prompt_len: Tuple[int, int] = (4, 12),
                       max_new: Tuple[int, int] = (4, 16),
                       temperature: float = 0.0, top_k: int = 0,
                       eos_id: Optional[int] = None,
                       stagger: int = 0, burst: int = 1,
                       deadline_steps: Optional[int] = None,
                       deadline_s: Optional[float] = None,
                       shared_prefix: int = 0,
                       seed_substream: Optional[int] = None,
                       repetitive: bool = False
                       ) -> List[Request]:
    """``n`` requests with uniform prompt/output lengths in the given
    inclusive ranges; request i arrives at virtual step
    ``(i // burst) * stagger`` (stagger 0 = all at once; burst b = b
    arrivals per wave — the deterministic overload mode).  With
    ``deadline_steps`` each request must finish within that many engine
    ticks of its arrival; ``deadline_s`` is the wall-clock TTL.

    ``shared_prefix`` > 0 prepends one common N-token "system prompt"
    (drawn once from the same RandomState) to every request's sampled
    prompt — the workload mode that makes the paged KV cache's
    copy-on-write prefix sharing measurable: the common blocks are
    computed once and refcounted across requests
    (``prompt_len`` still sizes only the per-request sampled part).

    ``seed_substream`` (fleet mode): replica index i derives
    its RandomState from ``substream(seed, i)`` instead of ``seed``
    directly, so N replicas sharing one base seed serve DISJOINT yet
    individually-deterministic workloads (``--seed-substream`` on
    serve.py).

    ``repetitive``: templated prompts with self-repeating
    spans — each request draws a short motif (3–6 tokens) from the same
    RandomState and tiles it to the sampled prompt length, the
    structured traffic shape (boilerplate templates, copy-through
    fields) that makes prompt-lookup speculative drafting measurable.
    Same substream machinery, so ``--repetitive`` workloads are exactly
    as deterministic per (seed, substream) as the uniform ones."""
    if n < 1:
        raise ValueError(f"need n >= 1 requests, got {n}")
    if prompt_len[0] < 1 or prompt_len[0] > prompt_len[1]:
        raise ValueError(f"bad prompt_len range {prompt_len}")
    if max_new[0] < 1 or max_new[0] > max_new[1]:
        raise ValueError(f"bad max_new range {max_new}")
    if burst < 1:
        raise ValueError(f"burst must be >= 1, got {burst}")
    if deadline_steps is not None and deadline_steps < 1:
        raise ValueError(f"deadline_steps must be >= 1, got "
                         f"{deadline_steps}")
    if shared_prefix < 0:
        raise ValueError(f"shared_prefix must be >= 0, got "
                         f"{shared_prefix}")
    rs = np.random.RandomState(seed if seed_substream is None
                               else substream(seed, seed_substream))
    prefix = rs.randint(0, vocab_size, size=(shared_prefix,)).tolist() \
        if shared_prefix else []
    out = []
    for i in range(n):
        p = int(rs.randint(prompt_len[0], prompt_len[1] + 1))
        m = int(rs.randint(max_new[0], max_new[1] + 1))
        if repetitive:
            motif_len = int(rs.randint(3, 7))
            motif = rs.randint(0, vocab_size,
                               size=(motif_len,)).tolist()
            reps = -(-p // motif_len)           # ceil division
            body = (motif * reps)[:p]
        else:
            body = rs.randint(0, vocab_size, size=(p,)).tolist()
        prompt = prefix + body
        arrival = (i // burst) * stagger if stagger else None
        # Client-side submission stamp: the request is BUILT here, then
        # handed to the queue — a --trace timeline renders the
        # loadgen->queue handoff as its own span (Request.t_submit).
        # For arrival_step-gated requests RequestQueue.mature()
        # re-stamps BOTH clocks at the virtual gate (the build->gate
        # delay is deliberate staggering, not handoff), so a real
        # submit span survives only on ungated wall-clock submissions.
        out.append(Request(prompt=prompt, max_new_tokens=m,
                           temperature=temperature, top_k=top_k,
                           eos_id=eos_id,
                           arrival_step=arrival,
                           deadline_step=(arrival or 0) + deadline_steps
                           if deadline_steps is not None else None,
                           deadline_s=deadline_s,
                           t_submit=time.perf_counter()))
    return out


def parse_range(spec: str, name: str) -> Tuple[int, int]:
    """CLI range syntax: "8" (fixed) or "4:12" (inclusive range)."""
    parts = spec.split(":")
    try:
        if len(parts) == 1:
            lo = hi = int(parts[0])
        elif len(parts) == 2:
            lo, hi = int(parts[0]), int(parts[1])
        else:
            raise ValueError
    except ValueError:
        raise ValueError(f"--{name} wants N or MIN:MAX, got {spec!r}")
    if lo < 1 or lo > hi:
        raise ValueError(f"--{name}: bad range {lo}:{hi}")
    return lo, hi
