"""The continuous-batching scheduler loop: port of
apex_example_tpu/serve/engine.py (role "both").

One engine tick = expire + admit + step + harvest:

1. **expire/shed** — stamp virtual arrivals, shed the backlog overflow
   (``RequestQueue(max_pending=...)``), expire queued requests whose
   deadline passed, and deadline-evict decoding slots.
2. **admit** — pop admissible requests into free slots, gated by the
   worst-case KV block budget as well as the slot count (serve/slots.py):
   out-of-blocks is deterministic head-of-line queueing, and a request
   the engine could never serve terminates with status "rejected".
3. **step** — one paged forward advances every live slot: a slot inside
   its prompt feeds up to ``block_size`` prompt tokens (chunked prefill),
   a decoding slot its previously sampled token.  Sampling reads the
   logits after each slot's last real token.
4. **harvest** — EOS / length completions, evictions, records.  Per-slot
   host work is exception-contained, and a non-finite-logits guard fails
   the affected slots instead of feeding garbage back into the cache.

The tick makes ONE host sync: the ``.cpu()`` of the sampled tokens and the
finiteness mask, stacked into one tensor.  The engine sets
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False when it is built: the JAX
reference its numbers are held against computes in full fp32.

Not ported yet (later slices): speculation, tenants, meshes, quantization,
prefill/decode roles and KV handoff, migration, drain, fault drills,
tracing and the tick profiler.
"""

from __future__ import annotations

import time
import traceback
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from apex_example_tpu_torch.models.bert import paged_step
from apex_example_tpu_torch.models.gpt import sample_tokens
from apex_example_tpu_torch.obs.metrics import Histogram, nearest_rank
from apex_example_tpu_torch.serve.queue import (STATUSES, Completion,
                                                Request, RequestQueue)
from apex_example_tpu_torch.serve.slots import BlockPool


def _wall() -> float:
    """Wall clock, for the ``time`` field of emitted records only; every
    duration is a difference of ``perf_counter`` readings."""
    return time.time()


def _pct_dict(vals_ms: List[float]) -> Dict[str, float]:
    s = sorted(vals_ms)
    return {"p50": round(nearest_rank(s, 50), 3),
            "p95": round(nearest_rank(s, 95), 3),
            "max": round(s[-1], 3) if s else 0.0}


class SlotFailure(RuntimeError):
    """Raised inside one slot's harvest when its sampled token is
    degenerate (out-of-vocab / NaN-logits fallout) — contained to that
    slot like any other per-slot exception."""


def request_complete_record(comp: Completion,
                            run_id: Optional[str] = None) -> Dict[str, Any]:
    """The ``request_complete`` record for one ok completion."""
    rec: Dict[str, Any] = {
        "record": "request_complete",
        "time": _wall(),
        "request_id": comp.request.uid,
        "prompt_tokens": len(comp.request.prompt),
        "output_tokens": len(comp.tokens),
        "ttft_ms": round((comp.ttft_s or 0.0) * 1e3, 3),
        "tpot_ms": round(comp.tpot_s * 1e3, 3),
        "finish_reason": comp.finish_reason,
        "slot": comp.slot,
        "queue_wait_ms": round((comp.queue_wait_s or 0.0) * 1e3, 3),
        "e2e_ms": round(comp.e2e_s * 1e3, 3),
        "admitted_step": comp.admitted_step,
        "finished_step": comp.finished_step,
        "temperature": float(comp.request.temperature),
        "top_k": int(comp.request.top_k),
    }
    if run_id:
        rec["run_id"] = run_id
    return rec


def request_failed_record(comp: Completion,
                          run_id: Optional[str] = None) -> Dict[str, Any]:
    """The ``request_failed`` record for a timeout / cancelled / failed /
    rejected completion."""
    rec: Dict[str, Any] = {
        "record": "request_failed",
        "time": _wall(),
        "request_id": comp.request.uid,
        "status": comp.status,
        "prompt_tokens": len(comp.request.prompt),
        "output_tokens": len(comp.tokens),
        "failed_step": comp.finished_step,
    }
    if comp.slot >= 0:
        rec["slot"] = comp.slot
        rec["admitted_step"] = comp.admitted_step
    if comp.queue_wait_s is not None:
        rec["queue_wait_ms"] = round(comp.queue_wait_s * 1e3, 3)
    rec["e2e_ms"] = round(comp.e2e_s * 1e3, 3)
    if comp.error:
        rec["error"] = comp.error
    if run_id:
        rec["run_id"] = run_id
    return rec


class ServeEngine:
    """Continuous-batching engine over the port's GPT model.

    ``model`` carries its weights and its device; the engine's KV arenas
    and sampling generator (seeded from ``seed``) live on that device.
    ``block_size`` sets both the arena granularity and the chunked-prefill
    width; ``num_blocks`` defaults to dense capacity.  ``sink`` (an
    obs.metrics.JsonlSink), when given, receives one ``request_complete``
    / ``request_failed`` / ``shed`` record per terminated request; the
    caller writes the run header and the final ``serve_summary``.
    """

    def __init__(self, model, *, num_slots: int = 4, max_len: int = 128,
                 block_size: int = 8, num_blocks: Optional[int] = None,
                 seed: int = 0, queue: Optional[RequestQueue] = None,
                 sink=None, run_id: Optional[str] = None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model = model.eval()
        self.device = model.word_embeddings.weight.device
        self.pool = BlockPool(model, num_slots, max_len,
                              block_size=block_size, num_blocks=num_blocks)
        self.vocab_size = int(model.vocab_size)
        self.chunk = self.pool.block_size
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.queue = queue if queue is not None else RequestQueue()
        self.sink = sink
        self.run_id = run_id
        self.step_count = 0
        self.compute_steps = 0
        self.idle_ticks = 0
        self.completions: List[Completion] = []
        self.counts: Dict[str, int] = {s: 0 for s in STATUSES}
        self._t0 = time.perf_counter()
        self._tokens_out = 0
        self._occupancy_sum = 0
        self._occ_hist = Histogram("serve.slots_live")
        self._kv_hist = Histogram("serve.kv_bytes_live")
        self._blk_hist = Histogram("serve.blocks_live")
        self._committed_hist = Histogram("serve.kv_bytes_committed")

    # ---------------------------------------------------------- intake

    def submit(self, request: Request) -> None:
        self.queue.submit(request)

    def cancel(self, uid: str) -> bool:
        """Cancel a request by uid: a queued one terminates immediately
        (status "cancelled", never admitted); a decoding one is evicted
        mid-flight with its partial tokens.  False if the uid is unknown
        or already terminal."""
        req = self.queue.cancel(uid)
        if req is not None:
            self._terminal_unadmitted(req, "cancelled")
            return True
        for i in self.pool.live:
            if self.pool.slots[i].request.uid == uid:
                self._terminal_slot(i, "cancelled", time.perf_counter())
                return True
        return False

    # ------------------------------------------------------------ tick

    def step(self) -> bool:
        """One engine tick.  Returns True when a model step ran (some
        slot was live); False is an idle tick (virtual time still
        advances, so ``arrival_step`` gates keep maturing)."""
        pool = self.pool
        step = self.step_count
        now = time.perf_counter()
        self.queue.mature(step)
        # Expire BEFORE evaluating the bound: requests already dead in the
        # queue must not count against max_pending.
        for req in self.queue.expire(step, now):
            self._terminal_unadmitted(req, "timeout")
        shed = self.queue.shed_overflow(step)
        if shed:
            pending = self.queue.arrived_pending(step)
            for req in shed:
                self._terminal_unadmitted(req, "shed", pending=pending)
        for i in list(pool.live):
            if pool.slots[i].request.expired(step, now):
                self._terminal_slot(i, "timeout", now)
        while pool.free_count:
            req = self.queue.pop(step)
            if req is None:
                break
            if not pool.fits(req):
                self._terminal_unadmitted(req, "rejected")
                continue
            if not pool.can_admit(req):
                # Out of KV blocks: the head waits at the queue front
                # until evictions free its worst-case budget.
                self.queue.push_front(req)
                break
            pool.admit(req, step)
        live = pool.live
        if not live:
            self.idle_ticks += 1
            self.step_count += 1
            return False

        S, C = pool.num_slots, self.chunk
        tok = np.zeros((S, C), np.int64)
        fill = np.zeros((S,), np.int64)
        n_new = np.zeros((S,), np.int64)
        cow_src = np.full((S,), -1, np.int64)
        cow_dst = np.full((S,), -1, np.int64)
        temps = np.zeros((S,), np.float32)
        ks = np.zeros((S,), np.int64)
        for i in live:
            slot = pool.slots[i]
            n = min(C, slot.n_prompt - slot.cursor) if slot.prefilling \
                else 1
            tok[i, :n] = slot.tokens[slot.cursor:slot.cursor + n]
            fill[i] = slot.cursor
            n_new[i] = n
            # Map/COW the blocks this slot writes this tick (drawn from
            # the budget reserved at admission, so it cannot run out).
            cow_src[i], cow_dst[i] = pool.stage_writes(i, n)
            temps[i] = slot.request.temperature
            ks[i] = slot.request.top_k
        nxt, finite = self._dispatch(tok, fill, n_new, cow_src, cow_dst,
                                     temps, ks)
        now = time.perf_counter()

        for i in live:
            slot = pool.slots[i]
            reason = None
            try:
                pool.commit_writes(i, int(n_new[i]))
                if slot.prefilling:
                    continue           # prompt chunk fed; output discarded
                out = int(nxt[i])
                if not finite[i]:
                    raise SlotFailure(
                        f"non-finite logits in slot {i} — NaN/Inf reached "
                        "the sampled-token path (poisoned params or cache "
                        "row)")
                if not 0 <= out < self.vocab_size:
                    raise SlotFailure(
                        f"degenerate sampled token {out} (vocab "
                        f"{self.vocab_size}) — poisoned sampling path")
                if slot.n_generated == 0:
                    slot.t_first_token = now
                slot.tokens.append(out)
                slot.n_generated += 1
                self._tokens_out += 1
                req = slot.request
                if req.eos_id is not None and out == req.eos_id:
                    reason = "eos"
                elif slot.n_generated >= pool.max_new_for(req):
                    reason = "length"
            except Exception as e:   # noqa: BLE001 — slot-level isolation
                # One request's failure must not take down the batch: the
                # other slots' caches and host state are untouched.
                self._terminal_slot(i, "failed", now, error=e)
                continue
            # Terminal transitions run OUTSIDE the isolation try: a sink
            # failure there is an engine-level fault, not a slot's.
            if reason is not None:
                self._finish(i, reason, now)
        self.compute_steps += 1
        self._occupancy_sum += len(live)
        # Gauge the tick AFTER harvest: what is resident at the boundary.
        per_block = pool.block_size * pool.kv_bytes_per_token()
        self._occ_hist.observe(len(pool.live))
        self._kv_hist.observe(pool.kv_bytes_live())
        self._blk_hist.observe(pool.blocks_live())
        self._committed_hist.observe(pool.blocks_committed() * per_block)
        self.step_count += 1
        return True

    def _dispatch(self, tok, fill, n_new, cow_src, cow_dst, temps, ks):
        """The tick's device work: the paged forward (COW, scatter, gather
        and attention in every layer), sampling from each slot's last real
        lane, and the finiteness mask — then the tick's one host sync."""
        pool = self.pool
        step = paged_step(pool.arenas, tok, pool.table, fill, n_new,
                          cow_src, cow_dst, self.device)
        with torch.no_grad():
            logits = self.model(step.tokens, step)
            last = torch.take_along_dim(
                logits, step.last_lane[:, None, None], dim=1)[:, 0]
            nxt = sample_tokens(last, temps, ks, self.generator)
            finite = torch.isfinite(last).all(-1)
            host = torch.stack([nxt, finite.long()]).cpu().numpy()
        return host[0], host[1].astype(bool)

    # ------------------------------------------------------- terminals

    def _finish(self, idx: int, reason: str, now: float) -> None:
        self._evict_terminal(idx, reason, "ok", now)

    def _terminal_slot(self, idx: int, status: str, now: float,
                       error: Optional[BaseException] = None) -> None:
        """Evict a live slot with a non-ok status (timeout / cancelled /
        failed): partial tokens kept, ``request_failed`` emitted."""
        self._evict_terminal(idx, status, status, now, error=error)

    def _evict_terminal(self, idx: int, finish_reason: str, status: str,
                        now: float,
                        error: Optional[BaseException] = None) -> None:
        """The one terminal sequence for an admitted request: build the
        Completion, account it, evict, emit the record."""
        slot = self.pool.slots[idx]
        digest = None
        if error is not None:
            tb = traceback.format_exception(type(error), error,
                                            error.__traceback__)
            digest = f"{type(error).__name__}: {error}"
            tail = "".join(tb)[-2000:]
            digest = f"{digest}\n{tail}" if tail else digest
        comp = Completion(
            request=slot.request,
            tokens=slot.tokens[slot.n_prompt:],
            finish_reason=finish_reason,
            slot=idx,
            admitted_step=slot.admitted_step,
            finished_step=self.step_count,
            t_admitted=slot.t_admitted,
            t_first_token=slot.t_first_token,
            t_finish=now,
            status=status,
            error=digest)
        self.completions.append(comp)
        self.counts[status] += 1
        self.pool.evict(idx)
        if self.sink is not None:
            record = request_complete_record if status == "ok" \
                else request_failed_record
            self.sink.write(record(comp, self.run_id))

    def _terminal_unadmitted(self, req: Request, status: str,
                             pending: Optional[int] = None) -> None:
        """Terminate a never-admitted request: shed at arrival, expired
        in the queue, cancelled while queued, or rejected as unservable
        (``pending`` is the tick's post-shed arrived backlog)."""
        now = time.perf_counter()
        comp = Completion(
            request=req, tokens=[], finish_reason=status, slot=-1,
            admitted_step=-1, finished_step=self.step_count,
            t_admitted=None, t_first_token=None, t_finish=now,
            status=status)
        self.completions.append(comp)
        self.counts[status] += 1
        if self.sink is None:
            return
        if status == "shed":
            rec: Dict[str, Any] = {
                "record": "shed", "time": _wall(), "request_id": req.uid,
                "reason": "queue_full", "step": self.step_count,
                "pending": pending if pending is not None
                else self.queue.arrived_pending(self.step_count)}
            if self.queue.max_pending is not None:
                rec["max_pending"] = self.queue.max_pending
            if self.run_id:
                rec["run_id"] = self.run_id
            self.sink.write(rec)
        else:
            self.sink.write(request_failed_record(comp, self.run_id))

    # ------------------------------------------------------------ loop

    def run(self, max_steps: Optional[int] = None) -> List[Completion]:
        """Drive ticks until the queue is drained and every slot is free
        (or ``max_steps`` ticks)."""
        while max_steps is None or self.step_count < max_steps:
            if self.queue.drained() and not self.pool.any_live():
                break
            self.step()
        return self.completions

    # --------------------------------------------------------- metrics

    def summary_record(self) -> Dict[str, Any]:
        """The ``serve_summary`` for everything terminated so far (the
        caller writes it to the sink): throughput, per-status counts,
        availability (ok / every terminal status the server owned), the
        block-pool gauges and the latency percentiles."""
        duration = time.perf_counter() - self._t0
        comps = self.completions
        ok = [c for c in comps if c.status == "ok"]
        owned = len(comps) - self.counts["drained"] \
            - self.counts["handoff"] - self.counts["migrated"]
        pool = self.pool
        rec: Dict[str, Any] = {
            "record": "serve_summary",
            "time": _wall(),
            "requests": len(comps),
            "output_tokens": self._tokens_out,
            "tokens_per_sec": round(self._tokens_out / max(duration, 1e-9),
                                    1),
            "steps": self.step_count,
            "compute_steps": self.compute_steps,
            "slots": pool.num_slots,
            "max_len": pool.max_len,
            "block_size": pool.block_size,
            "blocks_total": pool.num_blocks,
            "duration_s": round(duration, 3),
            "completed": self.counts["ok"],
            "timed_out": self.counts["timeout"],
            "shed": self.counts["shed"],
            "cancelled": self.counts["cancelled"],
            "failed": self.counts["failed"],
            "drained": self.counts["drained"],
            "rejected": self.counts["rejected"],
            "prefix_hit_rate": round(pool.prefix_hit_rate(), 4),
            "cow_copies": pool.cow_copies,
            "availability": round(self.counts["ok"] / owned, 3)
            if owned else 1.0,
            "kv_dtype": pool.kv_dtype,
            "weight_dtype": str(
                self.model.word_embeddings.weight.dtype).replace(
                    "torch.", ""),
            "kv_bytes_per_token": pool.kv_bytes_per_token(),
            "kv_bytes_per_token_bf16": pool.kv_bytes_per_token_bf16(),
            "role": "both",
            "kv_bytes_reserved": pool.kv_bytes_reserved(),
            "idle_ticks": self.idle_ticks,
        }
        if self.compute_steps:
            rec["occupancy"] = round(
                self._occupancy_sum / (self.compute_steps
                                       * pool.num_slots), 3)
            kv = self._kv_hist.summary()
            blk = self._blk_hist.summary()
            rec["slot_occupancy"] = self._occ_hist.summary()
            rec["kv_bytes_live"] = kv
            rec["blocks_live"] = blk
            rec["kv_bytes_committed"] = self._committed_hist.summary()
            held = blk["mean"] * pool.block_size \
                * pool.kv_bytes_per_token()
            if held:
                rec["kv_waste_pct"] = round(
                    max(0.0, 100.0 * (1.0 - kv["mean"] / held)), 2)
        if ok:
            rec["ttft_ms"] = _pct_dict([c.ttft_s * 1e3 for c in ok])
            rec["tpot_ms"] = _pct_dict([c.tpot_s * 1e3 for c in ok])
            rec["queue_wait_ms"] = _pct_dict(
                [c.queue_wait_s * 1e3 for c in ok])
        if self.run_id:
            rec["run_id"] = self.run_id
        return rec
