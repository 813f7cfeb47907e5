"""The port's serving stack held against the JAX package's, on the CPU.

- ``synthetic_requests``: the same seed gives the same requests;
- ``BlockPool``: the same host state (tables, refcounts, free lists,
  blocks live and committed, COW pairs) on a scripted admit / stage /
  commit / evict / prefix-match sequence;
- ``ServeEngine``: with converted gpt_tiny parameters both engines serve
  the same greedy workloads (staggered, mixed lengths; one with a shared
  prefix) with identical tokens, statuses and step counts.  Where a
  token differs, the JAX side's top-2 logit margin at that position must
  be below 1e-4 — a near-tie that fp32 sums taken in another order may
  flip; the test computes that margin, it does not loosen the match;
- an overload run and a deadline run end with the same per-status counts,
  and cancelling a queued and an in-flight request ends the same way;
- ``python -m apex_example_tpu_torch.serve --device cpu`` exits 0 and its
  stream passes tools/metrics_lint.py and tools/serve_report.py;
- without ``--device`` the entry point asks for CUDA and raises without it.
"""

import importlib.util
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_ref import flax_init
from apex_example_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from apex_example_tpu.serve import BlockPool as JaxBlockPool
from apex_example_tpu.serve import Request as JaxRequest
from apex_example_tpu.serve import RequestQueue as JaxRequestQueue
from apex_example_tpu.serve import ServeEngine as JaxServeEngine
from apex_example_tpu.serve import synthetic_requests as jax_synthetic
from apex_example_tpu_torch.convert import gpt_params_from_flax
from apex_example_tpu_torch.models.gpt import gpt_tiny
from apex_example_tpu_torch.serve import cli
from apex_example_tpu_torch.serve.engine import ServeEngine
from apex_example_tpu_torch.serve.loadgen import synthetic_requests
from apex_example_tpu_torch.serve.queue import Request, RequestQueue
from apex_example_tpu_torch.serve.slots import BlockPool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOTS, MAX_LEN, BS = 4, 32, 8
TIE_MARGIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: these tiny shapes gain
    nothing from intra-op threads, and the JAX package's wall-clock tests
    running beside them lose from the contention."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def models():
    jm = jax_gpt_tiny()
    params = flax_init(jm, jax.random.PRNGKey(1),
                       jnp.zeros((1, 4), jnp.int32))["params"]
    pm = gpt_tiny(device="cpu")
    pm.load_state_dict(gpt_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, pm


# ------------------------------------------------------------- loadgen

LOADS = [
    dict(seed=3, prompt_len=(3, 8), max_new=(3, 12), stagger=4),
    dict(seed=5, shared_prefix=10, burst=3, stagger=2, deadline_steps=7),
    dict(seed=0, seed_substream=2, repetitive=True, temperature=0.5,
         top_k=4, eos_id=9),
]


def _request_view(r):
    return (list(r.prompt), r.max_new_tokens, r.arrival_step,
            r.deadline_step, r.temperature, r.top_k, r.eos_id)


@pytest.mark.parametrize("kw", LOADS)
def test_synthetic_requests_identical(kw):
    want = jax_synthetic(12, vocab_size=256, **kw)
    got = synthetic_requests(12, vocab_size=256, **kw)
    assert [_request_view(r) for r in got] == \
        [_request_view(r) for r in want]


# ---------------------------------------------------------- block pool

def _drive_pool(pool, request_cls):
    """A scripted admit / stage / commit / evict sequence with prefix
    sharing and COW; returns the host state after every operation."""
    rs = np.random.RandomState(11)
    base = rs.randint(0, 256, size=12).tolist()
    snaps = []

    def snap(tag, extra=None):
        a = pool.alloc
        snaps.append((tag, extra, pool.table.tolist(), list(a.refcount),
                      list(a._free), list(a._reusable),
                      pool.blocks_live(), pool.blocks_committed(),
                      pool.cow_copies, round(pool.prefix_hit_rate(), 6),
                      [None if s is None else (s.cursor, s.n_mapped,
                                               s.reserved, s.shared_len)
                       for s in pool.slots]))

    def prefill(i, n_total, chunk=4):
        slot = pool.slots[i]
        while slot.cursor < n_total:
            n = min(chunk, n_total - slot.cursor)
            snap("stage", pool.stage_writes(i, n))
            pool.commit_writes(i, n)
            snap("commit")

    def decode(i, toks):
        for t in toks:
            snap("stage", pool.stage_writes(i, 1))
            pool.commit_writes(i, 1)
            pool.slots[i].tokens.append(t)
            snap("commit")

    a = pool.admit(request_cls(prompt=base, max_new_tokens=6), 0)
    snap("admit", a)
    prefill(a, len(base))
    decode(a, [7, 8, 9])
    # shares A's first two full blocks and part of a third: COW on write
    b = pool.admit(request_cls(prompt=base[:10] + [1, 2, 3],
                               max_new_tokens=4), 1)
    snap("admit", b)
    prefill(b, 13)
    pool.evict(a)
    snap("evict", a)
    # A's registered blocks parked in the reusable cache: a repeat of its
    # prompt maps them again
    c = pool.admit(request_cls(prompt=list(base), max_new_tokens=20), 2)
    snap("admit", c)
    prefill(c, len(base))
    big = request_cls(prompt=rs.randint(0, 256, size=20).tolist(),
                      max_new_tokens=11)
    snap("can_admit", (pool.fits(big), pool.can_admit(big)))
    for i in list(pool.live):
        pool.evict(i)
        snap("evict", i)
    return snaps


def test_block_pool_host_state_matches(models):
    jm, _, pm = models
    want = _drive_pool(JaxBlockPool(jm, SLOTS, MAX_LEN, block_size=4,
                                    num_blocks=12), JaxRequest)
    got = _drive_pool(BlockPool(pm, SLOTS, MAX_LEN, block_size=4,
                                num_blocks=12), Request)
    assert got == want
    assert any(tag == "stage" and extra != (-1, -1)
               for tag, extra, *_ in got)              # a COW happened


# -------------------------------------------------------------- engine

def _jax_engine(jm, params, reqs, queue=None):
    eng = JaxServeEngine(jm, params, num_slots=SLOTS, max_len=MAX_LEN,
                         block_size=BS, rng=jax.random.PRNGKey(0),
                         queue=queue)
    eng.queue.submit_all(reqs)
    eng.queue.close()
    eng.run(max_steps=2000)
    return eng


def _port_engine(pm, reqs, queue=None):
    eng = ServeEngine(pm, num_slots=SLOTS, max_len=MAX_LEN, block_size=BS,
                      seed=0, queue=queue)
    eng.queue.submit_all(reqs)
    eng.queue.close()
    eng.run(max_steps=2000)
    return eng


def _trail(eng, reqs):
    """Completions in termination order, requests named by their index."""
    index = {id(r): i for i, r in enumerate(reqs)}
    return [(index[id(c.request)], c.status, c.finish_reason, c.slot,
             c.admitted_step, c.finished_step) for c in eng.completions]


def _tokens(eng, reqs):
    by_req = {id(c.request): c.tokens for c in eng.completions}
    return [by_req[id(r)] for r in reqs]


def _jax_margin(jm, params, seq):
    """Top-2 logit margin of the JAX full forward after ``seq``."""
    logits = jm.apply({"params": params}, jnp.asarray([seq], jnp.int32),
                      train=False)[0, -1]
    top2 = np.sort(np.asarray(logits))[-2:]
    return float(top2[1] - top2[0])


def _assert_same_tokens(jm, params, reqs, want, got):
    for r, w, g in zip(reqs, want, got):
        if w == g:
            continue
        i = next(j for j, (a, b) in enumerate(zip(w, g)) if a != b)
        margin = _jax_margin(jm, params, list(r.prompt) + w[:i])
        assert margin < TIE_MARGIN, (
            f"request {list(r.prompt)}: token {i} differs ({w[i]} vs "
            f"{g[i]}) with a JAX top-2 margin of {margin}")


WORKLOADS = [
    dict(n=10, seed=3, prompt_len=(3, 12), max_new=(3, 12), stagger=3),
    dict(n=8, seed=4, prompt_len=(3, 6), max_new=(2, 10), stagger=2,
         shared_prefix=10),
]


@pytest.mark.parametrize("load", WORKLOADS)
def test_engine_serves_what_jax_serves(models, load):
    jm, params, pm = models
    kw = dict(load)
    n = kw.pop("n")
    jreqs = jax_synthetic(n, vocab_size=jm.vocab_size, **kw)
    preqs = synthetic_requests(n, vocab_size=pm.vocab_size, **kw)
    jeng = _jax_engine(jm, params, jreqs)
    peng = _port_engine(pm, preqs)
    assert len(peng.completions) == n
    assert _trail(peng, preqs) == _trail(jeng, jreqs)
    assert (peng.step_count, peng.compute_steps) == \
        (jeng.step_count, jeng.compute_steps)
    assert peng.counts == jeng.counts and peng.counts["ok"] == n
    _assert_same_tokens(jm, params, jreqs, _tokens(jeng, jreqs),
                        _tokens(peng, preqs))
    js, ps = jeng.summary_record(), peng.summary_record()
    for key in ("output_tokens", "prefix_hit_rate", "cow_copies",
                "kv_bytes_per_token", "blocks_total", "kv_bytes_reserved",
                "availability", "occupancy"):
        assert ps[key] == js[key], key
    if kw.get("shared_prefix"):
        assert ps["cow_copies"] > 0 and ps["prefix_hit_rate"] > 0


@pytest.mark.parametrize("kw,queue_kw", [
    (dict(seed=4, prompt_len=(3, 5), max_new=(3, 5), stagger=2, burst=8),
     dict(max_pending=4)),
    (dict(seed=6, prompt_len=(3, 9), max_new=(8, 20), stagger=1,
          deadline_steps=9), {}),
])
def test_overload_and_deadline_statuses_match(models, kw, queue_kw):
    jm, params, pm = models
    jreqs = jax_synthetic(12, vocab_size=jm.vocab_size, **kw)
    preqs = synthetic_requests(12, vocab_size=pm.vocab_size, **kw)
    jeng = _jax_engine(jm, params, jreqs, JaxRequestQueue(**queue_kw))
    peng = _port_engine(pm, preqs, RequestQueue(**queue_kw))
    assert peng.counts == jeng.counts
    assert sum(v for k, v in peng.counts.items() if k != "ok") > 0
    assert _trail(peng, preqs) == _trail(jeng, jreqs)


def test_cancel_queued_and_in_flight_matches(models):
    jm, params, pm = models

    def drive(eng, reqs):
        eng.queue.submit_all(reqs)
        eng.queue.close()
        for _ in range(3):
            eng.step()
        assert eng.cancel(reqs[5].uid)        # still queued: slots full
        assert eng.cancel(reqs[1].uid)        # decoding
        assert not eng.cancel("no-such-request")
        eng.run(max_steps=2000)
        return eng

    kw = dict(seed=8, prompt_len=(3, 6), max_new=(10, 14), stagger=0)
    jreqs = jax_synthetic(6, vocab_size=jm.vocab_size, **kw)
    preqs = synthetic_requests(6, vocab_size=pm.vocab_size, **kw)
    jeng = drive(JaxServeEngine(jm, params, num_slots=SLOTS,
                                max_len=MAX_LEN, block_size=BS,
                                rng=jax.random.PRNGKey(0)), jreqs)
    peng = drive(ServeEngine(pm, num_slots=SLOTS, max_len=MAX_LEN,
                             block_size=BS), preqs)
    assert peng.counts["cancelled"] == 2
    assert _trail(peng, preqs) == _trail(jeng, jreqs)
    _assert_same_tokens(jm, params, jreqs, _tokens(jeng, jreqs),
                        _tokens(peng, preqs))


# ----------------------------------------------------------------- CLI

def test_cli_on_cpu_writes_a_stream_the_tools_read(tmp_path):
    path = str(tmp_path / "port.jsonl")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "apex_example_tpu_torch.serve",
         "--device", "cpu", "--arch", "gpt_tiny", "--requests", "6",
         "--slots", "4", "--max-len", "32", "--prompt-len", "3:10",
         "--max-new", "3:8", "--shared-prefix", "8", "--max-pending", "3",
         "--burst", "6", "--metrics-jsonl", path],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("serve: 6 request(s)")
    assert "done: 3/6 completed" in proc.stdout
    assert "statuses: shed=3" in proc.stdout
    recs = [json.loads(line) for line in open(path)]
    assert recs[0]["record"] == "run_header"
    assert recs[0]["platform"] == "cpu" and recs[0]["schema"] == 18
    assert recs[-1]["record"] == "serve_summary"
    assert sum(r["record"] == "shed" for r in recs) == 3
    assert _load_tool("metrics_lint").lint(path)[0] == 0
    out = io.StringIO()
    assert _load_tool("serve_report").report(path, out=out) == 0
    assert "status: ok x3, shed x3" in out.getvalue()


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--arch", "gpt_tiny"])
    with pytest.raises(RuntimeError, match="cuda"):
        gpt_tiny()
    with pytest.raises(SystemExit):       # later slices' flags are absent
        cli.build_parser().parse_args(["--speculate", "2"])
