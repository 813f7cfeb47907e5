"""Continuous-batching inference CLI: port of serve.py (the synthetic,
role ``both`` path).  Run it as ``python -m apex_example_tpu_torch.serve``.

GPT weights random from ``--seed``, or a trained model's parameters
restored from ``--checkpoint-dir`` (the trainer's checkpoints,
utils/checkpoint.py ``restore_params``; ``--checkpoint-step``, default the
latest), copied into the serving model in place and cast to its dtypes
(serve.py :144-148, :743-745); a deterministic synthetic request stream
with staggered arrivals, and the engine of serve/engine.py over the
block-paged KV cache.  It runs on the card unless ``--device cpu`` is
given, and raises when CUDA is asked for and absent.

    # gpt_tiny smoke on the CPU, records to a JSONL stream
    python -m apex_example_tpu_torch.serve --device cpu --arch gpt_tiny \\
        --requests 8 --slots 4 --max-len 32 --metrics-jsonl serve.jsonl

    # serve what the trainer saved
    python -m apex_example_tpu_torch.train --arch gpt_base --opt adam \\
        --checkpoint-dir ck
    python -m apex_example_tpu_torch.serve --arch gpt_base \\
        --checkpoint-dir ck

    # then summarize it (the JAX package's tools read the stream as is)
    python tools/serve_report.py serve.jsonl

With ``--metrics-jsonl`` the run writes a ``run_header`` (platform "gpu" or
"cpu"), one ``request_complete`` / ``request_failed`` / ``shed`` record per
terminated request and a closing ``serve_summary``, all with fields that
apex_example_tpu/obs/schema.py declares.
"""

from __future__ import annotations

import argparse
import sys
import time
import uuid

import torch

from apex_example_tpu_torch import resolve_device
from apex_example_tpu_torch.models.gpt import gpt_base, gpt_tiny
from apex_example_tpu_torch.obs.metrics import SCHEMA_VERSION, JsonlSink
from apex_example_tpu_torch.serve.engine import ServeEngine
from apex_example_tpu_torch.serve.loadgen import (parse_range,
                                                  synthetic_requests)
from apex_example_tpu_torch.serve.queue import RequestQueue
from apex_example_tpu_torch.utils.checkpoint import (latest_step,
                                                     restore_params)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m apex_example_tpu_torch.serve",
        description="continuous-batching GPT inference (PyTorch port)")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on: cuda (default) or cpu")
    p.add_argument("--arch", default="gpt_tiny",
                   choices=["gpt_tiny", "gpt_base"])
    p.add_argument("--checkpoint-dir", default=None,
                   help="the trainer's checkpoint directory to restore the "
                        "parameters from (omit: random init from --seed)")
    p.add_argument("--checkpoint-step", type=int, default=None,
                   help="checkpoint step (default: the latest)")
    p.add_argument("--slots", type=int, default=4,
                   help="KV-cache slot count (the max decode batch)")
    p.add_argument("--max-len", type=int, default=None,
                   help="per-slot cache length (default: the model's "
                        "position table, capped at 128)")
    p.add_argument("--block-size", type=int, default=8,
                   help="KV arena block granularity in tokens: chunked "
                        "prefill feeds up to this many prompt tokens per "
                        "tick")
    p.add_argument("--num-blocks", type=int, default=None,
                   help="KV arena size in blocks per layer (default: "
                        "slots * ceil(max_len / block_size))")
    p.add_argument("--requests", type=int, default=16,
                   help="synthetic request count")
    p.add_argument("--prompt-len", default="4:12",
                   help="prompt length, N or MIN:MAX tokens")
    p.add_argument("--shared-prefix", type=int, default=0,
                   help="prepend one common N-token system prompt to every "
                        "request (the prefix-sharing workload)")
    p.add_argument("--max-new", default="4:16",
                   help="output budget, N or MIN:MAX tokens")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy, >0 samples")
    p.add_argument("--top-k", type=int, default=0,
                   help="restrict sampling to the k highest logits "
                        "(0 = full softmax)")
    p.add_argument("--eos-id", type=int, default=None,
                   help="token id that ends a request early")
    p.add_argument("--stagger", type=int, default=2,
                   help="virtual engine steps between request arrivals "
                        "(0 = all arrive at once)")
    p.add_argument("--burst", type=int, default=1,
                   help="arrivals per wave: B requests land together every "
                        "--stagger ticks")
    p.add_argument("--max-pending", type=int, default=None,
                   help="admission control: bound on the arrived request "
                        "backlog; overflow is shed deterministically")
    p.add_argument("--shed-policy", default="newest",
                   choices=["newest", "oldest"],
                   help="which side of the backlog to shed on overflow")
    p.add_argument("--deadline-steps", type=int, default=None,
                   help="per-request deadline in engine ticks after "
                        "arrival")
    p.add_argument("--steps", type=int, default=0,
                   help="engine tick cap (0 = run until drained)")
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the random weights, the workload and "
                        "sampling")
    p.add_argument("--metrics-jsonl", default=None,
                   help="emit schema-valid serving records to this JSONL")
    return p


def _run_header(sink: JsonlSink, args, device: torch.device,
                run_id: str) -> None:
    sink.write({
        "record": "run_header",
        "schema": SCHEMA_VERSION,
        "time": time.time(),
        "run_id": run_id,
        "num_devices": torch.cuda.device_count()
        if device.type == "cuda" else 1,
        "num_processes": 1,
        "process_index": 0,
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "config": {k: v for k, v in vars(args).items()
                   if isinstance(v, (str, int, float, bool, type(None)))},
        "argv": [str(a) for a in sys.argv],
        "arch": args.arch,
    })


def run_serve(args):
    """Build, drive, report.  Returns (completions, summary_record, rc);
    rc is 1 when requests were left unfinished at the --steps cap."""
    device = resolve_device(args.device)
    model = {"gpt_tiny": gpt_tiny, "gpt_base": gpt_base}[args.arch](
        seed=args.seed, device=device)
    source = f"random init (seed {args.seed})"
    if args.checkpoint_dir:
        step = args.checkpoint_step
        if step is None:
            step = latest_step(args.checkpoint_dir)
        model.load_state_dict(restore_params(args.checkpoint_dir, step))
        source = f"checkpoint {args.checkpoint_dir} (step {step})"
    max_len = args.max_len
    if max_len is None:
        max_len = min(model.max_position, 128)
    prompt_len = parse_range(args.prompt_len, "prompt-len")
    max_new = parse_range(args.max_new, "max-new")
    if args.shared_prefix < 0:
        raise SystemExit(f"--shared-prefix must be >= 0, got "
                         f"{args.shared_prefix}")
    if prompt_len[1] + args.shared_prefix >= max_len:
        raise SystemExit(f"--prompt-len max {prompt_len[1]} plus "
                         f"--shared-prefix {args.shared_prefix} must be "
                         f"< --max-len {max_len}")
    if args.block_size < 1:
        raise SystemExit(f"--block-size must be >= 1, got "
                         f"{args.block_size}")
    if args.num_blocks is not None and args.num_blocks < 1:
        raise SystemExit(f"--num-blocks must be >= 1, got "
                         f"{args.num_blocks}")

    sink = run_id = None
    if args.metrics_jsonl:
        sink = JsonlSink(args.metrics_jsonl)
        run_id = uuid.uuid4().hex[:12]
        _run_header(sink, args, device, run_id)
    try:
        engine = ServeEngine(model, num_slots=args.slots, max_len=max_len,
                             block_size=args.block_size,
                             num_blocks=args.num_blocks, seed=args.seed,
                             queue=RequestQueue(
                                 max_pending=args.max_pending,
                                 shed_policy=args.shed_policy),
                             sink=sink, run_id=run_id)
        requests = synthetic_requests(
            args.requests, vocab_size=model.vocab_size, seed=args.seed,
            prompt_len=prompt_len, max_new=max_new,
            temperature=args.temperature, top_k=args.top_k,
            eos_id=args.eos_id, stagger=args.stagger, burst=args.burst,
            deadline_steps=args.deadline_steps,
            shared_prefix=args.shared_prefix)
        engine.queue.submit_all(requests)
        engine.queue.close()
        pool = engine.pool
        print(f"serve: {args.requests} request(s)  arch={args.arch}  "
              f"role=both  slots={args.slots}  max_len={max_len}  "
              f"blocks={pool.num_blocks}x{pool.block_size}  "
              f"device={device}  params from {source}")
        completions = engine.run(max_steps=args.steps or None)
        summary = engine.summary_record()
        if sink is not None:
            sink.write(summary)
    finally:
        if sink is not None:
            sink.close()

    counts = engine.counts
    stranded = args.requests - len(completions)
    print(f"done: {counts['ok']}/{args.requests} completed  "
          f"out_tokens={summary['output_tokens']}  "
          f"tok/s={summary['tokens_per_sec']}  "
          f"steps={summary['steps']}  "
          f"occupancy={summary.get('occupancy', 0.0)}")
    nonsuccess = {k: v for k, v in counts.items() if k != "ok" and v}
    if nonsuccess:
        print("statuses: " + "  ".join(f"{k}={v}" for k, v in
                                       sorted(nonsuccess.items()))
              + f"  availability={summary['availability']}")
    for name in ("ttft_ms", "tpot_ms", "queue_wait_ms"):
        d = summary.get(name)
        if d:
            print(f"{name:14s} p50 {d['p50']:.1f}  p95 {d['p95']:.1f}  "
                  f"max {d['max']:.1f}")
    rc = 0
    if stranded:
        rc = 1
        print(f"WARNING: {stranded} request(s) unfinished at the --steps "
              f"cap", file=sys.stderr)
    return completions, summary, rc


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _, _, rc = run_serve(args)
    return rc
