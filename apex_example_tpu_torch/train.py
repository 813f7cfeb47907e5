"""The language-model trainer: port of train.py's single-device LM path
(``_lm_main_impl`` :1014) at amp O0: BERT MLM (C4), GPT causal LM and
Transformer-XL (C5) with its memory carried from step to step, trained with
FusedLAMB or FusedAdam.  Run it as ``python -m apex_example_tpu_torch.train``.

    # bert_tiny on the CPU (the kernels' plain versions), records to JSONL
    python -m apex_example_tpu_torch.train --device cpu --arch bert_tiny \\
        --batch-size 8 --seq-len 16 --steps-per-epoch 5 --print-freq 1 \\
        --metrics-jsonl train.jsonl
    python tools/metrics_lint.py train.jsonl --require-summary

    # on the card: C4's model with LAMB, C5's and GPT's with Adam
    python -m apex_example_tpu_torch.train --arch bert_base --opt lamb
    python -m apex_example_tpu_torch.train --arch transformer_xl --opt adam
    python -m apex_example_tpu_torch.train --arch gpt_base --opt adam

Weights are random from ``--seed`` and every batch is synthetic
(data/synthetic.py of the global step), as in train.py: ``mlm_batch`` for
BERT, ``lm_batch`` sliced into inputs ``[:, :-1]`` and targets ``[:, 1:]``
for GPT and Transformer-XL (:1262-1267).  ``--vocab-size`` applies to
bert_base, gpt_base and transformer_xl (:1215-1216).  Transformer-XL's
memory starts at ``init_mems(batch)`` and is carried from step to step
(:1536-1537, :1729-1732); its step clips the grads to ``--max-grad-norm``
before the optimizer (workloads.make_txl_train_step).  It runs on the card
unless ``--device cpu`` is given, and raises when CUDA is asked for and
absent.  The flags are train.py's for this path; those of paths not ported
yet (other archs, optimizers and opt levels, eval, grad accumulation,
parallelism, checkpoints, diagnostics) are absent, so argparse rejects them.

Each printed step is train.py's line (:1747-1752):
``epoch E step i/N loss L (avg) [ppl P ]R tok/s scale 1``, with ``ppl``
where the step reports it (Transformer-XL).  With ``--metrics-jsonl`` the
run writes a run_header, one step record per step and a run_summary
(obs/telemetry.py), which the JAX package's tools read unchanged.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from apex_example_tpu_torch import resolve_device
from apex_example_tpu_torch.data.synthetic import lm_batch, mlm_batch
from apex_example_tpu_torch.engine import create_train_state, make_train_step
from apex_example_tpu_torch.models.bert import bert_base, bert_tiny
from apex_example_tpu_torch.models.gpt import gpt_base, gpt_tiny
from apex_example_tpu_torch.models.transformer_xl import (
    transformer_xl_base, transformer_xl_tiny)
from apex_example_tpu_torch.obs.metrics import JsonlSink
from apex_example_tpu_torch.obs.telemetry import TelemetryEmitter
from apex_example_tpu_torch.optim.fused import FusedAdam, FusedLAMB
from apex_example_tpu_torch.optim.schedules import build_schedule
from apex_example_tpu_torch.utils.meters import AverageMeter, Throughput
from apex_example_tpu_torch.workloads import (lm_loss, make_txl_train_step,
                                              mlm_loss)

ARCHS = {"bert_base": bert_base, "bert_tiny": bert_tiny,
         "gpt_base": gpt_base, "gpt_tiny": gpt_tiny,
         "transformer_xl": transformer_xl_base,
         "transformer_xl_tiny": transformer_xl_tiny}
ARCH_MAX_POSITION = {"bert_base": 512, "bert_tiny": 128,
                     "gpt_base": 1024, "gpt_tiny": 128}
VOCAB_ARCHS = ("bert_base", "gpt_base", "transformer_xl")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m apex_example_tpu_torch.train",
        description="BERT MLM, GPT and Transformer-XL LM training with "
                    "FusedLAMB or FusedAdam (PyTorch port)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on: cuda (default) or cpu")
    p.add_argument("--arch", "-a", default="bert_base", choices=list(ARCHS))
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--vocab-size", type=int, default=30522,
                   help="vocabulary of bert_base, gpt_base and "
                        "transformer_xl (the tiny archs keep 256)")
    p.add_argument("--max-grad-norm", type=float, default=0.25,
                   help="global-norm grad clip (transformer_xl)")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--steps-per-epoch", type=int, default=100)
    p.add_argument("--batch-size", "-b", type=int, default=256)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--lr-schedule", default="const",
                   choices=["const", "step", "cosine", "poly"])
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--lr-decay-epochs", default="",
                   help='comma epochs for step decay, e.g. "30,60,90" '
                        "(default: 1/3 and 2/3 of the run)")
    p.add_argument("--lr-gamma", type=float, default=0.1)
    p.add_argument("--lr-min", type=float, default=0.0)
    p.add_argument("--weight-decay", "--wd", type=float, default=1e-4)
    p.add_argument("--opt", default="lamb", choices=["lamb", "adam"])
    p.add_argument("--opt-level", default="O0", choices=["O0"])
    p.add_argument("--print-freq", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--metrics-jsonl", default="", metavar="PATH",
                   help="emit schema-valid step records to this JSONL")
    return p


def build_lr(args):
    """A float or a schedule f(step), as train.py's ``build_lr`` (:333)."""
    total = args.epochs * args.steps_per_epoch
    boundaries = [int(e) * args.steps_per_epoch
                  for e in args.lr_decay_epochs.split(",") if e]
    return build_schedule(args.lr_schedule, args.lr, total,
                          warmup_steps=args.warmup_steps,
                          boundaries=boundaries, gamma=args.lr_gamma,
                          min_lr=args.lr_min)


def is_txl(args) -> bool:
    return args.arch.startswith("transformer_xl")


def build_model(args, device):
    kw = {"seed": args.seed, "device": device}
    if args.arch in VOCAB_ARCHS:
        kw["vocab_size"] = args.vocab_size
    if args.seq_len > ARCH_MAX_POSITION.get(args.arch, args.seq_len):
        kw["max_position"] = args.seq_len
    return ARCHS[args.arch](**kw)


def build_optimizer(args, params):
    """``--opt lamb`` or ``adam`` of train.py's ``build_optimizer`` (:559):
    FusedLAMB (clip at max_grad_norm 1.0) or FusedAdam (AdamW), with the
    schedule and weight decay."""
    cls = FusedAdam if args.opt == "adam" else FusedLAMB
    return cls(params, lr=build_lr(args), weight_decay=args.weight_decay)


def batch_fn(args, vocab_size: int, step: int, device):
    """The batch of global step ``step``: (ids, (labels, weights)) for
    BERT, (inputs, targets) for GPT and Transformer-XL."""
    to = lambda a: torch.from_numpy(a).to(device)       # noqa: E731
    if args.arch.startswith("bert"):
        ids, labels, w = mlm_batch(step, batch_size=args.batch_size,
                                   seq_len=args.seq_len,
                                   vocab_size=vocab_size,
                                   mask_token_id=vocab_size - 1,
                                   seed=args.seed)
        return to(ids), (to(labels), to(w))
    toks = lm_batch(step, batch_size=args.batch_size, seq_len=args.seq_len,
                    vocab_size=vocab_size, seed=args.seed)
    return to(np.ascontiguousarray(toks[:, :-1])), \
        to(np.ascontiguousarray(toks[:, 1:]))


def run_train(args) -> int:
    device = resolve_device(args.device)
    for flag in ("epochs", "steps_per_epoch", "batch_size", "seq_len",
                 "print_freq"):
        if getattr(args, flag) < 1:
            raise SystemExit(f"--{flag.replace('_', '-')} must be >= 1")
    model = build_model(args, device)
    optimizer = build_optimizer(args, model.parameters())
    state = create_train_state(model, optimizer)
    mems = None
    if is_txl(args):
        step_fn = make_txl_train_step(args.max_grad_norm)
        mems = model.init_mems(args.batch_size)
    else:
        step_fn = make_train_step(
            mlm_loss if args.arch.startswith("bert") else lm_loss)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model {args.arch}: {n_params} parameters in "
          f"{len(optimizer.params)} tensors, device {device}, opt "
          f"{args.opt}, opt-level O0, params from random init (seed "
          f"{args.seed})")

    emitter = None
    if args.metrics_jsonl:
        emitter = TelemetryEmitter(JsonlSink(args.metrics_jsonl), device)
        emitter.run_header(config=vars(args), argv=sys.argv[1:],
                           arch=args.arch)
    tokens = args.batch_size * args.seq_len
    global_step = 0
    try:
        for epoch in range(args.epochs):
            losses = AverageMeter("loss")
            thr = Throughput(warmup_steps=2)
            for i in range(args.steps_per_epoch):
                batch = batch_fn(args, model.vocab_size, global_step, device)
                t0 = time.perf_counter()
                if mems is None:
                    state, metrics = step_fn(state, batch)
                else:
                    state, mems, metrics = step_fn(state, mems, batch)
                global_step += 1
                if emitter is not None:
                    emitter.on_step(global_step=global_step, epoch=epoch,
                                    metrics=metrics, items=tokens,
                                    t_start=t0)
                thr.step(tokens)
                if (i + 1) % args.print_freq == 0 \
                        or i + 1 == args.steps_per_epoch:
                    losses.update(float(metrics["loss"]))
                    extra = (f"ppl {float(metrics['ppl']):.1f} "
                             if "ppl" in metrics else "")
                    print(f"epoch {epoch} step {i + 1}/"
                          f"{args.steps_per_epoch} {losses} {extra}"
                          f"{thr.rate:.0f} tok/s "
                          f"scale {float(metrics['scale']):.0f}")
    finally:
        if emitter is not None:
            emitter.close()
    return 0


def main(argv=None) -> int:
    return run_train(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
