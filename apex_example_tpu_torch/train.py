"""The language-model trainer: port of train.py's single-device BERT path
(``_lm_main_impl`` :1014 with the C4 recipe: BERT MLM, FusedLAMB, amp O0).
Run it as ``python -m apex_example_tpu_torch.train``.

    # bert_tiny on the CPU (the kernels' plain versions), records to JSONL
    python -m apex_example_tpu_torch.train --device cpu --arch bert_tiny \\
        --batch-size 8 --seq-len 16 --steps-per-epoch 5 --print-freq 1 \\
        --metrics-jsonl train.jsonl
    python tools/metrics_lint.py train.jsonl --require-summary

    # bert_base on the card
    python -m apex_example_tpu_torch.train --arch bert_base --opt lamb

Weights are random from ``--seed`` and every batch is synthetic
(data/synthetic.mlm_batch of the global step), as in train.py.  It runs on
the card unless ``--device cpu`` is given, and raises when CUDA is asked
for and absent.  The flags are train.py's for this path; those of paths
not ported yet (other archs, optimizers and opt levels, parallelism,
checkpoints, diagnostics) are absent, so argparse rejects them.

Each printed step is train.py's line (:1749-1752):
``epoch E step i/N loss L (avg) R tok/s scale 1``.  With ``--metrics-jsonl``
the run writes a run_header, one step record per step and a run_summary
(obs/telemetry.py), which the JAX package's tools read unchanged.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from apex_example_tpu_torch import resolve_device
from apex_example_tpu_torch.data.synthetic import mlm_batch
from apex_example_tpu_torch.engine import create_train_state, make_train_step
from apex_example_tpu_torch.models.bert import bert_base, bert_tiny
from apex_example_tpu_torch.obs.metrics import JsonlSink
from apex_example_tpu_torch.obs.telemetry import TelemetryEmitter
from apex_example_tpu_torch.optim.fused import FusedLAMB
from apex_example_tpu_torch.optim.schedules import build_schedule
from apex_example_tpu_torch.utils.meters import AverageMeter, Throughput
from apex_example_tpu_torch.workloads import mlm_loss

ARCHS = {"bert_base": bert_base, "bert_tiny": bert_tiny}
ARCH_MAX_POSITION = {"bert_base": 512, "bert_tiny": 128}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m apex_example_tpu_torch.train",
        description="BERT MLM pretraining with FusedLAMB (PyTorch port)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on: cuda (default) or cpu")
    p.add_argument("--arch", "-a", default="bert_base", choices=list(ARCHS))
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--vocab-size", type=int, default=30522,
                   help="vocabulary of bert_base (bert_tiny keeps 256)")
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
    p.add_argument("--opt", default="lamb", choices=["lamb"])
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


def build_model(args, device):
    kw = {"seed": args.seed, "device": device}
    if args.arch == "bert_base":
        kw["vocab_size"] = args.vocab_size
    if args.seq_len > ARCH_MAX_POSITION[args.arch]:
        kw["max_position"] = args.seq_len
    return ARCHS[args.arch](**kw)


def build_optimizer(args, params) -> FusedLAMB:
    """``--opt lamb`` of train.py's ``build_optimizer`` (:559): FusedLAMB
    with the schedule and weight decay, clip at max_grad_norm 1.0."""
    return FusedLAMB(params, lr=build_lr(args),
                     weight_decay=args.weight_decay)


def batch_fn(args, vocab_size: int, step: int, device):
    """The MLM batch of global step ``step``: (ids, (labels, weights))."""
    ids, labels, w = mlm_batch(step, batch_size=args.batch_size,
                               seq_len=args.seq_len, vocab_size=vocab_size,
                               mask_token_id=vocab_size - 1, seed=args.seed)
    to = lambda a: torch.from_numpy(a).to(device)       # noqa: E731
    return to(ids), (to(labels), to(w))


def run_train(args) -> int:
    device = resolve_device(args.device)
    for flag in ("epochs", "steps_per_epoch", "batch_size", "seq_len",
                 "print_freq"):
        if getattr(args, flag) < 1:
            raise SystemExit(f"--{flag.replace('_', '-')} must be >= 1")
    model = build_model(args, device)
    optimizer = build_optimizer(args, model.parameters())
    state = create_train_state(model, optimizer)
    step_fn = make_train_step(mlm_loss)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model {args.arch}: {n_params} parameters in "
          f"{len(optimizer.params)} tensors, device {device}, opt lamb, "
          f"opt-level O0, params from random init (seed {args.seed})")

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
                state, metrics = step_fn(state, batch)
                global_step += 1
                if emitter is not None:
                    emitter.on_step(global_step=global_step, epoch=epoch,
                                    metrics=metrics, items=tokens,
                                    t_start=t0)
                thr.step(tokens)
                if (i + 1) % args.print_freq == 0 \
                        or i + 1 == args.steps_per_epoch:
                    losses.update(float(metrics["loss"]))
                    print(f"epoch {epoch} step {i + 1}/"
                          f"{args.steps_per_epoch} {losses} "
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
