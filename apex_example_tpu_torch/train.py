"""The trainer: port of train.py's single-device paths, run as
``python -m apex_example_tpu_torch.train``.

The image path (train.py ``main`` :628-994): ResNet-18/34/50/101/152 on
CIFAR- or ImageNet-shaped synthetic batches with FusedSGD (or FusedNovoGrad,
FusedAdagrad, FusedAdam, FusedLAMB) under amp O0-O3, with ``--loss-scale``
and ``--keep-batchnorm-fp32``, and ``--eval``.  C1 and C2 of the reference:

    python -m apex_example_tpu_torch.train --arch resnet18 \
        --dataset cifar10 --opt-level O0
    python -m apex_example_tpu_torch.train --arch resnet50 \
        --dataset imagenet --opt sgd --opt-level O2
    # apex's other fused optimizers, dynamic loss scaling and O3 included
    python -m apex_example_tpu_torch.train --arch resnet50 \
        --dataset imagenet --opt adagrad --lr 1e-3 --opt-level O2 \
        --loss-scale dynamic

The language-model path (``_lm_main_impl`` :1014): BERT MLM (C4), GPT
causal LM and Transformer-XL (C5, its memory carried from step to step)
under amp O0-O3, with ``--loss-scale`` and ``--keep-batchnorm-fp32``,
trained with FusedLAMB, FusedAdam, FusedSGD, FusedNovoGrad or
FusedAdagrad.  BERT and GPT attention takes the flash-attention kernels at
sequence 2048 and up, or at any length with ``--fused-attention``
(models/bert.py):

    python -m apex_example_tpu_torch.train --arch bert_base --opt lamb
    python -m apex_example_tpu_torch.train --arch bert_base --opt novograd \
        --lr 0.5
    python -m apex_example_tpu_torch.train --arch transformer_xl --opt adam
    # C4's and C5's contracts: amp O2 (add --loss-scale dynamic to skip
    # overflow steps on the card)
    python -m apex_example_tpu_torch.train --arch bert_base --opt lamb \
        --opt-level O2 --batch-size 64 --seq-len 128
    python -m apex_example_tpu_torch.train --arch transformer_xl --opt adam \
        --opt-level O2 --max-grad-norm 0.25 --batch-size 32 --seq-len 192
    python -m apex_example_tpu_torch.train --arch gpt_base --opt adam
    # long context: 8 x 2048 tokens a step through the kernels, bf16
    python -m apex_example_tpu_torch.train --arch gpt_base --opt adam \
        --lr 1e-4 --weight-decay 0.01 --seq-len 2048 --batch-size 8 \
        --opt-level O2

    # on the CPU (the kernels' plain versions), records to JSONL
    python -m apex_example_tpu_torch.train --device cpu --arch bert_tiny \
        --opt lamb --batch-size 8 --seq-len 16 --steps-per-epoch 5 \
        --metrics-jsonl train.jsonl
    python tools/metrics_lint.py train.jsonl --require-summary

Weights are random from ``--seed``.  Image batches are ``image_batch`` of
the global step, made on the device (data/synthetic.py) unless
``--host-pipeline``; the eval batches
of epoch E come from the disjoint index range ``10_000 + E * eval_batches
+ j``, as in train.py (:944).  LM batches are ``mlm_batch`` for BERT,
``lm_batch`` sliced into inputs ``[:, :-1]`` and targets ``[:, 1:]`` for
GPT and Transformer-XL (:1262-1267).  ``--vocab-size`` applies to
bert_base, gpt_base and transformer_xl (:1215-1216).  Transformer-XL's
memory starts at ``init_mems(batch)`` and is carried from step to step
(:1536-1537, :1729-1732); its step clips the grads to ``--max-grad-norm``
before the optimizer (workloads.make_txl_train_step).  Under O2 the LM
archs compute their dense layers, embeddings and LayerNorm I/O in bf16
over fp32 masters, with fp32 softmax and logits; O3 stores the parameters
half (the LayerNorms' fp32) and runs the softmax half; ``--loss-scale
dynamic`` skips an overflow step on the card through every optimizer's
noop flag.  ``--fused-attention`` stays refused at O3 and for the other
archs (train.py :699-709).  Entry points run on the card unless
``--device cpu`` is given, and raise when CUDA is asked for and absent.
The flags of paths not ported yet (model parallelism, ``--cost-model``)
are absent, so argparse rejects them.

Step options (train.py :200-208, :308-309), on every path:
``--grad-accum K`` runs K microbatches of ``batch // K`` rows (of each
process's rows under data parallelism) before one optimizer step, the
grads their fp32 mean (engine.GradAccumulator; Transformer-XL's groups of
streams carry their own rows of the memory); the batch, and each
process's share of it, must divide by K, and ``--zero`` refuses it.
``--remat none|conv|block`` rematerialises the ResNet blocks in the
backward (models/resnet.py).  ``--host-pipeline`` feeds the batches from
the port's C++ prefetchers (host_runtime.py, built with g++ at first use;
the trainer exits if it cannot be built) through pinned memory, from the
global step the loop starts at (after ``--resume``), the eval batches
from one-shot streams at their held-out indices:

    python -m apex_example_tpu_torch.train --arch resnet50 \
        --dataset imagenet --opt sgd --opt-level O2 --remat conv
    python -m apex_example_tpu_torch.train --arch bert_base --opt lamb \
        --grad-accum 4
    python -m apex_example_tpu_torch.train --arch resnet50 \
        --dataset imagenet --opt sgd --opt-level O2 --host-pipeline

``--eval`` evaluates after each epoch, ``--eval-batches`` batches in
``torch.no_grad()`` (engine.make_eval_step for images; for the LM archs
workloads.make_bert_eval_step, make_gpt_eval_step and make_txl_eval_step,
Transformer-XL's memory starting at ``init_mems`` each epoch and carried
across the eval batches).  The LM eval batches of epoch E are
``batch_fn(10_000_000 + E * eval_batches + j)`` (:1785).  Under data
parallelism every process evaluates the whole eval batch and rank 0
prints.

Checkpoints (utils/checkpoint.py; train.py :190-199, :471-511,
:800-809, :906-966): ``--checkpoint-dir DIR`` saves the train state (the
parameters and buffers, the optimizer's moments and step count, the loss
scaler and the step) at each epoch's end and, with ``--save-every-steps
N``, every N steps, with the host-state sidecar (the loop position);
``--async-checkpoint`` writes the files behind the training.  ``--resume
DIR`` restores the latest checkpoint in place and continues at its step,
in the middle of an epoch too, with the batch of that global step;
Transformer-XL's memory starts cold, as in JAX (:1652-1656).  Every
process restores the same files; rank 0 writes (the ZeRO optimizer
gathers its shards for it first):

    python -m apex_example_tpu_torch.train --arch bert_base --opt lamb \
        --epochs 2 --checkpoint-dir ck --save-every-steps 50 --eval
    python -m apex_example_tpu_torch.train --arch bert_base --opt lamb \
        --epochs 3 --resume ck --checkpoint-dir ck --eval

Flags of the reference's command line (:129, :217, :318-320):
``--local_rank`` / ``--local-rank`` (what ``torch.distributed.launch``
passes; the device still comes from ``LOCAL_RANK``), ``--workers`` and
``--deterministic`` are accepted, recorded in the run_header and do
nothing; ``--num-devices N`` must equal the launcher's world (one process
per card); ``--metrics-all-ranks`` makes rank K > 0 write its own
``PATH.rank<K>`` beside rank 0's ``--metrics-jsonl PATH``.

Data parallelism (C3; train.py :740-783, :1541-1575): under torchrun,
one process per GPU, every process trains on its rows ``[r B / W, (r + 1)
B / W)`` of the same seeded global batch ``--batch-size`` B, which must
divide by the world W, and the grads are all-reduced after the backward
(parallel/distributed.py; ``--delay-allreduce``,
``--gradient-predivide-factor`` and ``--quantized-allreduce int8`` with
``--quant-chunk`` on the image path, as JAX wires them).  ``--sync_bn``
makes the ResNet's BatchNorms SyncBatchNorms across the processes;
``--zero`` shards Adam's state over them (optim/distributed.py
DistributedFusedAdam; image, BERT and GPT archs, ``--opt adam``);
``--larc`` wraps the optimizer in LARC (``--larc-trust``, the weight
decay folded into the trust ratio).  ``--device cuda`` takes
``cuda:LOCAL_RANK`` and NCCL, ``--device cpu`` gloo.  At world 1, as
JAX's single-device path, the step is the plain one and ``--sync_bn`` is
ignored, and ``--zero`` is refused; with no launcher the trainer runs as
one process.  Only rank 0 prints and writes ``--metrics-jsonl``:

    torchrun --nproc_per_node 8 -m apex_example_tpu_torch.train \
        --arch resnet50 --dataset imagenet --opt sgd --opt-level O2 \
        --sync_bn
    python -m torch.distributed.run --nproc_per_node 2 \
        -m apex_example_tpu_torch.train --device cpu --arch resnet18 \
        --sync_bn --batch-size 8 --steps-per-epoch 2

Diagnostics (train.py :250-302, :354-446; obs/), on every path, all
writing to the ``--metrics-jsonl`` stream they require: ``--trace``
writes the loop's host spans (``data``, ``step``, ``checkpoint``) as
``trace_event`` records (tools/trace_export.py renders them);
``--profile-window N:M`` traces steps N..M, ``--prof`` the whole run,
with torch.profiler (the host's operators, CUDA's activity on the card,
the step's ``fwd_bwd`` / ``grad_allreduce`` / ``unscale_check`` /
``optimizer`` ranges inside the loop's ``step`` range), as Chrome traces
in ``build/trace/`` at the root of the checkout;
``--flight-recorder`` writes a ``crash_dump`` and an aborted run_summary
on a crash, SIGTERM or SIGINT; ``--stall-timeout S`` a ``stall`` record
with every thread's stack when no step completes in S seconds
(``--stall-trace``: a one-shot trace from the stall to the step that
recovers); ``--numerics-check overflow|always`` an ``overflow_event``
naming the modules whose grads were not finite (read from the grads the
engine's step leaves, image and BERT/GPT; ``--zero`` and transformer_xl
refuse it, as in JAX);
``--tick-profile`` decomposes each image step into data_wait, dispatch,
device (a ``torch.cuda.synchronize`` inserted only then), telemetry and
checkpoint (``tick_profile`` records every ``--tick-profile-every``
steps, an ``overhead_summary`` at the end; the LM loops are not
decomposed, as in JAX); ``--tensorboard DIR`` writes the printed scalars
as a TensorBoard event file from rank 0 (obs/metrics.py, without the
tensorboard package).  ``--prof-server`` exits: it is JAX's live
profiling server, which torch.profiler has no counterpart of here.

Resilience (train.py :303-316, :514-557; resilience/):
``--preempt-grace`` turns SIGTERM or SIGUSR1 into a save at the next step
boundary (the pending async write joined, the checkpoint and its sidecar
written, or the sidecar refreshed where the step is on disk already), a
``preemption`` record and exit 75, which ``tools/supervise.py`` restarts
with ``--resume``; ``--inject-fault crash|sigterm|hang|nan@STEP`` fires a
drill at a 1-based global step (a resumed run past it never fires it):

    python tools/supervise.py --max-restarts 2 -- \
        python -m apex_example_tpu_torch.train --arch bert_base \
        --opt lamb --checkpoint-dir ck --preempt-grace \
        --metrics-jsonl out.jsonl --inject-fault sigterm@50

Each printed step is train.py's line: ``epoch E step i/N loss L (avg)
top1 T (avg) R img/s scale S`` for images (:895-899), ``epoch E step i/N
loss L (avg) [ppl P ]R tok/s scale S`` for LMs (:1747-1752); after each
epoch with ``--eval``, ``epoch E EVAL loss L top1 T top5 T5 (N batches)``
(:951-953) or ``epoch E EVAL loss L masked_acc|ppl X (N batches)``
(BERT; GPT and Transformer-XL with ``ppl = exp(mean loss)``,
:1794-1798).  With ``--metrics-jsonl`` the run writes a run_header, one
step record per step (``items`` are images or tokens) and a run_summary
(obs/telemetry.py), which the JAX package's tools read unchanged.
"""

from __future__ import annotations

import argparse
import math
import random
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from apex_example_tpu_torch import amp, host_runtime, resolve_device
from apex_example_tpu_torch.data.synthetic import (CIFAR10, IMAGENET,
                                                   image_batch, lm_batch,
                                                   mlm_batch)
from apex_example_tpu_torch.engine import (create_train_state,
                                           make_eval_step,
                                           make_sharded_train_step,
                                           make_train_step)
from apex_example_tpu_torch.models.bert import bert_base, bert_tiny
from apex_example_tpu_torch.models.gpt import gpt_base, gpt_tiny
from apex_example_tpu_torch.models.resnet import ARCHS as IMAGE_ARCHS
from apex_example_tpu_torch.models.transformer_xl import (
    transformer_xl_base, transformer_xl_tiny)
from apex_example_tpu_torch.obs import profiler as profiler_lib
from apex_example_tpu_torch.obs import spans as spans_lib
from apex_example_tpu_torch.obs import trace as trace_lib
from apex_example_tpu_torch.obs.flight import FlightRecorder
from apex_example_tpu_torch.obs.logging import rank_print
from apex_example_tpu_torch.obs.metrics import (EventFileWriter, JsonlSink,
                                                MetricsRegistry,
                                                TensorBoardAdapter)
from apex_example_tpu_torch.obs.numerics import NumericsMonitor
from apex_example_tpu_torch.obs.spans import span
from apex_example_tpu_torch.obs.telemetry import TelemetryEmitter
from apex_example_tpu_torch.obs.tickprof import TickProfiler
from apex_example_tpu_torch.obs.watchdog import StallWatchdog
from apex_example_tpu_torch.optim.distributed import (DistributedFusedAdam,
                                                      make_zero_train_step)
from apex_example_tpu_torch.optim.fused import (FusedAdagrad, FusedAdam,
                                                FusedLAMB, FusedNovoGrad,
                                                FusedSGD)
from apex_example_tpu_torch.optim.schedules import build_schedule
from apex_example_tpu_torch.parallel.distributed import DDPConfig
from apex_example_tpu_torch.parallel.larc import LARC
from apex_example_tpu_torch.parallel.launch import (
    local_device, maybe_initialize_distributed)
from apex_example_tpu_torch.parallel.mesh import DATA_AXIS
from apex_example_tpu_torch.resilience import (EX_TEMPFAIL, FaultPlan,
                                               PreemptionHandler)
from apex_example_tpu_torch.utils.checkpoint import CheckpointManager
from apex_example_tpu_torch.utils.meters import AverageMeter, Throughput
from apex_example_tpu_torch.workloads import (lm_loss, make_bert_eval_step,
                                              make_gpt_eval_step,
                                              make_sharded_txl_train_step,
                                              make_txl_eval_step,
                                              make_txl_train_step, mlm_loss)

LM_ARCHS = {"bert_base": bert_base, "bert_tiny": bert_tiny,
            "gpt_base": gpt_base, "gpt_tiny": gpt_tiny,
            "transformer_xl": transformer_xl_base,
            "transformer_xl_tiny": transformer_xl_tiny}
ARCHS = {**IMAGE_ARCHS, **LM_ARCHS}
DATASETS = {"cifar10": CIFAR10, "imagenet": IMAGENET}
ARCH_MAX_POSITION = {"bert_base": 512, "bert_tiny": 128,
                     "gpt_base": 1024, "gpt_tiny": 128}
VOCAB_ARCHS = ("bert_base", "gpt_base", "transformer_xl")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m apex_example_tpu_torch.train",
        description="ResNet image training under amp O0-O3, BERT MLM, GPT "
                    "and Transformer-XL LM training (PyTorch port)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on: cuda (default) or cpu")
    p.add_argument("--arch", "-a", default="resnet18",
                   choices=sorted(IMAGE_ARCHS) + list(LM_ARCHS))
    p.add_argument("--dataset", default="cifar10", choices=list(DATASETS),
                   help="image shapes: cifar10 (32 px, 10 classes) or "
                        "imagenet (224 px, 1000 classes)")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--fused-attention", action="store_true",
                   help="flash-attention kernels for the BERT/GPT archs at "
                        "any sequence length (default: at 2048 and up; "
                        "fp32-softmax opt levels only)")
    p.add_argument("--vocab-size", type=int, default=30522,
                   help="vocabulary of bert_base, gpt_base and "
                        "transformer_xl (the tiny archs keep 256)")
    p.add_argument("--max-grad-norm", type=float, default=0.25,
                   help="global-norm grad clip (transformer_xl)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="microbatches accumulated per optimizer step")
    p.add_argument("--remat", default="none",
                   choices=["none", "conv", "block"],
                   help="rematerialization for image archs: 'conv' saves "
                        "only conv outputs (BN/ReLU recomputed in backward)"
                        ", 'block' saves only block inputs")
    p.add_argument("--host-pipeline", action="store_true",
                   help="feed batches from the native C++ prefetcher "
                        "(host_runtime.py; the reference's fast_collate "
                        "analog) instead of on-device synthesis")
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
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", "--wd", type=float, default=1e-4)
    p.add_argument("--opt", default="sgd",
                   choices=["sgd", "adam", "lamb", "novograd", "adagrad"])
    p.add_argument("--larc", action="store_true",
                   help="wrap the optimizer in LARC layer-wise adaptive "
                        "rate control (parallel/larc.py)")
    p.add_argument("--larc-trust", type=float, default=0.02,
                   help="LARC trust coefficient")
    p.add_argument("--opt-level", default="O0",
                   choices=["O0", "O1", "O2", "O3"])
    p.add_argument("--loss-scale", default=None,
                   help='None, a number, or "dynamic"')
    p.add_argument("--keep-batchnorm-fp32", default=None, type=lambda s:
                   None if s in (None, "None") else s.lower() == "true")
    # data parallelism under torchrun (apex parity)
    p.add_argument("--sync_bn", action="store_true",
                   help="SyncBatchNorm across the processes (image archs)")
    p.add_argument("--zero", action="store_true",
                   help="ZeRO-1 optimizer-state sharding over the "
                        "processes (DistributedFusedAdam; --opt adam, image "
                        "and BERT/GPT archs, more than one process)")
    p.add_argument("--delay-allreduce", action="store_true", default=True)
    p.add_argument("--gradient-predivide-factor", type=float, default=1.0)
    p.add_argument("--quantized-allreduce", default="off",
                   choices=["off", "int8"],
                   help="gradient exchange precision: int8 reduces each "
                        "--quant-chunk-element chunk under one max-abs "
                        "scale shared by the processes (error at most "
                        "world * scale / 2 an element)")
    p.add_argument("--quant-chunk", type=int, default=1024,
                   help="chunk size (elements) of --quantized-allreduce's "
                        "scales")
    p.add_argument("--print-freq", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval", action="store_true",
                   help="evaluate after each epoch")
    p.add_argument("--eval-batches", type=int, default=10,
                   help="validation batches per eval pass")
    p.add_argument("--num-devices", type=int, default=None,
                   help="cards to train on: one process each, so this must "
                        "equal the launcher's world (default: the world)")
    # checkpoints (utils/checkpoint.py)
    p.add_argument("--resume", default="", metavar="DIR",
                   help="checkpoint dir to resume from (its latest step)")
    p.add_argument("--checkpoint-dir", default="", metavar="DIR",
                   help="save a checkpoint here at each epoch's end")
    p.add_argument("--async-checkpoint", action="store_true",
                   help="write checkpoints on a background thread, after a "
                        "copy of the state to host memory (joined before "
                        "the next save)")
    p.add_argument("--save-every-steps", type=int, default=0, metavar="N",
                   help="also checkpoint every N optimizer steps (requires "
                        "--checkpoint-dir; epoch boundaries still save)")
    p.add_argument("--metrics-jsonl", default="", metavar="PATH",
                   help="emit schema-valid step records to this JSONL")
    p.add_argument("--metrics-all-ranks", action="store_true",
                   help="with --metrics-jsonl: every process writes its "
                        "own file (PATH.rank<K> for K > 0)")
    # diagnostics (obs/), each writing to the --metrics-jsonl stream
    p.add_argument("--profile-window", default="", metavar="N:M",
                   help="trace run-relative steps N..M (1-based, inclusive) "
                        "with torch.profiler instead of --prof's whole run")
    p.add_argument("--trace", action="store_true",
                   help="with --metrics-jsonl: trace_event records for "
                        "every host span (data / step / checkpoint), "
                        "exportable with tools/trace_export.py")
    p.add_argument("--tick-profile", action="store_true",
                   help="with --metrics-jsonl: decompose each image step "
                        "into data_wait / dispatch / device (a "
                        "torch.cuda.synchronize inserted only then) / "
                        "telemetry / checkpoint: tick_profile records and "
                        "an overhead_summary (LM loops are not decomposed)")
    p.add_argument("--tick-profile-every", type=int, default=16,
                   metavar="N",
                   help="emit a tick_profile record every N steps "
                        "(the overhead_summary folds every step)")
    p.add_argument("--flight-recorder", action="store_true",
                   help="with --metrics-jsonl: on a crash, SIGTERM or "
                        "SIGINT write a crash_dump (the last K step "
                        "records) and an aborted run summary")
    p.add_argument("--flight-recorder-keep", type=int, default=64,
                   metavar="K",
                   help="step records the flight recorder's ring keeps")
    p.add_argument("--stall-timeout", type=float, default=0.0, metavar="S",
                   help="with --metrics-jsonl: when no step completes for "
                        "S seconds, a 'stall' record with every thread's "
                        "stack (0: off; S covers the first step's kernel "
                        "build too)")
    p.add_argument("--stall-trace", action="store_true",
                   help="with --stall-timeout: on the first stall, a "
                        "one-shot torch.profiler trace from the stall to "
                        "the step that recovers")
    p.add_argument("--numerics-check", default="off",
                   choices=["off", "overflow", "always"],
                   help="per-module non-finite counts and grad norms of "
                        "the step's grads as 'overflow_event' records "
                        "naming the offending modules ('overflow': on "
                        "overflow steps only; 'always': every step; "
                        "requires --metrics-jsonl)")
    p.add_argument("--tensorboard", default="", metavar="DIR",
                   help="write the printed scalars to this TensorBoard "
                        "logdir (rank 0)")
    p.add_argument("--prof", action="store_true",
                   help="trace the whole run with torch.profiler")
    p.add_argument("--prof-server", type=int, default=0, metavar="PORT",
                   help="JAX's live profiling server: not portable, the "
                        "trainer exits with the reason")
    # resilience (resilience/; tools/supervise.py restarts on exit 75)
    p.add_argument("--preempt-grace", action="store_true",
                   help="on SIGTERM/SIGUSR1, at the next step boundary: "
                        "join pending checkpoint IO, save a final "
                        "checkpoint (with --checkpoint-dir), write a "
                        "'preemption' record and exit 75 (EX_TEMPFAIL) "
                        "for a supervisor to restart")
    p.add_argument("--inject-fault", default="", metavar="KIND@STEP",
                   help="fault drill at a 1-based global step: crash | "
                        "sigterm | hang | nan; a resumed run past STEP "
                        "never fires it")
    # the reference's command line (torch.distributed.launch passes
    # --local_rank, or --local-rank from torch 2.0); recorded, no effect
    p.add_argument("--local_rank", "--local-rank", type=int, default=0,
                   help="accepted; the device comes from LOCAL_RANK")
    p.add_argument("--workers", type=int, default=4,
                   help="accepted; no effect (batches are made on the "
                        "device)")
    p.add_argument("--deterministic", action="store_true",
                   help="accepted; no effect")
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


def is_image(args) -> bool:
    return args.arch in IMAGE_ARCHS


def data_world() -> int:
    """The processes that train together: the default process group's
    size, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def build_model(args, device, policy=None):
    kw = {"seed": args.seed, "device": device}
    md = amp.module_dtypes(policy or amp.get_policy("O0"))
    if is_image(args):
        return IMAGE_ARCHS[args.arch](
            num_classes=DATASETS[args.dataset]["num_classes"],
            dtype=md.compute, param_dtype=md.param, bn_dtype=md.bn_stats,
            bn_io_dtype=md.bn_io,
            bn_axis_name=(DATA_AXIS if args.sync_bn and data_world() > 1
                          else None),
            remat=args.remat, **kw)
    if args.arch in VOCAB_ARCHS:
        kw["vocab_size"] = args.vocab_size
    kw.update(dtype=md.compute, param_dtype=md.param, ln_dtype=md.ln_io,
              softmax_dtype=md.softmax)
    if not is_txl(args):
        # flag set: the kernels at any length; absent: "auto" (:1224)
        kw["fused_attention"] = args.fused_attention or "auto"
    if args.seq_len > ARCH_MAX_POSITION.get(args.arch, args.seq_len):
        kw["max_position"] = args.seq_len
    return ARCHS[args.arch](**kw)


OPTIMIZERS = {"adam": FusedAdam, "lamb": FusedLAMB,
              "novograd": FusedNovoGrad, "adagrad": FusedAdagrad}


def build_optimizer(args, params):
    """train.py's ``build_optimizer`` (:559): FusedSGD (``--momentum``),
    FusedAdam (AdamW), FusedLAMB (clip at max_grad_norm 1.0),
    FusedNovoGrad or FusedAdagrad (their other arguments at their
    defaults), with the schedule and weight decay.  ``--larc`` wraps it in
    LARC, which takes the weight decay (the inner optimizer gets none) and,
    in clip mode, the base ``--lr``; ``--zero``: DistributedFusedAdam over
    the default process group (:592)."""
    lr = build_lr(args)
    if args.zero:
        return DistributedFusedAdam(params, lr=lr,
                                    weight_decay=args.weight_decay)
    wd = 0.0 if args.larc else args.weight_decay
    if args.opt == "sgd":
        opt = FusedSGD(params, lr=lr, momentum=args.momentum,
                       weight_decay=wd)
    else:
        opt = OPTIMIZERS[args.opt](params, lr=lr, weight_decay=wd)
    if args.larc:
        opt = LARC(opt, trust_coefficient=args.larc_trust, lr=args.lr,
                   weight_decay=args.weight_decay)
    return opt


def batch_fn(args, vocab_size: int, step: int, device, rank: int = 0,
             world: int = 1):
    """The batch of global step ``step``: (images, labels) for the image
    archs, (ids, (labels, weights)) for BERT, (inputs, targets) for GPT and
    Transformer-XL; of ``world`` processes, rank ``rank``'s rows of it."""
    rows = slice(rank * args.batch_size // world,
                 (rank + 1) * args.batch_size // world)
    if is_image(args):
        spec = DATASETS[args.dataset]
        x, y = image_batch(step, batch_size=args.batch_size,
                           image_size=spec["image_size"],
                           channels=spec["channels"],
                           num_classes=spec["num_classes"], seed=args.seed,
                           device=device)
        return x[rows], y[rows]
    to = lambda a: torch.from_numpy(                    # noqa: E731
        np.ascontiguousarray(a[rows])).to(device)
    if args.arch.startswith("bert"):
        ids, labels, w = mlm_batch(step, batch_size=args.batch_size,
                                   seq_len=args.seq_len,
                                   vocab_size=vocab_size,
                                   mask_token_id=vocab_size - 1,
                                   seed=args.seed)
        return to(ids), (to(labels), to(w))
    toks = lm_batch(step, batch_size=args.batch_size, seq_len=args.seq_len,
                    vocab_size=vocab_size, seed=args.seed)
    return to(toks[:, :-1]), to(toks[:, 1:])


class BatchSource:
    """The loop's batches: ``batch_fn`` of the global step, made on the
    device (the default), or with ``--host-pipeline`` the native
    prefetcher's (host_runtime.py; train.py :816-842, :1675-1708).  The
    prefetcher starts at ``start``, the global step the loop starts at, so
    a resumed run reads the batches an unbroken one reads; an eval batch
    is a one-shot stream at its index (the image archs' at 10_000_000 +
    index), the same in fresh and resumed runs.  Each process's prefetcher
    makes only its own rows of the global batch, so the host's work a
    step does not grow with the world.  Batches cross from pinned host
    memory with ``non_blocking`` copies, each from a fresh buffer, in the
    model's layout (NHWC fp32 images and int64 labels, int32 tokens)."""

    def __init__(self, args, vocab_size: int, device, rank: int, world: int,
                 start: int):
        self.args, self.vocab_size, self.device = args, vocab_size, device
        self.rank, self.world = rank, world
        self.pin = torch.device(device).type == "cuda"
        b = args.batch_size
        self.prefetcher = (
            self.producer(start, slice(rank * b // world,
                                       (rank + 1) * b // world))
            if args.host_pipeline else None)

    def producer(self, start: int, rows: Optional[slice] = None):
        """The native prefetcher of ``rows`` (default all) of ``args``'s
        batches from batch index ``start``."""
        args = self.args
        if is_image(args):
            spec = DATASETS[args.dataset]
            return host_runtime.NativePrefetcher(
                batch=args.batch_size, image_size=spec["image_size"],
                num_classes=spec["num_classes"], channels=spec["channels"],
                seed=args.seed, start_index=start, rows=rows,
                pin_memory=self.pin)
        bert = args.arch.startswith("bert")
        return host_runtime.NativeLMPrefetcher(
            batch=args.batch_size, seq_len=args.seq_len,
            vocab_size=self.vocab_size, mlm=bert,
            mask_token_id=self.vocab_size - 1 if bert else -1,
            seed=args.seed, start_index=start, rows=rows,
            pin_memory=self.pin)

    def _to_device(self, produced):
        to = lambda t: t.to(self.device, non_blocking=True)  # noqa: E731
        if is_image(self.args):
            images, labels = produced
            return to(images), to(labels).long()
        ids, labels, w = produced
        if self.args.arch.startswith("bert"):
            return to(ids), (to(labels), to(w))
        return to(ids), to(labels)

    def train(self, step: int):
        """The batch of global step ``step`` (the prefetcher's next)."""
        if self.prefetcher is None:
            return batch_fn(self.args, self.vocab_size, step, self.device,
                            self.rank, self.world)
        return self._to_device(next(self.prefetcher))

    def eval(self, index: int):
        """The whole held-out batch ``index``."""
        if self.prefetcher is None:
            return batch_fn(self.args, self.vocab_size, index, self.device)
        start = 10_000_000 + index if is_image(self.args) else index
        with self.producer(start) as one_shot:
            return self._to_device(next(one_shot))

    def close(self) -> None:
        if self.prefetcher is not None:
            self.prefetcher.close()


PROF_SERVER_REASON = (
    "--prof-server starts JAX's live profiling server "
    "(jax.profiler.start_server), which tensorboard's profile plugin "
    "captures from while the run goes on; torch.profiler has no such "
    "server without a profiling daemon on the machine, so the port does "
    "not take it: trace with --prof (the whole run) or --profile-window "
    "N:M (steps N..M) instead")


def check_args(args) -> None:
    """What the parser cannot say: sizes, and the JAX trainer's refusals
    (train.py :630-709), with its messages, in its order."""
    for flag in ("epochs", "steps_per_epoch", "batch_size", "seq_len",
                 "print_freq", "eval_batches"):
        if getattr(args, flag) < 1:
            raise SystemExit(f"--{flag.replace('_', '-')} must be >= 1")
    if args.grad_accum > 1 and args.batch_size % args.grad_accum:
        raise SystemExit(f"--batch-size {args.batch_size} not divisible by "
                         f"--grad-accum {args.grad_accum}")
    if args.prof and args.profile_window:
        raise SystemExit("--prof traces the whole run; pick it or "
                         "--profile-window N:M, not both")
    if (args.flight_recorder or args.stall_timeout > 0
            or args.numerics_check != "off") and not args.metrics_jsonl:
        raise SystemExit("--flight-recorder/--stall-timeout/"
                         "--numerics-check write to the telemetry sink; "
                         "add --metrics-jsonl PATH")
    if args.trace and not args.metrics_jsonl:
        raise SystemExit("--trace emits trace_event records to the "
                         "telemetry sink; add --metrics-jsonl PATH")
    if args.stall_trace and args.stall_timeout <= 0:
        raise SystemExit("--stall-trace arms on a stall; it needs "
                         "--stall-timeout S")
    if args.save_every_steps < 0:
        raise SystemExit(f"--save-every-steps {args.save_every_steps} "
                         "must be >= 0")
    if args.save_every_steps and not args.checkpoint_dir:
        raise SystemExit("--save-every-steps writes through "
                         "--checkpoint-dir; add it")
    if args.inject_fault:
        try:
            FaultPlan.parse(args.inject_fault)
        except ValueError as e:
            raise SystemExit(str(e))
    if args.numerics_check != "off" and (args.zero or is_txl(args)):
        raise SystemExit("--numerics-check rides the shared engine step's "
                         "finite-check pass (engine.make_train_step); the "
                         "--zero/--pipeline-parallel/--context-parallel/"
                         "--moe-experts and transformer_xl steps own their "
                         "own grad pipelines and are not wired yet")
    if args.profile_window:
        try:
            profiler_lib.parse_window(args.profile_window)
        except ValueError as e:
            raise SystemExit(str(e))
    if args.prof_server:
        raise SystemExit(PROF_SERVER_REASON)
    if args.fused_attention and not args.arch.startswith(("bert", "gpt")):
        raise SystemExit("--fused-attention is wired for the BERT/GPT "
                         "archs only")
    if args.fused_attention and args.opt_level == "O3":
        raise SystemExit("--fused-attention requires fp32 softmax "
                         "(opt levels O0-O2); O3 runs softmax half")


def check_parallel_args(args, world: int) -> None:
    """The data-parallel refusals, with the JAX trainer's messages
    (train.py :324-330, :592-626, :1165-1169), in its order, after
    ``--num-devices``, which must be the world: one process a card."""
    if args.num_devices is not None and args.num_devices != world:
        raise SystemExit(f"--num-devices {args.num_devices}: the port runs "
                         f"one process per card and this run has {world}; "
                         f"start {args.num_devices} processes (torchrun "
                         f"--nproc_per_node {args.num_devices})")
    if args.batch_size % world:
        raise SystemExit(f"--batch-size {args.batch_size} not divisible by "
                         f"{world} devices")
    if (args.batch_size // world) % args.grad_accum:
        raise SystemExit(f"per-shard batch {args.batch_size // world} "
                         f"not divisible by --grad-accum {args.grad_accum}")
    if not args.zero:
        return
    if is_txl(args):
        raise SystemExit("--zero is wired for the image and BERT/GPT "
                         "workloads (transformer_xl's step owns its "
                         "own grad-clip path)")
    if args.larc:
        raise SystemExit("--larc does not compose with --zero (the sharded "
                         "optimizer owns its update)")
    if world < 2:
        raise SystemExit("--zero needs >1 device on the data axis (state "
                         "shards over it)")
    if args.opt != "adam":
        raise SystemExit("--zero is wired for --opt adam "
                         "(DistributedFusedAdam)")
    if args.grad_accum != 1:
        raise SystemExit("--zero does not support --grad-accum")
    if args.gradient_predivide_factor != 1.0:
        raise SystemExit("--zero does not support "
                         "--gradient-predivide-factor (the reduction "
                         "lives inside the sharded optimizer)")


def build_state(args, device):
    """The train state of ``args`` on ``device``: model, optimizer, and the
    amp policy and loss scaler of ``--opt-level``, ``--loss-scale`` and
    ``--keep-batchnorm-fp32``."""
    policy, scaler = amp.initialize(
        args.opt_level, loss_scale=args.loss_scale,
        keep_batchnorm_fp32=args.keep_batchnorm_fp32, device=device)
    model = build_model(args, device, policy)
    optimizer = build_optimizer(args, model.parameters())
    return create_train_state(model, optimizer, policy, scaler)


def build_step(args):
    """The train step of ``args``'s arch: cross-entropy with top-1 for
    the image archs, MLM or LM loss, or Transformer-XL's step (the memory
    carried in and out, the clip before the optimizer); each reads the
    state's policy and loss scaler.  Over more than one process the
    data-parallel step: ``--zero``'s, or the grads all-reduced (with
    ``--delay-allreduce``, ``--gradient-predivide-factor`` and
    ``--quantized-allreduce`` on the image path, as JAX wires them)."""
    world, k = data_world(), args.grad_accum
    lm_loss_fn = mlm_loss if args.arch.startswith("bert") else lm_loss
    if world > 1 and args.zero:
        if is_image(args):
            return make_zero_train_step()
        return make_zero_train_step(lm_loss_fn, compute_accuracy=False)
    if is_image(args):
        if world == 1:
            return make_train_step(grad_accum=k)
        return make_sharded_train_step(DATA_AXIS, ddp=DDPConfig(
            delay_allreduce=args.delay_allreduce,
            gradient_predivide_factor=args.gradient_predivide_factor,
            quantized_allreduce=args.quantized_allreduce == "int8",
            quant_chunk=args.quant_chunk), grad_accum=k)
    if is_txl(args):
        if world == 1:
            return make_txl_train_step(args.max_grad_norm, grad_accum=k)
        return make_sharded_txl_train_step(
            DATA_AXIS, max_grad_norm=args.max_grad_norm, grad_accum=k)
    if world == 1:
        return make_train_step(lm_loss_fn, compute_accuracy=False,
                               grad_accum=k)
    return make_sharded_train_step(DATA_AXIS, loss_fn=lm_loss_fn,
                                   compute_accuracy=False, grad_accum=k)


def build_eval_step(args):
    """The eval step of ``args``'s arch: loss, top-1 and top-5 for the
    image archs, loss and masked accuracy for BERT, loss for GPT, and
    Transformer-XL's with its memory threaded through."""
    if is_image(args):
        return make_eval_step()
    if is_txl(args):
        return make_txl_eval_step()
    if args.arch.startswith("bert"):
        return make_bert_eval_step()
    return make_gpt_eval_step()


def host_loop_state(args, global_step: int) -> dict:
    """The host-state sidecar (train.py ``host_loop_state`` :471): the
    loop position and the host PRNG.  The batches are made from their
    global step (``batch_fn``), so ``data_index`` is the stream's
    position."""
    rng_version, rng_state, rng_gauss = random.getstate()
    return {
        "step": int(global_step),
        "data_index": int(global_step),
        "steps_per_epoch": int(args.steps_per_epoch),
        "epoch": int(global_step) // args.steps_per_epoch,
        "step_in_epoch": int(global_step) % args.steps_per_epoch,
        "seed": int(args.seed),
        "python_random": [rng_version, list(rng_state), rng_gauss],
    }


def restore_loop_position(args, rmgr, global_step: int):
    """``(start_epoch, start_step_in_epoch)`` of a resumed run
    (:492): the sidecar's position where it describes this step at these
    ``--steps-per-epoch`` (restoring the host PRNG), else the one the
    step implies."""
    hs = rmgr.load_host_state(global_step)
    start_epoch = global_step // args.steps_per_epoch
    start_i = global_step % args.steps_per_epoch
    if hs:
        if hs.get("step") == global_step \
                and hs.get("steps_per_epoch") == args.steps_per_epoch:
            start_epoch = int(hs.get("epoch", start_epoch))
            start_i = int(hs.get("step_in_epoch", start_i))
        rng = hs.get("python_random")
        if rng:
            random.setstate((rng[0], tuple(rng[1]), rng[2]))
    return start_epoch, start_i


def resume(args, state):
    """With ``--resume``, restore its latest checkpoint into ``state`` in
    place; returns where the loop starts, ``(epoch, step in epoch)``."""
    if not args.resume:
        return 0, 0
    if dist.is_initialized():
        dist.barrier()        # the writer's last save has landed
    rmgr = CheckpointManager(args.resume)
    rmgr.restore(state)
    start_epoch, start_i = restore_loop_position(args, rmgr, state.step)
    rank_print(f"resumed from step {state.step} (epoch {start_epoch})")
    return start_epoch, start_i


def save_checkpoint(args, mgr, state, global_step: int) -> int:
    """Checkpoint ``state`` with its sidecar (in every process; rank 0
    writes); returns the step saved."""
    mgr.save(state, wait=not args.async_checkpoint,
             host_state=host_loop_state(args, global_step))
    rank_print(f"saved checkpoint at step {global_step}")
    return global_step


def run_train(args) -> int:
    """Check the arguments, join the launcher's process group if there is
    one (leaving it at the end), and train."""
    device = resolve_device(args.device)
    check_args(args)
    if args.host_pipeline and not host_runtime.available():
        raise SystemExit("--host-pipeline: native runtime not buildable")
    started = not dist.is_initialized()
    rank, world = maybe_initialize_distributed(device)
    started = started and dist.is_initialized()
    try:
        check_parallel_args(args, world)
        device = local_device(device)
        if dist.is_initialized():
            rank_print(f"data parallel: world {world}, backend "
                       f"{dist.get_backend()}, device {device}"
                       + (", ZeRO-1 optimizer state" if args.zero else "")
                       + (", SyncBatchNorm" if args.sync_bn and world > 1
                          and is_image(args) else "")
                       + (" (the single-process step)" if world == 1
                          else ""))
        if is_image(args):
            return run_image(args, device, rank, world)
        return run_lm(args, device, rank, world)
    finally:
        if started:
            dist.destroy_process_group()


def _policy_text(policy, lm: bool = False) -> str:
    md = amp.module_dtypes(policy)
    name = lambda d: str(d).replace("torch.", "")       # noqa: E731
    norm = (f"ln io {name(md.ln_io)}, softmax {name(md.softmax)}" if lm
            else f"bn io {name(md.bn_io)}, bn stats {name(md.bn_stats)}")
    return (f"opt-level {policy.opt_level} (compute {name(md.compute)}, "
            f"params {name(md.param)}, {norm}, loss scale "
            f"{policy.loss_scale})")


def attention_route(args, model) -> str:
    """Which attention the LM's whole-sequence steps take."""
    if is_txl(args):
        return "relative einsum"
    if model.layers[0].attention.uses_kernel(args.seq_len):
        return "flash kernels"
    return "einsum"


def make_writer(args):
    """The ``--tensorboard`` writer (rank 0 only, as in JAX): the port's
    standard-library event file (obs/metrics.py)."""
    if not args.tensorboard or (dist.is_initialized()
                                and dist.get_rank() != 0):
        return None
    return EventFileWriter(args.tensorboard)


def make_telemetry(args, device, state):
    """The flag-gated observability of both loops (train.py :354): the
    step emitter (``--metrics-jsonl``), the profiler window
    (``--profile-window``), the span registry and tracer (``--trace``), and
    the diagnostics riding the emitter as observers (``--flight-recorder``,
    ``--stall-timeout``, ``--numerics-check``).  A process that writes no
    stream (rank > 0 without ``--metrics-all-ranks``) gets no emitter and
    no diagnostics.  The numerics monitor reads ``state``'s grads.
    Returns (emitter, window, recorder, watchdog)."""
    emitter = recorder = watchdog = None
    trace_lib.set_default(None)          # a stale one from an earlier run
    sink = (JsonlSink(args.metrics_jsonl, all_ranks=args.metrics_all_ranks)
            if args.metrics_jsonl else None)
    if sink is not None and sink.active:
        registry = MetricsRegistry()
        spans_lib.set_default_registry(registry)
        emitter = TelemetryEmitter(sink, device, registry=registry)
        emitter.run_header(config=vars(args), argv=sys.argv[1:],
                           arch=args.arch)
        if args.trace:
            trace_lib.set_default(trace_lib.Tracer(sink,
                                                   run_id=emitter.run_id))
        if args.flight_recorder:
            recorder = FlightRecorder(emitter, config=vars(args),
                                      keep=args.flight_recorder_keep)
            recorder.install()
            emitter.add_observer(recorder.on_record)
        if args.stall_timeout > 0:
            watchdog = StallWatchdog(
                sink, deadline_s=args.stall_timeout, run_id=emitter.run_id,
                trace_dir=(profiler_lib.DEFAULT_TRACE_DIR
                           if args.stall_trace else None), device=device)
            watchdog.start()
            emitter.add_observer(watchdog.on_record)
        if args.numerics_check != "off":
            monitor = NumericsMonitor(sink, state, mode=args.numerics_check,
                                      run_id=emitter.run_id)
            emitter.add_observer(monitor.on_record)
    window = profiler_lib.make_profiler_window(args.profile_window or None,
                                               device=device)
    return emitter, window, recorder, watchdog


def make_tickprof(args, emitter) -> Optional[TickProfiler]:
    """``--tick-profile`` (train.py :408): the step decomposition, on the
    emitter's sink and run id; None where the flag is off or this process
    writes no stream."""
    if not args.tick_profile:
        return None
    if not args.metrics_jsonl:
        raise SystemExit("--tick-profile requires --metrics-jsonl (the "
                         "tick_profile/overhead_summary records ride "
                         "the metrics stream)")
    if args.tick_profile_every < 1:
        raise SystemExit(f"--tick-profile-every must be >= 1, got "
                         f"{args.tick_profile_every}")
    if emitter is None:
        return None
    return TickProfiler(sample_every=args.tick_profile_every,
                        emit=emitter.sink.write, run_id=emitter.run_id)


def close_telemetry(emitter, window, recorder=None, watchdog=None) -> None:
    """make_telemetry's counterpart in the loops' ``finally`` (train.py
    :432): stop an open window, disarm the watchdog, write the
    run_summary, unbind the registry and tracer.  While an exception
    unwinds it goes through the flight recorder instead: a crash_dump and
    an aborted summary."""
    if window is not None:
        window.close()
    if watchdog is not None:
        watchdog.close()
    exc = sys.exc_info()
    if recorder is not None and exc[0] is not None \
            and not issubclass(exc[0], SystemExit):
        recorder.crash_dump(f"exception:{exc[0].__name__}", exc_info=exc)
    if recorder is not None:
        recorder.close()
    if emitter is not None:
        emitter.close()
    spans_lib.set_default_registry(None)
    trace_lib.set_default(None)


def make_resilience(args, recorder) -> Tuple[Optional[PreemptionHandler],
                                             Optional[FaultPlan]]:
    """The ``--preempt-grace`` handler and the ``--inject-fault`` plan
    (train.py :458), made after make_telemetry so the handler takes
    SIGTERM over from the flight recorder."""
    preempt = fault = None
    if args.preempt_grace:
        preempt = PreemptionHandler(recorder=recorder)
        preempt.install()
    if args.inject_fault:
        fault = FaultPlan.parse(args.inject_fault)
    return preempt, fault


def stop_prof(prof, device) -> None:
    """Stop ``--prof``'s whole-run trace and write it."""
    path = profiler_lib.stop_trace(prof, profiler_lib.DEFAULT_TRACE_DIR,
                                   "run", device)
    rank_print(f"profile written to {path}")


def graceful_preempt_exit(args, mgr, state, preempt, emitter,
                          global_step: int, last_saved=None, prof=None,
                          device=None) -> int:
    """The grace sequence at a step boundary (train.py :514): join a
    pending async write, save the checkpoint with its sidecar (or refresh
    the sidecar where this step is on disk already), write the
    ``preemption`` record and return EX_TEMPFAIL (75).  The caller's
    ``finally`` then closes the stream with an un-aborted run_summary."""
    if prof is not None:
        stop_prof(prof, device)
    ckstep = None
    if mgr is not None:
        mgr.wait_until_finished()
        if last_saved != state.step:
            mgr.save(state, wait=True,
                     host_state=host_loop_state(args, global_step))
        elif mgr.writer:
            mgr.save_host_state(state.step,
                                host_loop_state(args, global_step))
        # the run's outcome, the same in every process (rank 0 writes)
        ckstep = int(state.step)
        rank_print(f"preempted by {preempt.signal_name}: saved checkpoint "
                   f"at step {ckstep}; exiting {EX_TEMPFAIL} (resumable)")
    else:
        rank_print(f"preempted by {preempt.signal_name}: no "
                   f"--checkpoint-dir, nothing saved; exiting "
                   f"{EX_TEMPFAIL}")
    if emitter is not None:
        emitter.preemption(preempt.signal_name, step=int(global_step),
                           checkpoint_step=ckstep, saved=ckstep is not None)
    return EX_TEMPFAIL


def run_image(args, device, rank: int = 0, world: int = 1) -> int:
    """The image path of train.py's ``main`` (:628-994), in each of
    ``world`` processes."""
    state = build_state(args, device)
    step_fn = build_step(args)
    eval_fn = build_eval_step(args) if args.eval else None
    n_params = sum(p.numel() for p in state.model.parameters())
    rank_print(f"model {args.arch}: {n_params} parameters in "
          f"{len(state.optimizer.params)} tensors, dataset {args.dataset}, "
          f"device {device}, opt {args.opt}, {_policy_text(state.policy)}, "
          f"params from random init (seed {args.seed})")
    mgr = CheckpointManager(args.checkpoint_dir) if args.checkpoint_dir \
        else None
    tb = TensorBoardAdapter(make_writer(args))
    emitter, window, recorder, watchdog = make_telemetry(args, device, state)
    preempt = batches = prof = None
    cuda = torch.device(device).type == "cuda"
    try:
        tickprof = make_tickprof(args, emitter)
        preempt, fault = make_resilience(args, recorder)
        start_epoch, start_i = resume(args, state)
        if args.prof:
            prof = profiler_lib.start_trace(device)
        global_step = state.step
        batches = BatchSource(args, 0, device, rank, world, global_step)
        run_step, last_saved = 0, None
        for epoch in range(start_epoch, args.epochs):
            losses, top1s = AverageMeter("loss"), AverageMeter("top1")
            thr = Throughput(warmup_steps=2)
            for i in range(start_i if epoch == start_epoch else 0,
                           args.steps_per_epoch):
                run_step += 1
                t_tick = time.perf_counter()
                if window is not None:
                    window.on_step_start(run_step)
                with span("data"):
                    batch = batches.train(global_step)
                if fault is not None:
                    batch = fault.maybe_poison(global_step + 1, batch)
                t_data = t0 = time.perf_counter()
                with span("step", device=True):
                    state, metrics = step_fn(state, batch)
                    global_step += 1
                    if tickprof is not None:
                        # the dispatch/device boundary: the step has
                        # queued its kernels; wait for the card here
                        t_enqueue = time.perf_counter()
                        if cuda:
                            torch.cuda.synchronize(device)
                        t_device = time.perf_counter()
                    if emitter is not None:
                        emitter.on_step(global_step=global_step, epoch=epoch,
                                        metrics=metrics,
                                        items=args.batch_size, t_start=t0)
                thr.step(args.batch_size)
                if window is not None:
                    window.on_step_end(run_step)
                if (i + 1) % args.print_freq == 0 \
                        or i + 1 == args.steps_per_epoch:
                    losses.update(float(metrics["loss"]))
                    top1s.update(float(metrics["top1"]))
                    rank_print(f"epoch {epoch} step {i + 1}/"
                               f"{args.steps_per_epoch} {losses} {top1s} "
                               f"{thr.rate:.1f} img/s "
                               f"scale {float(metrics['scale']):.0f}")
                    tb.scalars({"train/loss": losses.val,
                                "train/top1": top1s.val,
                                "train/img_per_sec": thr.rate}, global_step)
                t_tel = time.perf_counter()
                if args.save_every_steps and mgr is not None \
                        and global_step % args.save_every_steps == 0:
                    with span("checkpoint"):
                        last_saved = save_checkpoint(args, mgr, state,
                                                     global_step)
                if tickprof is not None:
                    # contiguous boundaries: the phases sum to the wall
                    t_end = time.perf_counter()
                    tickprof.observe_tick(
                        t_tick, (t_end - t_tick) * 1e3,
                        data_wait=(t_data - t_tick) * 1e3,
                        dispatch=(t_enqueue - t_data) * 1e3,
                        device=(t_device - t_enqueue) * 1e3,
                        telemetry=(t_tel - t_device) * 1e3,
                        checkpoint=(t_end - t_tel) * 1e3)
                if fault is not None:
                    fault.maybe_fire(global_step)
                if preempt is not None and preempt.preempted:
                    break
            if preempt is not None and preempt.preempted:
                break
            if eval_fn is not None:
                el, e1, e5 = (AverageMeter("loss"), AverageMeter("top1"),
                              AverageMeter("top5"))
                for j in range(args.eval_batches):
                    em = eval_fn(state, batches.eval(
                        10_000 + epoch * args.eval_batches + j))
                    el.update(float(em["loss"]))
                    e1.update(float(em["top1"]))
                    e5.update(float(em["top5"]))
                rank_print(f"epoch {epoch} EVAL loss {el.avg:.4f} "
                           f"top1 {e1.avg:.2f} top5 {e5.avg:.2f} "
                           f"({args.eval_batches} batches)")
                tb.scalars({"eval/loss": el.avg, "eval/top1": e1.avg,
                            "eval/top5": e5.avg}, global_step)
            if mgr is not None and last_saved != state.step:
                with span("checkpoint"):
                    last_saved = save_checkpoint(args, mgr, state,
                                                 global_step)
            if preempt is not None and preempt.preempted:
                break            # a signal during eval or the save
        if preempt is not None and preempt.preempted:
            return graceful_preempt_exit(args, mgr, state, preempt, emitter,
                                         global_step, last_saved, prof,
                                         device)
        if tickprof is not None and tickprof.ticks:
            emitter.sink.write(tickprof.summary_record())
    finally:
        if preempt is not None:
            preempt.close()
        close_telemetry(emitter, window, recorder, watchdog)
        if batches is not None:
            batches.close()
        tb.close()
        if mgr is not None:
            mgr.wait_until_finished()
    if prof is not None:
        stop_prof(prof, device)
    return 0


def lm_eval(args, eval_fn, state, epoch: int, batches) -> Tuple[float,
                                                                 tuple]:
    """The LM eval pass after ``epoch`` (:1772-1798): ``--eval-batches``
    held-out batches, Transformer-XL's memory fresh and carried across
    them; prints the loss and BERT's masked accuracy or the perplexity
    exp(mean loss), and returns (loss, (metric name, value))."""
    model = state.model
    el, acc = AverageMeter("loss"), AverageMeter("masked_acc")
    mems = model.init_mems(args.batch_size) if is_txl(args) else None
    for j in range(args.eval_batches):
        batch = batches.eval(10_000_000 + epoch * args.eval_batches + j)
        if mems is None:
            em = eval_fn(state, batch)
        else:
            mems, em = eval_fn(state, mems, batch)
        el.update(float(em["loss"]))
        if "masked_acc" in em:
            acc.update(float(em["masked_acc"]))
    metric = (("masked_acc", acc.avg) if args.arch.startswith("bert")
              else ("ppl", math.exp(el.avg)))
    rank_print(f"epoch {epoch} EVAL loss {el.avg:.4f} {metric[0]} "
               f"{metric[1]:.2f} ({args.eval_batches} batches)")
    return el.avg, metric


def run_lm(args, device, rank: int = 0, world: int = 1) -> int:
    """The LM path (``_lm_main_impl`` :1014), in each of ``world``
    processes (Transformer-XL's memory: this process's rows; it starts
    cold on a resume, as in JAX)."""
    state = build_state(args, device)
    model, optimizer = state.model, state.optimizer
    step_fn = build_step(args)
    eval_fn = build_eval_step(args) if args.eval else None
    mems = (model.init_mems(args.batch_size // world) if is_txl(args)
            else None)
    n_params = sum(p.numel() for p in model.parameters())
    rank_print(f"model {args.arch}: {n_params} parameters in "
          f"{len(optimizer.params)} tensors, device {device}, opt "
          f"{args.opt}, {_policy_text(state.policy, lm=True)}, attention "
          f"{attention_route(args, model)}, params from random init (seed "
          f"{args.seed})")
    mgr = CheckpointManager(args.checkpoint_dir) if args.checkpoint_dir \
        else None
    tb = TensorBoardAdapter(make_writer(args))
    emitter, window, recorder, watchdog = make_telemetry(args, device, state)
    if args.tick_profile:
        rank_print("WARNING: --tick-profile instruments the image loop "
                   "only; LM steps are not decomposed")
    preempt = batches = prof = None
    tokens = args.batch_size * args.seq_len
    try:
        preempt, fault = make_resilience(args, recorder)
        start_epoch, start_i = resume(args, state)
        if args.prof:
            prof = profiler_lib.start_trace(device)
        global_step = state.step
        batches = BatchSource(args, model.vocab_size, device, rank, world,
                              global_step)
        run_step, last_saved = 0, None
        for epoch in range(start_epoch, args.epochs):
            losses = AverageMeter("loss")
            thr = Throughput(warmup_steps=2)
            for i in range(start_i if epoch == start_epoch else 0,
                           args.steps_per_epoch):
                run_step += 1
                if window is not None:
                    window.on_step_start(run_step)
                with span("data"):
                    batch = batches.train(global_step)
                if fault is not None:
                    batch = fault.maybe_poison(global_step + 1, batch)
                t0 = time.perf_counter()
                with span("step", device=True):
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
                if window is not None:
                    window.on_step_end(run_step)
                if (i + 1) % args.print_freq == 0 \
                        or i + 1 == args.steps_per_epoch:
                    losses.update(float(metrics["loss"]))
                    extra = (f"ppl {float(metrics['ppl']):.1f} "
                             if "ppl" in metrics else "")
                    rank_print(f"epoch {epoch} step {i + 1}/"
                               f"{args.steps_per_epoch} {losses} {extra}"
                               f"{thr.rate:.0f} tok/s "
                               f"scale {float(metrics['scale']):.0f}")
                    tb.scalars({"train/loss": losses.val,
                                "train/tok_per_sec": thr.rate}, global_step)
                if args.save_every_steps and mgr is not None \
                        and global_step % args.save_every_steps == 0:
                    with span("checkpoint"):
                        last_saved = save_checkpoint(args, mgr, state,
                                                     global_step)
                if fault is not None:
                    fault.maybe_fire(global_step)
                if preempt is not None and preempt.preempted:
                    break
            if preempt is not None and preempt.preempted:
                break
            if eval_fn is not None:
                loss, (name, value) = lm_eval(args, eval_fn, state, epoch,
                                              batches)
                tb.scalars({"eval/loss": loss, f"eval/{name}": value},
                           global_step)
            if mgr is not None and last_saved != state.step:
                with span("checkpoint"):
                    last_saved = save_checkpoint(args, mgr, state,
                                                 global_step)
            if preempt is not None and preempt.preempted:
                break            # a signal during eval or the save
        if preempt is not None and preempt.preempted:
            return graceful_preempt_exit(args, mgr, state, preempt, emitter,
                                         global_step, last_saved, prof,
                                         device)
    finally:
        if preempt is not None:
            preempt.close()
        close_telemetry(emitter, window, recorder, watchdog)
        if batches is not None:
            batches.close()
        tb.close()
        if mgr is not None:
            mgr.wait_until_finished()
    if prof is not None:
        stop_prof(prof, device)
    return 0


def main(argv=None) -> int:
    return run_train(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
