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
the global step, made on the device (data/synthetic.py); the eval batches
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
archs (train.py :699-709), and the LM archs run without ``--eval`` (their
eval steps come with a later slice).  Entry
points run on the card unless ``--device cpu`` is given, and raise when
CUDA is asked for and absent.  The flags of paths not ported yet (model
parallelism, checkpoints, grad accumulation, diagnostics) are absent, so
argparse rejects them.

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

Each printed step is train.py's line: ``epoch E step i/N loss L (avg)
top1 T (avg) R img/s scale S`` for images (:895-899), ``epoch E step i/N
loss L (avg) [ppl P ]R tok/s scale S`` for LMs (:1747-1752); after each
epoch with ``--eval``, ``epoch E EVAL loss L top1 T top5 T5 (N batches)``
(:951-953).  With ``--metrics-jsonl`` the run writes a run_header, one
step record per step (``items`` are images or tokens) and a run_summary
(obs/telemetry.py), which the JAX package's tools read unchanged.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from apex_example_tpu_torch import amp, resolve_device
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
from apex_example_tpu_torch.obs.logging import rank_print
from apex_example_tpu_torch.obs.metrics import JsonlSink
from apex_example_tpu_torch.obs.telemetry import TelemetryEmitter
from apex_example_tpu_torch.optim.distributed import (DistributedFusedAdam,
                                                      make_zero_train_step)
from apex_example_tpu_torch.optim.fused import (FusedAdagrad, FusedAdam,
                                                FusedLAMB, FusedNovoGrad,
                                                FusedSGD)
from apex_example_tpu_torch.optim.schedules import build_schedule
from apex_example_tpu_torch.parallel.distributed import DDPConfig
from apex_example_tpu_torch.parallel.larc import LARC
from apex_example_tpu_torch.parallel.launch import (
    is_main_process, local_device, maybe_initialize_distributed)
from apex_example_tpu_torch.parallel.mesh import DATA_AXIS
from apex_example_tpu_torch.utils.meters import AverageMeter, Throughput
from apex_example_tpu_torch.workloads import (lm_loss, make_txl_train_step,
                                              make_sharded_txl_train_step,
                                              mlm_loss)

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
                   help="evaluate after each epoch (image archs)")
    p.add_argument("--eval-batches", type=int, default=10)
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
            **kw)
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


def check_args(args) -> None:
    """What the parser cannot say: sizes, and the flags a path does not
    take yet."""
    for flag in ("epochs", "steps_per_epoch", "batch_size", "seq_len",
                 "print_freq", "eval_batches"):
        if getattr(args, flag) < 1:
            raise SystemExit(f"--{flag.replace('_', '-')} must be >= 1")
    if args.fused_attention and not args.arch.startswith(("bert", "gpt")):
        raise SystemExit("--fused-attention is wired for the BERT/GPT "
                         "archs only")
    if args.fused_attention and args.opt_level == "O3":
        raise SystemExit("--fused-attention requires fp32 softmax "
                         "(opt levels O0-O2); O3 runs softmax half")
    if args.eval and not is_image(args):
        raise SystemExit("--eval is ported for the image archs; the LM "
                         "eval steps come with a later slice (ROADMAP.md "
                         "A.5)")


def check_parallel_args(args, world: int) -> None:
    """The data-parallel refusals, with the JAX trainer's messages
    (train.py :324-330, :592-626, :1165-1169), in its order."""
    if args.batch_size % world:
        raise SystemExit(f"--batch-size {args.batch_size} not divisible by "
                         f"{world} devices")
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
    world = data_world()
    lm_loss_fn = mlm_loss if args.arch.startswith("bert") else lm_loss
    if world > 1 and args.zero:
        if is_image(args):
            return make_zero_train_step()
        return make_zero_train_step(lm_loss_fn, compute_accuracy=False)
    if is_image(args):
        if world == 1:
            return make_train_step()
        return make_sharded_train_step(DATA_AXIS, ddp=DDPConfig(
            delay_allreduce=args.delay_allreduce,
            gradient_predivide_factor=args.gradient_predivide_factor,
            quantized_allreduce=args.quantized_allreduce == "int8",
            quant_chunk=args.quant_chunk))
    if is_txl(args):
        if world == 1:
            return make_txl_train_step(args.max_grad_norm)
        return make_sharded_txl_train_step(DATA_AXIS,
                                           max_grad_norm=args.max_grad_norm)
    if world == 1:
        return make_train_step(lm_loss_fn, compute_accuracy=False)
    return make_sharded_train_step(DATA_AXIS, loss_fn=lm_loss_fn,
                                   compute_accuracy=False)


def run_train(args) -> int:
    """Check the arguments, join the launcher's process group if there is
    one (leaving it at the end), and train."""
    device = resolve_device(args.device)
    check_args(args)
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


def _emitter(args, device):
    if not args.metrics_jsonl or not is_main_process():
        return None
    emitter = TelemetryEmitter(JsonlSink(args.metrics_jsonl), device)
    emitter.run_header(config=vars(args), argv=sys.argv[1:], arch=args.arch)
    return emitter


def run_image(args, device, rank: int = 0, world: int = 1) -> int:
    """The image path of train.py's ``main`` (:628-994), in each of
    ``world`` processes."""
    state = build_state(args, device)
    step_fn = build_step(args)
    eval_fn = make_eval_step()
    n_params = sum(p.numel() for p in state.model.parameters())
    rank_print(f"model {args.arch}: {n_params} parameters in "
          f"{len(state.optimizer.params)} tensors, dataset {args.dataset}, "
          f"device {device}, opt {args.opt}, {_policy_text(state.policy)}, "
          f"params from random init (seed {args.seed})")

    emitter = _emitter(args, device)
    global_step = 0
    try:
        for epoch in range(args.epochs):
            losses, top1s = AverageMeter("loss"), AverageMeter("top1")
            thr = Throughput(warmup_steps=2)
            for i in range(args.steps_per_epoch):
                batch = batch_fn(args, 0, global_step, device, rank, world)
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch)
                global_step += 1
                if emitter is not None:
                    emitter.on_step(global_step=global_step, epoch=epoch,
                                    metrics=metrics, items=args.batch_size,
                                    t_start=t0)
                thr.step(args.batch_size)
                if (i + 1) % args.print_freq == 0 \
                        or i + 1 == args.steps_per_epoch:
                    losses.update(float(metrics["loss"]))
                    top1s.update(float(metrics["top1"]))
                    rank_print(f"epoch {epoch} step {i + 1}/"
                               f"{args.steps_per_epoch} {losses} {top1s} "
                               f"{thr.rate:.1f} img/s "
                               f"scale {float(metrics['scale']):.0f}")
            if args.eval:
                el, e1, e5 = (AverageMeter("loss"), AverageMeter("top1"),
                              AverageMeter("top5"))
                for j in range(args.eval_batches):
                    em = eval_fn(state, batch_fn(
                        args, 0, 10_000 + epoch * args.eval_batches + j,
                        device))
                    el.update(float(em["loss"]))
                    e1.update(float(em["top1"]))
                    e5.update(float(em["top5"]))
                rank_print(f"epoch {epoch} EVAL loss {el.avg:.4f} "
                           f"top1 {e1.avg:.2f} top5 {e5.avg:.2f} "
                           f"({args.eval_batches} batches)")
    finally:
        if emitter is not None:
            emitter.close()
    return 0


def run_lm(args, device, rank: int = 0, world: int = 1) -> int:
    """The LM path (``_lm_main_impl`` :1014), in each of ``world``
    processes (Transformer-XL's memory: this process's rows)."""
    state = build_state(args, device)
    model, optimizer = state.model, state.optimizer
    step_fn = build_step(args)
    mems = (model.init_mems(args.batch_size // world) if is_txl(args)
            else None)
    n_params = sum(p.numel() for p in model.parameters())
    rank_print(f"model {args.arch}: {n_params} parameters in "
          f"{len(optimizer.params)} tensors, device {device}, opt "
          f"{args.opt}, {_policy_text(state.policy, lm=True)}, attention "
          f"{attention_route(args, model)}, params from random init (seed "
          f"{args.seed})")

    emitter = _emitter(args, device)
    tokens = args.batch_size * args.seq_len
    global_step = 0
    try:
        for epoch in range(args.epochs):
            losses = AverageMeter("loss")
            thr = Throughput(warmup_steps=2)
            for i in range(args.steps_per_epoch):
                batch = batch_fn(args, model.vocab_size, global_step,
                                 device, rank, world)
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
                    rank_print(f"epoch {epoch} step {i + 1}/"
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
