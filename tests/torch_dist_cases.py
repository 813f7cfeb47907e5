"""The port's data-parallel cases, run in each of several gloo processes
on the CPU by tests/test_torch_parallel.py and tests/test_torch_zero.py.

    python tests/torch_dist_cases.py SPEC RANK WORLD STORE OUT

SPEC is a pickle the test wrote: ``{"cases": [names], ...inputs}``, every
input a numpy array (or a list or dict of them); the process joins the
gloo group through a FileStore at STORE, runs each named case on its
rank's rows and writes ``{name: numpy results}`` to OUT.  One torch
thread a process.  Imports torch and the port only, never jax.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from apex_example_tpu_torch import amp  # noqa: E402
from apex_example_tpu_torch.engine import (create_train_state,  # noqa: E402
                                           make_sharded_train_step)
from apex_example_tpu_torch.models.bert import bert_tiny  # noqa: E402
from apex_example_tpu_torch.models.gpt import gpt_tiny  # noqa: E402
from apex_example_tpu_torch.models.resnet import (BasicBlock,  # noqa: E402
                                                  ResNet)
from apex_example_tpu_torch.models.transformer_xl import \
    transformer_xl_tiny  # noqa: E402
from apex_example_tpu_torch.optim.distributed import (  # noqa: E402
    DistributedFusedAdam, make_zero_train_step)
from apex_example_tpu_torch.optim.fused import FusedAdam, FusedSGD  # noqa
from apex_example_tpu_torch.parallel import (  # noqa: E402
    DATA_AXIS, LARC, DDPConfig, DistributedDataParallel, Reducer,
    SyncBatchNorm, allreduce_grads, broadcast_from_zero)
from apex_example_tpu_torch.workloads import (lm_loss,  # noqa: E402
                                              make_sharded_txl_train_step,
                                              mlm_loss)

# the models of the cases, built as the tests build their JAX twins
RESNET = dict(stage_sizes=[1, 1], block_cls=BasicBlock, num_classes=10,
              num_filters=4, small_stem=True)
LM = dict(num_layers=1)
SGD = dict(lr=0.02, momentum=0.9, weight_decay=1e-4)
LARC_LR, LARC_TRUST, LARC_WD = 0.1, 0.02, 1e-4
ADAM = dict(lr=2e-3, eps=1e-6, weight_decay=0.01)
ALLREDUCE = {"average": (DDPConfig(), torch.float32),
             "predivide": (DDPConfig(gradient_predivide_factor=2.0),
                           torch.float32),
             "bf16": (DDPConfig(), torch.bfloat16),
             "fp32_bf16": (DDPConfig(allreduce_always_fp32=True),
                           torch.bfloat16),
             "int8": (DDPConfig(quantized_allreduce=True, quant_chunk=8),
                      torch.float32),
             "int8_predivide": (DDPConfig(quantized_allreduce=True,
                                          quant_chunk=8,
                                          gradient_predivide_factor=2.0),
                                torch.float32)}


def rows(n: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s rows of a global batch of ``n``."""
    return slice(rank * n // world, (rank + 1) * n // world)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))          # a copy: cases write


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().copy()


def _state_dict(model) -> dict:
    return {k: _np(v) for k, v in model.state_dict().items()}


def _syncbn(spec, rank, world, fused, device="cpu"):
    from apex_example_tpu_torch.ops import batch_norm as bn
    x, w = spec["bn_x"], spec["bn_w"]
    r = rows(x.shape[0], rank, world)
    m = SyncBatchNorm(x.shape[-1], fused_kernel=fused, axis_name=DATA_AXIS,
                      device=device)
    m.load_state_dict({k: _t(v) for k, v in spec["bn_sd"].items()})
    xr = _t(x[r]).to(device).requires_grad_()
    launches = bn.bn_stats_cuda.launches, bn.bn_bwd_sums_cuda.launches
    y = m(xr)
    (y * _t(w[r]).to(device)).sum().backward()
    return {"y": _np(y.cpu()), "mean": _np(m.mean.cpu()),
            "var": _np(m.var.cpu()), "dx": _np(xr.grad.cpu()),
            "dscale": _np(m.scale.grad.cpu()),
            "dbias": _np(m.bias.grad.cpu()),
            "launches": (bn.bn_stats_cuda.launches - launches[0],
                         bn.bn_bwd_sums_cuda.launches - launches[1])}


def case_syncbn_composite(spec, rank, world):
    return _syncbn(spec, rank, world, fused=False)


def case_syncbn_fused(spec, rank, world):
    return _syncbn(spec, rank, world, fused=True)


def case_zero_cli(spec, rank, world):
    """The trainer's command line with --zero in this process group (the
    launcher's part done): its exit code and what it printed."""
    import contextlib
    import io
    from apex_example_tpu_torch import train
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train.main(["--device", "cpu", "--arch", "bert_tiny", "--opt",
                         "adam", "--zero", "--batch-size", "4", "--seq-len",
                         "16", "--steps-per-epoch", "2", "--print-freq",
                         "1", "--metrics-jsonl", spec["zero_cli_stream"]])
    return {"rc": rc, "out": out.getvalue()}


def case_zero_resume(spec, rank, world):
    """bert_tiny with --zero --opt adam through the trainer: 2 epochs of 2
    steps without a break (with --metrics-all-ranks), and 1 epoch with
    --checkpoint-dir then --resume for the second, every process restoring
    the same files.  Each run saves its last step; rank 0 returns both
    final checkpoints' tensors."""
    import contextlib
    import io
    from apex_example_tpu_torch import train
    base = ["--device", "cpu", "--arch", "bert_tiny", "--opt", "adam",
            "--lr", "1e-3", "--zero", "--batch-size", "4", "--seq-len",
            "16", "--steps-per-epoch", "2", "--print-freq", "1"]
    root = spec["zero_resume_dir"]
    whole, broken = os.path.join(root, "whole"), os.path.join(root, "broken")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rcs = [train.main(base + ["--epochs", "2", "--checkpoint-dir", whole,
                                  "--metrics-jsonl",
                                  os.path.join(root, "run.jsonl"),
                                  "--metrics-all-ranks"]),
               train.main(base + ["--epochs", "1", "--checkpoint-dir",
                                  broken]),
               train.main(base + ["--epochs", "2", "--resume", broken,
                                  "--checkpoint-dir", broken])]
    result = {"rcs": rcs, "out": out.getvalue()}
    dist.barrier()                      # rank 0's last write has landed
    if rank == 0:
        for name, path in (("whole", whole), ("broken", broken)):
            result[name] = {part: torch.load(
                os.path.join(path, "4", f"{part}.pt"), weights_only=True)
                for part in ("model", "optimizer", "state")}
    return result


def case_card_syncbn_composite(spec, rank, world):
    return _syncbn(spec, rank, world, fused=False, device="cuda")


def case_card_syncbn_fused(spec, rank, world):
    return _syncbn(spec, rank, world, fused=True, device="cuda")


def case_card_zero_adam(spec, rank, world):
    """DistributedFusedAdam on the card over ``spec["params"]`` with this
    rank's grads of each step (``spec["grads"][step][rank]``); an inf in
    rank 1's grad of element 0 of the first tensor at step 1 (rank 0's
    shard).  Every step's parameters, the count and the Adam launches."""
    from apex_example_tpu_torch.ops import fused_optim as fo
    params = [_t(p).cuda() for p in spec["params"]]
    opt = DistributedFusedAdam(params, **ADAM)
    out = {"params": [], "count": [], "shard": opt.shard}
    launches = fo.adam_cuda.launches
    for k, grads in enumerate(spec["zero_grads"]):
        with torch.no_grad():
            for p, g in zip(params, grads[rank]):
                p.grad.copy_(_t(g))
            if k == 1 and rank == 1:
                params[0].grad.view(-1)[0] = float("inf")
        opt.reduce_grads()
        opt.step()
        out["params"].append([_np(p.cpu()) for p in params])
        out["count"].append(opt.step_count)
    out["launches"] = fo.adam_cuda.launches - launches
    return out


def case_allreduce(spec, rank, world):
    """allreduce_grads under each ALLREDUCE config; then apex's facades:
    DistributedDataParallel(gradient_predivide_factor=2).allreduce,
    Reducer(gradient_average=False).reduce, and broadcast_from_zero."""
    out = {}
    for name, (cfg, dtype) in ALLREDUCE.items():
        grads = [_t(g[rank]).to(dtype) for g in spec["grads"]]
        allreduce_grads(grads, cfg, DATA_AXIS)
        out[name] = [_np(g) for g in grads]
    for name, reduce in (
            ("ddp_predivide", DistributedDataParallel(
                gradient_predivide_factor=2.0).allreduce),
            ("reducer_sum", Reducer(gradient_average=False).reduce),
            ("broadcast", broadcast_from_zero)):
        grads = [_t(g[rank]) for g in spec["grads"]]
        reduce(grads)
        out[name] = [_np(g) for g in grads]
    return out


def _trail(step, state, batches, rank, world, mems=None):
    """Run ``step`` over rank's rows of ``batches``; per step metrics (and
    the memory, for Transformer-XL)."""
    out = {"metrics": [], "mems": []}
    for x, y in batches:
        r = rows(x.shape[0], rank, world)
        yr = (tuple(_t(a[r]) for a in y) if isinstance(y, tuple)
              else _t(y[r]))
        if mems is None:
            state, met = step(state, (_t(x[r]), yr))
        else:
            state, mems, met = step(state, mems, (_t(x[r]), yr))
            out["mems"].append(_np(mems))
        out["metrics"].append({k: float(v) for k, v in met.items()})
    out["sd"] = _state_dict(state.model)
    return out


def _resnet(spec, axis):
    model = ResNet(**RESNET, bn_axis_name=axis, device="cpu")
    model.load_state_dict({k: _t(v) for k, v in spec["resnet_sd"].items()})
    return model


def case_ddp_resnet(spec, rank, world):
    model = _resnet(spec, DATA_AXIS)
    state = create_train_state(model, FusedSGD(model.parameters(), **SGD))
    return _trail(make_sharded_train_step(DATA_AXIS), state,
                  spec["img_batches"], rank, world)


def case_ddp_resnet_larc(spec, rank, world):
    model = _resnet(spec, DATA_AXIS)
    inner = FusedSGD(model.parameters(), lr=LARC_LR, momentum=0.9,
                     weight_decay=0.0)
    opt = LARC(inner, trust_coefficient=LARC_TRUST, lr=LARC_LR,
               weight_decay=LARC_WD)
    state = create_train_state(model, opt)
    return _trail(make_sharded_train_step(DATA_AXIS), state,
                  spec["img_batches"], rank, world)


def case_ddp_gpt(spec, rank, world):
    model = gpt_tiny(**LM, device="cpu")
    model.load_state_dict({k: _t(v) for k, v in spec["gpt_sd"].items()})
    state = create_train_state(model, FusedAdam(model.parameters(), **ADAM))
    step = make_sharded_train_step(DATA_AXIS, loss_fn=lm_loss,
                                   compute_accuracy=False)
    return _trail(step, state, spec["lm_batches"], rank, world)


def case_ddp_txl(spec, rank, world, grad_accum=1):
    model = transformer_xl_tiny(**LM, device="cpu")
    model.load_state_dict({k: _t(v) for k, v in spec["txl_sd"].items()})
    state = create_train_state(model, FusedAdam(model.parameters(), **ADAM))
    step = make_sharded_txl_train_step(DATA_AXIS, max_grad_norm=0.25,
                                       grad_accum=grad_accum)
    b = spec["lm_batches"][0][0].shape[0]
    return _trail(step, state, spec["lm_batches"], rank, world,
                  mems=model.init_mems(b // world))


def case_ddp_accum_gpt(spec, rank, world):
    """gpt_tiny's DDP trail with each rank's rows in 2 microbatches."""
    model = gpt_tiny(**LM, device="cpu")
    model.load_state_dict({k: _t(v) for k, v in spec["gpt_sd"].items()})
    state = create_train_state(model, FusedAdam(model.parameters(), **ADAM))
    step = make_sharded_train_step(DATA_AXIS, loss_fn=lm_loss,
                                   compute_accuracy=False, grad_accum=2)
    return _trail(step, state, spec["lm_batches"], rank, world)


def case_ddp_accum_txl(spec, rank, world):
    """transformer_xl_tiny's, each rank's streams in 2 groups."""
    return case_ddp_txl(spec, rank, world, grad_accum=2)


def _zero(spec, rank, world, loss_scale, level="O0", half=None):
    """ZeRO-1 at amp ``level`` (``half`` its reduced dtype) with
    ``loss_scale``: a clean step, a step with an inf planted in rank 1's
    grad of the first parameter (element 0, which lies in rank 0's shard:
    rank 1's own shard stays finite), then the same batch again and the
    next; every step's parameters, shards of mu and nu, count and
    scale."""
    policy, scaler = amp.initialize(level, loss_scale=loss_scale,
                                    half_dtype=half)
    md = amp.module_dtypes(policy)
    model = bert_tiny(**LM, device="cpu", dtype=md.compute,
                      param_dtype=md.param, ln_dtype=md.ln_io,
                      softmax_dtype=md.softmax)
    model.load_state_dict({k: _t(v) for k, v in spec["bert_sd"].items()})
    opt = DistributedFusedAdam(model.parameters(), **ADAM)
    state = create_train_state(model, opt, policy, scaler)
    step = make_zero_train_step(mlm_loss, compute_accuracy=False)
    first = opt.params[0]
    b0, b1, b2 = spec["mlm_batches"]
    out = {"shard": opt.shard, "padded": opt.padded, "steps": []}
    for i, (ids, target) in enumerate([b0, b1, b1, b2]):
        hook = None
        if i == 1 and rank == 1:
            def plant(g):
                g = g.clone()
                g.view(-1)[0] = float("inf")
                return g
            hook = first.register_hook(plant)
        r = rows(ids.shape[0], rank, world)
        state, met = step(state, (_t(ids[r]),
                                  tuple(_t(a[r]) for a in target)))
        if hook is not None:
            hook.remove()
        out["steps"].append({
            "metrics": {k: float(v) for k, v in met.items()},
            "sd": _state_dict(model), "mu": _np(opt.mu), "nu": _np(opt.nu),
            "count": opt.step_count, "scale": float(state.scaler.scale)})
    return out


def case_zero(spec, rank, world):
    """Under dynamic scaling: the scaler's flag and the shards' skip."""
    return _zero(spec, rank, world, "dynamic")


def case_zero_static(spec, rank, world):
    """Under the identity scaler: the shards' flag, reduced over the
    ranks, skips alone."""
    return _zero(spec, rank, world, None)


def case_zero_fp16(spec, rank, world):
    """At O2 in fp16 under dynamic scaling (the fp16 contract)."""
    return _zero(spec, rank, world, "dynamic", "O2", torch.float16)


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}


class Ranks:
    """``world`` processes running this file's cases on ``spec`` (started
    at construction, gloo through a FileStore in ``workdir``);
    :meth:`results` waits for them, at most ``timeout`` seconds in all,
    and kills them all if one fails or the time runs out."""

    def __init__(self, spec: dict, workdir, world: int = 2,
                 timeout: float = 240.0):
        import subprocess
        import time
        self.world, self.deadline = world, time.monotonic() + timeout
        workdir = str(workdir)
        spec_path = os.path.join(workdir, "spec.pkl")
        with open(spec_path, "wb") as fh:
            pickle.dump(spec, fh)
        store = os.path.join(workdir, "store")
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        self.outs, self.logs, self.procs = [], [], []
        for r in range(world):
            out = os.path.join(workdir, f"rank{r}.pkl")
            log = open(os.path.join(workdir, f"rank{r}.log"), "w")
            self.outs.append(out)
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), spec_path,
                 str(r), str(world), store, out],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=workdir))

    def results(self) -> list:
        import subprocess
        import time
        try:
            for proc in self.procs:
                left = max(self.deadline - time.monotonic(), 0.1)
                try:
                    rc = proc.wait(timeout=left)
                except subprocess.TimeoutExpired:
                    raise AssertionError("a rank did not finish in time: "
                                         + self._tails())
                if rc != 0:
                    raise AssertionError(f"a rank exited {rc}: "
                                         + self._tails())
        finally:
            for proc in self.procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)
            for log in self.logs:
                log.close()
        out = []
        for path in self.outs:
            with open(path, "rb") as fh:
                out.append(pickle.load(fh))
        return out

    def _tails(self) -> str:
        texts = []
        for log in self.logs:
            log.flush()
            with open(log.name) as fh:
                texts.append(fh.read()[-3000:])
        return "\n".join(texts)


def main(argv) -> int:
    spec_path, rank, world, store, out_path = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        with open(spec_path, "rb") as fh:
            spec = pickle.load(fh)
        results = {name: CASES[name](spec, rank, world)
                   for name in spec["cases"]}
    finally:
        dist.destroy_process_group()
    with open(out_path + ".tmp", "wb") as fh:
        pickle.dump(results, fh)
    os.replace(out_path + ".tmp", out_path)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
