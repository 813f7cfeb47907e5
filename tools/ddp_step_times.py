"""C3's data-parallel step (resnet50, ImageNet shapes, O2, batch 256,
SyncBatchNorm composite, NCCL group of this one process) against the
plain c2 step, in one fresh process, in turn: plain, ddp, ddp, plain.

Each turn builds the state from seed 0, takes WARM steps, then STEPS
timed ones.  Per step: the host's time until the step returns (what it
takes to queue the step), and the time until its loss is read (the step
time, as chip_smoke.py's ``c2:`` and ``ddp:`` read it).  Prints one JSON
line of the medians with the card's name and power limit.

    python3 tools/ddp_step_times.py [--steps 10]
"""

import argparse
import gc
import json
import os
import statistics
import sys
import tempfile
import time

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from apex_example_tpu_torch import train  # noqa: E402
from apex_example_tpu_torch.engine import \
    make_sharded_train_step  # noqa: E402
from apex_example_tpu_torch.parallel import (convert_syncbn_model,  # noqa
                                             make_data_mesh)
from tools.allreduce_host import smi_line  # noqa: E402

WARM = 3


def _turn(args, mesh, ddp: bool, steps: int) -> dict:
    state = train.build_state(args, "cuda")
    if ddp:
        convert_syncbn_model(state.model, mesh)
        step = make_sharded_train_step(mesh)
    else:
        step = train.build_step(args)
    host, total = [], []
    for i in range(WARM + steps):
        batch = train.batch_fn(args, 0, i, "cuda", mesh.rank, mesh.world)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        t1 = time.perf_counter()
        float(met["loss"])
        t2 = time.perf_counter()
        if i >= WARM:
            host.append((t1 - t0) * 1e3)
            total.append((t2 - t0) * 1e3)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"host_ms": statistics.median(host),
            "step_ms": statistics.median(total)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    a = ap.parse_args()
    store = os.path.join(tempfile.mkdtemp(), "store")
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = make_data_mesh()
        args = train.build_parser().parse_args(chip_smoke.DDP_ARGS)
        out = {"card": smi_line(), "turns": []}
        for label in ("plain", "ddp", "ddp", "plain"):
            out["turns"].append(dict(_turn(args, mesh, label == "ddp",
                                           a.steps), turn=label))
        print(json.dumps(out))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
