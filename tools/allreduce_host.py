"""Host time of ``torch.distributed.all_reduce`` on an NCCL group of one
process, the call the port's data-parallel step makes (SyncBatchNorm's
moments, the grads, the averages), against a plain kernel launch.

Each measurement issues N calls on a 2 x 1024 fp32 tensor and times them
on the host (time.perf_counter), twice: with the device idle, and right
after queueing ~BUSY_MS of matrix products, so that a call which waits
for the device shows that wait in its host time.  Prints one JSON line
with the card's name and power limit.

    python3 tools/allreduce_host.py [--calls 110] [--busy-ms 60]
"""

import argparse
import json
import os
import subprocess
import tempfile
import time

import torch
import torch.distributed as dist


def smi_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _host_ms(fn, calls: int, busy) -> float:
    """Host ms a call of ``fn`` over ``calls`` calls, after ``busy()``
    has queued device work (or nothing)."""
    torch.cuda.synchronize()
    busy()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return dt


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=110)
    ap.add_argument("--busy-ms", type=float, default=60.0)
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args()
    store = os.path.join(tempfile.mkdtemp(), "store")
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        x = torch.ones(2, 1024, device="cuda")
        m = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            m @ m
        torch.cuda.synchronize()
        per_mm = (time.perf_counter() - t0) * 1e3 / 10
        n_mm = max(1, round(a.busy_ms / per_mm))

        def busy():
            for _ in range(n_mm):
                m @ m

        def idle():
            pass

        calls = {"all_reduce": lambda: dist.all_reduce(x),
                 "clone_all_reduce": lambda: dist.all_reduce(x.clone()),
                 "add_": lambda: x.add_(0.0)}
        out = {"card": smi_line(), "calls": a.calls,
               "busy_ms_queued": n_mm * per_mm}
        for name, fn in calls.items():
            for _ in range(3):                              # warm
                fn()
            for label, pre in (("idle", idle), ("busy", busy)):
                times = sorted(_host_ms(fn, a.calls, pre)
                               for _ in range(a.reps))
                out[f"{name}_{label}_ms_a_call"] = times[len(times) // 2]
        print(json.dumps(out))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
