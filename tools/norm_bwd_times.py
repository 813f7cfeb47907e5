#!/usr/bin/env python3
"""Device times of the port's LayerNorm and RMSNorm backward kernels beside
their PyTorch calls, fp32, at few rows and at the training shapes.

    python3 tools/norm_bwd_times.py [--root DIR] [--label NAME]

``--root`` names the checkout whose ``apex_example_tpu_torch`` is timed
(default: this one), so that two checkouts alternate in one process list
on one card: parent, change, change, parent.  Each kernel is built from
that checkout's sources into its own ``build/kernels/``.  Per shape one
line: layer_norm_bwd_cuda and torch's native_layer_norm_backward,
rms_norm_bwd_cuda and F.rms_norm's autograd backward, each the median
device time of 200 launches queued behind a spin kernel (CUDA events);
then one JSON line with the same numbers.  Exits 2 where torch sees no
CUDA device.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

SHAPES = [(128, 768), (37, 777), (64, 8192), (4096, 768), (6144, 410)]


def device_ms(fn, reps=200, warmup=20):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(200_000_000)
    events[0].record()
    for e in events[1:]:
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b)
                             for a, b in zip(events, events[1:]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("norm_bwd_times: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from apex_example_tpu_torch.ops import layer_norm as ln
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"norm_bwd_times: {args.label} ({ln.__file__}) on {smi}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    rows = {}
    for n, h in SHAPES:
        x = torch.randn(n, h, device=dev, generator=gen) * 2 + 0.5
        g = torch.randn(h, device=dev, generator=gen) * 0.2 + 1
        b = torch.randn(h, device=dev, generator=gen) * 0.2
        dy = torch.randn(n, h, device=dev, generator=gen)
        _, mean, rstd = ln.layer_norm_plain(x, g, b)
        _, rrstd = ln.rms_norm_plain(x, g)
        xr, gr = x.detach().requires_grad_(), g.detach().requires_grad_()
        yr = torch.nn.functional.rms_norm(xr, (h,), gr, 1e-5)
        ms = {
            "ln": device_ms(lambda: ln.layer_norm_bwd_cuda(
                x, g, mean, rstd, dy)),
            "ln_library": device_ms(
                lambda: torch.ops.aten.native_layer_norm_backward(
                    dy, x, [h], mean[:, None], rstd[:, None], g, b,
                    [True, True, True])),
            "rms": device_ms(lambda: ln.rms_norm_bwd_cuda(x, g, rrstd, dy)),
            "rms_library": device_ms(lambda: torch.autograd.grad(
                yr, (xr, gr), dy, retain_graph=True)),
        }
        rows[f"{n}x{h}"] = ms
        print(f"norm_bwd_times: {args.label} {n}x{h} float32: layer_norm_bwd "
              f"{ms['ln']:.5f} ms  native_layer_norm_backward "
              f"{ms['ln_library']:.5f} ms  rms_norm_bwd {ms['rms']:.5f} ms  "
              f"F.rms_norm backward {ms['rms_library']:.5f} ms")
    print(json.dumps({"label": args.label, "device": smi, "ms": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
