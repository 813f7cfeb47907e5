#!/usr/bin/env python3
"""Drive the PyTorch port (apex_example_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout, on a GPU

Phases, one or more lines each:

1. env     — the card's name and power limit (nvidia-smi, on a line of its
             own), torch and CUDA versions.
2. build   — compiles every kernel source of the serving path with nvcc
             (all at once) and prints ptxas's register/spill report.
3. kernels — each kernel against its plain PyTorch version on the card:
             LayerNorm forward at the serving shape (slots * block_size
             rows x 768, fp32), in bf16, at a ragged row count, at H = 64,
             at an odd H and at H = 8192.  Tolerances: fp32 atol = rtol =
             1e-5; bf16 one bf16 ulp of the output plus 1e-5 (the fp32
             rounding of a result that cancels to near zero).  Then the kernel's,
             the plain version's and torch.nn.functional.layer_norm's
             (the library yardstick, used nowhere in the port) median
             device time at the serving shape, beside the kernel's bound.
4. main    — gpt_base at full width (random weights from seed 0) served
             through the port's run_serve on cuda: 32 requests with a
             shared prefix through 8 slots of a block-paged cache.  Every
             request must finish ok, the LayerNorm kernel must have been
             launched 26 times per compute tick (embeddings_ln, two per
             layer, final_ln), and a teacher-forced full forward must
             agree with each served greedy token of four requests: the
             token is the argmax there, or within 1e-4 of the top logit
             (fp32 sums in another order may flip a near-tie).

Then one JSON line per the port's kernel table ({"kernels": [...]}) and,
last, {"ok": true, "device": {...}}.  Any failure raises and exits non-zero
before the last line; so does a machine where torch sees no CUDA device.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_OPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
FP32_TOL = 1e-5
TIE_TOL = 1e-4
SLOTS, BLOCK = 8, 16
SERVE_ARGS = ["--device", "cuda", "--arch", "gpt_base",
              "--slots", str(SLOTS), "--max-len", "512",
              "--block-size", str(BLOCK), "--requests", "32",
              "--prompt-len", "32:192", "--shared-prefix", "32",
              "--max-new", "16:96", "--stagger", "2", "--seed", "0"]


def _bf16_tol(a, b):
    """One bf16 ulp at the larger magnitude of each pair, plus the fp32
    tolerance: near zero, (x - mean) * rstd * gamma + beta cancels and
    its fp32 rounding error (~1e-7 of the operands) exceeds the ulp."""
    mag = torch.maximum(torch.maximum(a.abs(), b.abs()),
                        torch.full_like(a, 2.0 ** -126))
    return torch.exp2(torch.floor(torch.log2(mag)) - 7) + FP32_TOL


def _device_ms(fn, reps=200, warmup=20):
    """Median device time of one call of ``fn``: the calls are queued
    behind a spin kernel, so they run back to back and each interval
    between two events is device time, not the host's launch overhead."""
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


def _call_ms(fn, reps=200, warmup=20):
    """Median time per call as Python issues them (host overhead
    included): CUDA events around each call of an idle stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in pairs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def phase_env():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"env: torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}  "
          f"count {torch.cuda.device_count()}")


def phase_build(build):
    t0 = time.perf_counter()
    reports = build.build(["layer_norm"])
    dt = time.perf_counter() - t0
    print(f"build: layer_norm.cu -> {build.library_path('layer_norm').name}"
          f" in {dt:.1f} s" + ("" if reports else " (already built)"))
    for text in reports.values():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                print(f"build:   {line.strip()}")


def phase_kernels(ln):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    path_rows = SLOTS * BLOCK
    cases = [(path_rows, 768, torch.float32), (path_rows, 768, torch.bfloat16),
             (1000, 768, torch.float32), (1000, 768, torch.bfloat16),
             (path_rows, 64, torch.float32), (path_rows, 64, torch.bfloat16),
             (37, 777, torch.float32), (64, 8192, torch.float32)]
    path_err = None
    for n, h, dtype in cases:
        x = (torch.randn(n, h, device=dev, generator=gen) * 2 + 0.5).to(dtype)
        g = torch.randn(h, device=dev, generator=gen) * 0.2 + 1
        b = torch.randn(h, device=dev, generator=gen) * 0.2
        got = ln.layer_norm_cuda(x, g, b)
        want = ln.layer_norm_plain(x, g, b)
        torch.cuda.synchronize()
        y, y_ref = got[0].float(), want[0].float()
        err = (y - y_ref).abs()
        if dtype == torch.float32:
            ok = bool((err <= FP32_TOL + FP32_TOL * y_ref.abs()).all())
        else:
            ok = bool((err <= _bf16_tol(y, y_ref)).all())
        stat_err = max(float((a - r).abs().max())
                       for a, r in zip(got[1:], want[1:]))
        stat_ok = all(bool((a - r).abs().le(FP32_TOL + FP32_TOL * r.abs())
                           .all()) for a, r in zip(got[1:], want[1:]))
        max_err = float(err.max())
        if not ok:
            y32 = ln.layer_norm_plain(x.float(), g, b)[0]
            bad = (err > _bf16_tol(y, y_ref)).nonzero()[:5].tolist()
            for r, c in bad:
                print(f"kernels:   row {r} col {c}: x {float(x[r, c])!r} "
                      f"kernel {float(y[r, c])!r} plain {float(y_ref[r, c])!r}"
                      f" fp32 {float(y32[r, c])!r} tol "
                      f"{float(_bf16_tol(y, y_ref)[r, c])!r}")
        print(f"kernels: layer_norm_fwd {n}x{h} {str(dtype)[6:]}: "
              f"max|dy| {max_err:.3g}  max|dmean|,|drstd| {stat_err:.3g}  "
              f"{'ok' if ok and stat_ok else 'MISMATCH'}")
        if not (ok and stat_ok):
            raise SystemExit(f"layer_norm kernel disagrees with its plain "
                             f"version at {n}x{h} {dtype}")
        if (n, h, dtype) == (path_rows, 768, torch.float32):
            path_err = max_err

    n, h = path_rows, 768
    x = torch.randn(n, h, device=dev, generator=gen)
    g = torch.randn(h, device=dev, generator=gen) * 0.2 + 1
    b = torch.randn(h, device=dev, generator=gen) * 0.2
    kernel = lambda: ln.layer_norm_cuda(x, g, b)           # noqa: E731
    plain = lambda: ln.layer_norm_plain(x, g, b)           # noqa: E731
    library = lambda: torch.nn.functional.layer_norm(      # noqa: E731
        x, (h,), g, b, 1e-5)
    ms = {name: _device_ms(fn) for name, fn in
          (("kernel", kernel), ("plain", plain), ("library", library))}
    call_ms = _call_ms(kernel)
    nbytes = n * h * (4 + 4) + 2 * h * 4 + 8 * n
    ops = 8 * n * h
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"kernels: layer_norm_fwd {n}x{h} float32 device time: kernel "
          f"{ms['kernel']:.5f} ms  plain {ms['plain']:.5f} ms  "
          f"F.layer_norm {ms['library']:.5f} ms  bound {bound_ms:.6f} ms "
          f"({nbytes} bytes over 3.35 TB/s)  per call from Python "
          f"{call_ms:.5f} ms")
    return {"name": "layer_norm_fwd", "route": "cuda",
            "source": "apex_example_tpu_torch/csrc/layer_norm.cu",
            "replaces": "apex_example_tpu/ops/layer_norm.py:66",
            "max_abs_err": path_err, "ms": ms["kernel"],
            "plain_ms": ms["plain"], "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": ms["library"]}


def phase_main(cli, ln, gpt_base):
    args = cli.build_parser().parse_args(SERVE_ARGS)
    torch.cuda.reset_peak_memory_stats()
    ln.layer_norm_cuda.launches = 0
    t0 = time.perf_counter()
    completions, summary, rc = cli.run_serve(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ln.layer_norm_cuda.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    ok = sum(c.status == "ok" for c in completions)
    ticks = summary["compute_steps"]
    model = gpt_base(seed=args.seed, device="cuda").eval()
    per_tick = 2 * model.num_layers + 2
    print(f"main: gpt_base {ok}/{len(completions)} ok  compute ticks "
          f"{ticks} (steps {summary['steps']})  layer_norm launches "
          f"{launches} (want {per_tick} x {ticks} = {per_tick * ticks})  "
          f"tokens/s {summary['tokens_per_sec']}  ttft p50/p95 "
          f"{summary['ttft_ms']['p50']}/{summary['ttft_ms']['p95']} ms  "
          f"tpot p50/p95 {summary['tpot_ms']['p50']}/"
          f"{summary['tpot_ms']['p95']} ms  wall {wall:.1f} s  "
          f"max memory {peak_gib:.2f} GiB")
    if rc != 0 or ok != len(completions) or len(completions) != 32:
        raise SystemExit(f"serving run: rc {rc}, {ok} ok of "
                         f"{len(completions)} (want 32)")
    if launches != per_tick * ticks:
        raise SystemExit(f"layer_norm kernel launched {launches} times in "
                         f"{ticks} compute ticks (want {per_tick} each)")

    longest = sorted(completions, key=lambda c: -len(c.tokens))[:4]
    worst, n_tok = 0.0, 0
    with torch.no_grad():
        for c in longest:
            prompt, toks = list(c.request.prompt), c.tokens
            ids = torch.tensor([prompt + toks[:-1]], device="cuda")
            logits = model(ids)[0, len(prompt) - 1:]
            served = torch.tensor(toks, device="cuda")
            gap = logits.max(-1).values - logits.gather(
                1, served[:, None])[:, 0]
            worst = max(worst, float(gap.max()))
            n_tok += len(toks)
    print(f"main: teacher-forced check, {len(longest)} requests, {n_tok} "
          f"served tokens: largest gap to the top logit {worst:.3g} "
          f"(limit {TIE_TOL:g})")
    if not math.isfinite(worst) or worst > TIE_TOL:
        raise SystemExit("served greedy tokens disagree with the full "
                         "forward")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this check runs on "
              "an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from apex_example_tpu_torch.models.gpt import gpt_base
    from apex_example_tpu_torch.ops import _build
    from apex_example_tpu_torch.ops import layer_norm as ln
    from apex_example_tpu_torch.serve import cli

    phase_env()
    phase_build(_build)
    row = phase_kernels(ln)
    row["launches"] = phase_main(cli, ln, gpt_base)
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
