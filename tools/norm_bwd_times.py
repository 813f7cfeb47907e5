#!/usr/bin/env python3
"""Device times of the port's LayerNorm and RMSNorm kernels, forward and
backward, and of its BatchNorm sums, beside their PyTorch calls, fp32.

    python3 tools/norm_bwd_times.py [--root DIR] [--label NAME]
                                    [--bn-loads NAME[,NAME...]]

``--root`` names the checkout whose ``apex_example_tpu_torch`` is timed
(default: this one), so that two checkouts alternate in one process list
on one card: parent, change, change, parent.  Each kernel is built from
that checkout's sources into its own ``build/kernels/``.  Per norm shape
one forward line (layer_norm_cuda and F.layer_norm, rms_norm_cuda and
F.rms_norm) and one backward line (layer_norm_bwd_cuda and torch's
native_layer_norm_backward, rms_norm_bwd_cuda and F.rms_norm's autograd
backward), the LayerNorm forward at 6144 x 410 in bf16 too, and the
LayerNorm backward at 16384 x 768 (gpt2048 at O2) in bf16; then at
chip_smoke.py's BN_SHAPES bn_stats and torch.batch_norm_stats,
bn_bwd_sums and torch.batch_norm_backward_reduce, with the TB/s of the
bytes each kernel must move.  Each time is the median device time of 200
launches (the BatchNorm sums: 100) queued behind a spin kernel (CUDA
events).  Then one JSON line with the same numbers.

``--bn-loads`` builds each named variant of the timed checkout's
csrc/batch_norm.cu (BN_LOADS below: the source with a text replaced),
every nvcc at once, checks the checkout's library (``hint``: its loads
allocate no L1 line) and each variant against the plain version at every
BN_SHAPES shape (the tolerance of chip_smoke.py, bitwise repeats), then
times the two BatchNorm kernels on each library in turn, three rounds
(forward order, reverse, forward), and prints each one's median.

- ``plain``: x and dy are read with plain loads.

Exits 2 where torch sees no CUDA device.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (BN_SHAPES, _bn_inputs, _bn_library,  # noqa: E402
                        _bn_magnitudes, _bn_sums_close, _device_ms)

SHAPES = [(128, 768), (37, 777), (256, 1024), (64, 8192), (4096, 768),
          (8192, 768), (6144, 410), (16384, 768)]
BN_LOADS = {  # name: [(text of batch_norm.cu, its replacement), ...]
    "plain": [("load_once<V * static_cast<int>(sizeof(T))>(p)",
               "*reinterpret_cast<const typename Bytes<V * static_cast<int>("
               "sizeof(T))>::type*>(p)")],
}


def start_variant(build, name):
    """Write load variant ``name`` of the timed checkout's batch_norm.cu
    beside its build and start its nvcc, with the same flags."""
    src = (build.CSRC / "batch_norm.cu").read_text()
    for old, new in BN_LOADS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: a text is not in "
                             f"batch_norm.cu once")
        src = src.replace(old, new)
    path = build.BUILD_DIR / "variants" / f"batch_norm_{name}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    out = path.with_suffix(".so")
    return out, subprocess.Popen(
        [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
         str(out), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def bind_variant(default, name, out, proc):
    """The variant's library once its nvcc ends, bound like the default
    one; prints ptxas's register lines."""
    report, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(f"batch_norm variant {name} did not build:\n"
                         f"{report}")
    for line in report.splitlines():
        if "Used" in line:
            print(f"norm_bwd_times: {name}: {line.strip()}")
    lib = ctypes.CDLL(str(out))
    for entry in ("apex_bn_stats", "apex_bn_bwd_sums", "apex_bn_resident",
                  "apex_cuda_error_string"):
        fn, ref = getattr(lib, entry), getattr(default, entry)
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
    return lib


def norm_times(ln, label, dev, gen):
    """The forward and backward lines at every SHAPES shape (fp32), the
    LayerNorm forward at 6144 x 410 and its backward at 16384 x 768 in
    bf16."""
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
            "ln_fwd": _device_ms(lambda: ln.layer_norm_cuda(x, g, b)),
            "ln_fwd_library": _device_ms(
                lambda: torch.nn.functional.layer_norm(x, (h,), g, b, 1e-5)),
            "rms_fwd": _device_ms(lambda: ln.rms_norm_cuda(x, g)),
            "rms_fwd_library": _device_ms(
                lambda: torch.nn.functional.rms_norm(x, (h,), g, 1e-5)),
            "ln": _device_ms(lambda: ln.layer_norm_bwd_cuda(
                x, g, mean, rstd, dy)),
            "ln_library": _device_ms(
                lambda: torch.ops.aten.native_layer_norm_backward(
                    dy, x, [h], mean[:, None], rstd[:, None], g, b,
                    [True, True, True])),
            "rms": _device_ms(lambda: ln.rms_norm_bwd_cuda(x, g, rrstd, dy)),
            "rms_library": _device_ms(lambda: torch.autograd.grad(
                yr, (xr, gr), dy, retain_graph=True)),
        }
        if (n, h) == (6144, 410):
            xb = x.to(torch.bfloat16)
            ms["ln_fwd_bf16"] = _device_ms(lambda: ln.layer_norm_cuda(
                xb, g, b))
            ms["ln_fwd_bf16_library"] = _device_ms(
                lambda: torch.nn.functional.layer_norm(
                    xb, (h,), g.to(torch.bfloat16), b.to(torch.bfloat16),
                    1e-5))
        if (n, h) == (16384, 768):    # gpt2048 at O2
            xb, dyb = x.to(torch.bfloat16), dy.to(torch.bfloat16)
            gb, bb = g.to(torch.bfloat16), b.to(torch.bfloat16)
            _, bmean, brstd = torch.ops.aten.native_layer_norm(xb, [h], gb,
                                                               bb, 1e-5)
            ms["ln_bf16"] = _device_ms(lambda: ln.layer_norm_bwd_cuda(
                xb, g, mean, rstd, dyb))
            ms["ln_bf16_library"] = _device_ms(
                lambda: torch.ops.aten.native_layer_norm_backward(
                    dyb, xb, [h], bmean, brstd, gb, bb, [True, True, True]))
        rows[f"{n}x{h}"] = ms
        print(f"norm_bwd_times: {label} {n}x{h} float32 forward: "
              f"layer_norm_fwd {ms['ln_fwd']:.5f} ms  F.layer_norm "
              f"{ms['ln_fwd_library']:.5f} ms  rms_norm_fwd "
              f"{ms['rms_fwd']:.5f} ms  F.rms_norm "
              f"{ms['rms_fwd_library']:.5f} ms")
        print(f"norm_bwd_times: {label} {n}x{h} float32: layer_norm_bwd "
              f"{ms['ln']:.5f} ms  native_layer_norm_backward "
              f"{ms['ln_library']:.5f} ms  rms_norm_bwd {ms['rms']:.5f} ms  "
              f"F.rms_norm backward {ms['rms_library']:.5f} ms")
        if "ln_fwd_bf16" in ms:
            print(f"norm_bwd_times: {label} {n}x{h} bfloat16 forward: "
                  f"layer_norm_fwd {ms['ln_fwd_bf16']:.5f} ms  F.layer_norm "
                  f"(bf16 gamma, beta) {ms['ln_fwd_bf16_library']:.5f} ms")
        if "ln_bf16" in ms:
            print(f"norm_bwd_times: {label} {n}x{h} bfloat16: layer_norm_bwd "
                  f"{ms['ln_bf16']:.5f} ms  native_layer_norm_backward "
                  f"(bf16 gamma, beta) {ms['ln_bf16_library']:.5f} ms")
        del x, dy, xr, yr
    return rows


def bn_kernels(bn, x, dy, c, mean, inv):
    """The two BatchNorm kernels on these inputs and their bytes."""
    rows, C = x.shape
    return (("bn_stats", lambda: bn.bn_stats_cuda(x, c),
             4 * rows * C + 12 * C),
            ("bn_bwd_sums", lambda: bn.bn_bwd_sums_cuda(x, dy, mean, inv),
             8 * rows * C + 16 * C))


def bn_times(bn, label, gen):
    """bn_stats and bn_bwd_sums beside the library calls at BN_SHAPES."""
    rows_out = {}
    for rows, C in BN_SHAPES:
        x, dy, c, mean, inv = _bn_inputs(rows, C, torch.float32, gen)
        got = bn.bn_stats_cuda(x, c) + bn.bn_bwd_sums_cuda(x, dy, mean, inv)
        lib = _bn_library(x, dy, c, mean, inv, got)
        for k, (name, kernel, nbytes) in enumerate(
                bn_kernels(bn, x, dy, c, mean, inv)):
            ms = _device_ms(kernel, reps=100, warmup=5)
            lib_ms = (_device_ms(lib[k], reps=100, warmup=5)
                      if lib is not None else None)
            rows_out[f"{name} {rows}x{C}"] = {"ms": ms, "library_ms": lib_ms,
                                              "tb_s": nbytes / ms / 1e9}
            print(f"norm_bwd_times: {label} {name} {rows}x{C} float32: "
                  f"kernel {ms:.5f} ms ({nbytes / ms / 1e9:.3f} TB/s)  "
                  f"library {'-' if lib_ms is None else f'{lib_ms:.5f}'} ms")
        del x, dy
        torch.cuda.empty_cache()
    return rows_out


def bn_variants(bn, build, names, gen):
    """The checkout's library (``hint``) and each load variant checked at
    every BN_SHAPES shape, then timed in turns; returns name -> "kernel
    shape" -> median ms."""
    started = {name: start_variant(build, name) for name in names}
    default = bn._library()
    libs = {"hint": default}
    libs.update((name, bind_variant(default, name, *started[name]))
                for name in names)
    times = {name: {} for name in libs}
    for rows, C in BN_SHAPES:
        x, dy, c, mean, inv = _bn_inputs(rows, C, torch.float32, gen)
        want = bn.bn_stats_plain(x, c) + bn.bn_bwd_sums_plain(x, dy, mean,
                                                               inv)
        mags = _bn_magnitudes(x, dy, c, mean, inv)
        for name, lib in libs.items():
            bn._library = lambda lib=lib: lib
            got = bn.bn_stats_cuda(x, c) + bn.bn_bwd_sums_cuda(x, dy, mean,
                                                                inv)
            again = bn.bn_stats_cuda(x, c) + bn.bn_bwd_sums_cuda(x, dy,
                                                                  mean, inv)
            ok = (all(o for _, o in (_bn_sums_close(a, w, m) for a, w, m in
                                     zip(got, want, mags)))
                  and all(torch.equal(a, r) for a, r in zip(got, again)))
            print(f"norm_bwd_times: variant {name} {rows}x{C}: "
                  f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise SystemExit(f"batch_norm variant {name} disagrees with "
                                 f"the plain version at {rows}x{C}")
        order = list(libs)
        for rnd in range(3):
            for name in (order if rnd % 2 == 0 else order[::-1]):
                bn._library = lambda lib=libs[name]: lib
                for kname, kernel, _ in bn_kernels(bn, x, dy, c, mean, inv):
                    times[name].setdefault(f"{kname} {rows}x{C}", []).append(
                        _device_ms(kernel, reps=100, warmup=5))
        for kname, _, nbytes in bn_kernels(bn, x, dy, c, mean, inv):
            key = f"{kname} {rows}x{C}"
            med = {name: statistics.median(times[name][key])
                   for name in libs}
            print(f"norm_bwd_times: variants {key} float32, median of 3: "
                  + "  ".join(f"{name} {ms:.5f} ms ({nbytes / ms / 1e9:.3f} "
                              f"TB/s)" for name, ms in med.items()))
        del x, dy
        torch.cuda.empty_cache()
    bn._library = lambda: default
    return {name: {k: statistics.median(v) for k, v in t.items()}
            for name, t in times.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--label", default="checkout")
    ap.add_argument("--bn-loads", default="",
                    help="comma-separated load variants of batch_norm.cu, "
                    "timed beside its own loads: " + ", ".join(BN_LOADS))
    args = ap.parse_args(argv)
    variants = [v for v in args.bn_loads.split(",") if v]
    unknown = set(variants) - set(BN_LOADS)
    if unknown:
        ap.error(f"unknown --bn-loads {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("norm_bwd_times: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from apex_example_tpu_torch.ops import _build
    from apex_example_tpu_torch.ops import batch_norm as bn
    from apex_example_tpu_torch.ops import layer_norm as ln
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"norm_bwd_times: {args.label} ({ln.__file__}) on {smi}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    result = {"label": args.label, "device": smi,
              "ms": norm_times(ln, args.label, dev, gen),
              "bn": bn_times(bn, args.label, gen)}
    if variants:
        result["bn_loads"] = bn_variants(bn, _build, variants, gen)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
