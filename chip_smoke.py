#!/usr/bin/env python3
"""Drive the PyTorch port (apex_example_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout, on a GPU

Phases, one or more lines each:

1. env     — the card's name and power limit (nvidia-smi, on a line of its
             own), torch and CUDA versions.
2. build   — compiles every kernel source of the port with nvcc (one
             process per source, all at once) and prints ptxas's
             register/spill report.
3. kernels — each kernel against its plain PyTorch version on the card.
             LayerNorm forward at the serving shape (slots * block_size
             rows x 768) and the training shape (4096 x 768), each in fp32
             and bf16, at a ragged row count, at H = 64, at an odd H and at
             H = 8192: fp32 atol = rtol = 1e-5; bf16 one bf16 ulp of the
             output plus 1e-5 (the fp32 rounding of a result that cancels
             to near zero).  LayerNorm backward at the
             training shape (4096 x 768) in fp32 and bf16, at 1000 rows, at
             H = 64, at an odd H and at H = 8192: dx as the forward's y;
             dgamma and dbeta rtol = atol = 1e-4 (sums over thousands of
             O(1) rows in another order; atol for sums that cancel near
             zero).  The multi-tensor L2 norm and LAMB stages 1 and 2 over
             201 tensors shaped like bert_base's parameters: norms rtol
             1e-5; m, v, u and p atol 1e-6, rtol 1e-5.  dgamma and the norms
             must repeat bitwise on a second call.  Then each kernel's, its
             plain version's and (where one exists) a PyTorch call's
             median device time, beside the kernel's bound.
4. main    — gpt_base at full width (random weights from seed 0) served
             through the port's run_serve on cuda: 32 requests with a
             shared prefix through 8 slots of a block-paged cache.  Every
             request must finish ok, the LayerNorm forward kernel must have
             been launched 26 times per compute tick (embeddings_ln, two per
             layer, final_ln) and the backward never, and a teacher-forced
             full forward must agree with each served greedy token of four
             requests: the token is the argmax there, or within 1e-4 of the
             top logit (fp32 sums in another order may flip a near-tie).
5. train   — bert_base at full width (random weights from seed 0) trained
             through the port's train.main on cuda: batch 32 x 128, 20
             steps of FusedLAMB (lr 1e-3, poly schedule, 5 warmup steps,
             weight decay 0.01).  Every loss must be finite, the mean loss
             of steps 16-20 below that of steps 1-5, and each step must
             launch the LayerNorm forward and backward 26 times each and
             the L2 norm and both LAMB stages once each.  Then one step of
             the same weights on one 2 x 128 batch on the card and on the
             CPU (the plain versions): loss rtol 1e-5, grad norm rtol 1e-4,
             every updated parameter atol 1e-5; the card's step must have
             launched the kernels (26, 26, 1, 1, 1) and the CPU's none.
6. profile — torch.profiler over three more bert_base steps: device time
             by kernel group and the device's idle share (informational).

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
SOURCES = ["layer_norm", "multi_tensor", "fused_optim"]
SUM_TOL = 1e-4            # dgamma, dbeta: rtol and atol
NORM_TOL = 1e-5           # L2 norms, ||p||^2, ||u||^2, ratios: rtol
STATE_ATOL, STATE_RTOL = 1e-6, 1e-5     # m, v, u, p after a LAMB stage
TRAIN_ROWS = 32 * 128     # LayerNorm rows of the train phase's steps
TRAIN_ARGS = ["--device", "cuda", "--arch", "bert_base",
              "--batch-size", "32", "--seq-len", "128", "--epochs", "1",
              "--steps-per-epoch", "20", "--opt", "lamb", "--lr", "1e-3",
              "--warmup-steps", "5", "--lr-schedule", "poly",
              "--weight-decay", "0.01", "--seed", "0", "--print-freq", "5"]
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


def _close(got, want, rtol, atol):
    """max |got - want| and whether every element is within
    atol + rtol * |want|."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    return float(err.max()), bool((err <= atol + rtol * want.abs()).all())


def _bound(nbytes, ops):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


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
    reports = build.build(SOURCES)
    dt = time.perf_counter() - t0
    print(f"build: {', '.join(n + '.cu' for n in SOURCES)} in {dt:.1f} s"
          + ("" if reports else " (already built)"))
    for name, text in reports.items():
        print(f"build: {name}.cu -> {build.library_path(name).name}")
        for line in text.splitlines():
            if "Used" in line or "spill" in line or "Function" in line:
                print(f"build:   {line.strip()}")


def phase_kernels(ln):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    path_rows = SLOTS * BLOCK
    cases = [(path_rows, 768, torch.float32), (path_rows, 768, torch.bfloat16),
             (TRAIN_ROWS, 768, torch.float32),
             (TRAIN_ROWS, 768, torch.bfloat16),
             (1000, 768, torch.float32), (1000, 768, torch.bfloat16),
             (path_rows, 64, torch.float32), (path_rows, 64, torch.bfloat16),
             (37, 777, torch.float32), (64, 8192, torch.float32)]
    path_err = 0.0
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
        if h == 768 and dtype == torch.float32 and n in (path_rows,
                                                         TRAIN_ROWS):
            path_err = max(path_err, max_err)

    for n in (TRAIN_ROWS, path_rows):     # the serving shape's row last
        h = 768
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
        bound_ms, bound_by = _bound(nbytes, 8 * n * h)
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
            "bound_by": bound_by, "library_ms": ms["library"]}


def phase_ln_bwd(ln):
    """LayerNorm backward against its plain version, bitwise repeat, and
    its time at the training shape."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [(TRAIN_ROWS, 768, torch.float32),
             (TRAIN_ROWS, 768, torch.bfloat16),
             (1000, 768, torch.float32), (1000, 768, torch.bfloat16),
             (TRAIN_ROWS, 64, torch.float32), (37, 777, torch.float32),
             (64, 8192, torch.float32), (64, 8192, torch.bfloat16)]
    path_err = None
    for n, h, dtype in cases:
        x = (torch.randn(n, h, device=dev, generator=gen) * 2 + 0.5).to(dtype)
        g = torch.randn(h, device=dev, generator=gen) * 0.2 + 1
        b = torch.randn(h, device=dev, generator=gen) * 0.2
        dy = torch.randn(n, h, device=dev, generator=gen).to(dtype)
        _, mean, rstd = ln.layer_norm_plain(x, g, b)
        dx, dg, db = ln.layer_norm_bwd_cuda(x, g, mean, rstd, dy)
        dx_p, dg_p, db_p = ln.layer_norm_bwd_plain(x, g, mean, rstd, dy)
        torch.cuda.synchronize()
        a, r = dx.float(), dx_p.float()
        dx_err = float((a - r).abs().max())
        if dtype == torch.float32:
            dx_ok = bool(((a - r).abs() <= FP32_TOL + FP32_TOL * r.abs())
                         .all())
        else:
            dx_ok = bool(((a - r).abs() <= _bf16_tol(a, r)).all())
        dg_err, dg_ok = _close(dg, dg_p, SUM_TOL, SUM_TOL)
        db_err, db_ok = _close(db, db_p, SUM_TOL, SUM_TOL)
        ok = dx_ok and dg_ok and db_ok and dx.dtype == dtype
        print(f"kernels: layer_norm_bwd {n}x{h} {str(dtype)[6:]}: max|ddx| "
              f"{dx_err:.3g}  max|ddgamma| {dg_err:.3g}  max|ddbeta| "
              f"{db_err:.3g}  {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit(f"layer_norm backward kernel disagrees with its "
                             f"plain version at {n}x{h} {dtype}")
        if (n, h, dtype) == (TRAIN_ROWS, 768, torch.float32):
            path_err = max(dx_err, dg_err, db_err)
            again = ln.layer_norm_bwd_cuda(x, g, mean, rstd, dy)
            same = all(torch.equal(u, w) for u, w in
                       zip(again, (dx, dg, db)))
            print(f"kernels: layer_norm_bwd {n}x{h} float32 second call "
                  f"bitwise equal: {same}")
            if not same:
                raise SystemExit("layer_norm backward kernel does not "
                                 "repeat bitwise")

    n, h = TRAIN_ROWS, 768
    x = torch.randn(n, h, device=dev, generator=gen)
    g = torch.randn(h, device=dev, generator=gen) * 0.2 + 1
    b = torch.randn(h, device=dev, generator=gen) * 0.2
    dy = torch.randn(n, h, device=dev, generator=gen)
    _, mean, rstd = ln.layer_norm_plain(x, g, b)
    kernel = lambda: ln.layer_norm_bwd_cuda(x, g, mean, rstd, dy)  # noqa
    plain = lambda: ln.layer_norm_bwd_plain(x, g, mean, rstd, dy)  # noqa
    library = lambda: torch.ops.aten.native_layer_norm_backward(    # noqa
        dy, x, [h], mean[:, None], rstd[:, None], g, b,
        [True, True, True])
    ms = {name: _device_ms(fn) for name, fn in
          (("kernel", kernel), ("plain", plain), ("library", library))}
    call_ms = _call_ms(kernel)
    nbytes = n * h * 4 * 3 + 3 * h * 4 + 8 * n
    bound_ms, bound_by = _bound(nbytes, 15 * n * h)
    print(f"kernels: layer_norm_bwd {n}x{h} float32 device time: kernel "
          f"{ms['kernel']:.5f} ms  plain {ms['plain']:.5f} ms  "
          f"native_layer_norm_backward {ms['library']:.5f} ms  bound "
          f"{bound_ms:.6f} ms ({nbytes} bytes over 3.35 TB/s)  per call "
          f"from Python {call_ms:.5f} ms")
    return {"name": "layer_norm_bwd", "route": "cuda",
            "source": "apex_example_tpu_torch/csrc/layer_norm.cu",
            "replaces": "apex_example_tpu/ops/layer_norm.py:82",
            "max_abs_err": path_err, "ms": ms["kernel"],
            "plain_ms": ms["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": ms["library"]}


def _bert_base_shapes():
    """bert_base's parameter shapes, in named_parameters order: 201
    tensors, 109,512,762 elements."""
    V, H, F, L, P = 30522, 768, 3072, 12, 512
    shapes = [(V, H), (P, H), (H,), (H,)]
    for _ in range(L):
        shapes += [(H, H), (H,)] * 4 + [(H,), (H,), (F, H), (F,), (H, F),
                                        (H,), (H,), (H,)]
    shapes += [(H, H), (H,), (H,), (H,), (V,)]
    return shapes


def phase_optim_kernels(mt, fo):
    """The L2 norm and LAMB stages over bert_base-shaped tensors against
    their plain versions, bitwise repeat of the norms, and their times."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    shapes = _bert_base_shapes()
    rnd = lambda s, std: torch.randn(s, device=dev,             # noqa
                                     generator=gen) * std
    p = [rnd(s, 0.05) for s in shapes]
    g = [rnd(s, 1e-3) for s in shapes]
    m = [rnd(s, 1e-3) for s in shapes]
    v = [torch.rand(s, device=dev, generator=gen) * 1e-6 for s in shapes]
    numel = sum(t.numel() for t in p)
    print(f"kernels: optimizer lists: {len(p)} tensors, {numel} elements")
    table = mt.TensorTable([p, g, m, v])
    u = torch.empty(table.total, dtype=torch.float32, device=dev)

    # K2: the global grad norm (list 1 = g)
    norm, sq = mt.multi_tensor_l2norm_cuda(table, 1)
    norm_p, sq_p = mt.multi_tensor_l2norm_plain(g)
    norm2, sq2 = mt.multi_tensor_l2norm_cuda(table, 1)
    torch.cuda.synchronize()
    n_err, n_ok = _close(norm, norm_p, NORM_TOL, 0.0)
    s_err, s_ok = _close(sq, sq_p, NORM_TOL, 0.0)
    same = torch.equal(norm, norm2) and torch.equal(sq, sq2)
    print(f"kernels: multi_tensor_l2norm: norm {float(norm):.6f} (plain "
          f"{float(norm_p):.6f}) max|dnorm| {n_err:.3g} max|dsq| {s_err:.3g}"
          f"  second call bitwise equal: {same}  "
          f"{'ok' if n_ok and s_ok and same else 'MISMATCH'}")
    if not (n_ok and s_ok and same):
        raise SystemExit("multi_tensor_l2norm kernel disagrees with its "
                         "plain version or does not repeat")
    l2_err = max(n_err, s_err)

    # K3 on copies of m, v; the plain version with the kernel's clip scale
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01,
                 bias_c1=1.0 / (1 - 0.9 ** 3), bias_c2=1.0 / (1 - 0.999 ** 3))
    m0 = [t.clone() for t in m]
    v0 = [t.clone() for t in v]
    sums, ratio = fo.lamb_stage1_cuda(table, u, norm, max_grad_norm=1.0,
                                      **hyper)
    gscale = torch.where(norm > 1.0, 1.0 / (norm + 1e-6),
                         torch.ones_like(norm))
    errs, rel, ok = [], [], True
    u_views = torch.split(u, [t.numel() for t in p])
    p_sq, u_sq = [], []
    for i in range(len(p)):
        u_p, m_p, v_p, ps, us = fo.lamb_stage1_plain(
            p[i], g[i], m0[i], v0[i], grad_scale=gscale, **hyper)
        p_sq.append(ps)
        u_sq.append(us)
        for got, want in ((m[i], m_p), (v[i], v_p),
                          (u_views[i].view_as(p[i]), u_p)):
            e, o = _close(got, want, STATE_RTOL, STATE_ATOL)
            errs.append(e)
            ok = ok and o
    p_sq, u_sq = torch.stack(p_sq), torch.stack(u_sq)
    ratio_p = fo.trust_ratio_plain(p_sq, u_sq)
    for got, want in ((sums[0], p_sq), (sums[1], u_sq), (ratio, ratio_p)):
        e, o = _close(got, want, NORM_TOL, 0.0)
        rel.append(float(((got - want).abs() / want.abs()).max()))
        ok = ok and o
    torch.cuda.synchronize()
    lamb1_err = max(errs)
    print(f"kernels: lamb_stage1 (clip scale {float(gscale):.6f}): max "
          f"|d| over m, v, u {lamb1_err:.3g}  largest relative error of "
          f"||p||^2, ||u||^2, ratio {max(rel):.3g}  "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise SystemExit("lamb_stage1 kernel disagrees with its plain "
                         "version")

    # K4 on a copy of p
    lr = 1e-3
    p0 = [t.clone() for t in p]
    fo.lamb_stage2_cuda(table, u, ratio, lr)
    errs, ok = [], True
    for i in range(len(p)):
        want = fo.lamb_stage2_plain(p0[i], u_views[i].view_as(p0[i]),
                                    lr * ratio[i])
        e, o = _close(p[i], want, STATE_RTOL, STATE_ATOL)
        errs.append(e)
        ok = ok and o
    torch.cuda.synchronize()
    lamb2_err = max(errs)
    print(f"kernels: lamb_stage2: max|dp| {lamb2_err:.3g}  "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise SystemExit("lamb_stage2 kernel disagrees with its plain "
                         "version")

    # the library yardstick of K4: one foreach call with the ratios as 0-d
    # device tensors, held against the kernel's result, timed on copies
    ratios = list(ratio.unbind())
    u_list = [u_views[i].view_as(p[i]) for i in range(len(p))]
    p_lib = [t.clone() for t in p0]
    torch._foreach_addcmul_(p_lib, u_list, ratios, value=-lr)
    closes = [_close(a, b, STATE_RTOL, STATE_ATOL) for a, b in zip(p_lib, p)]
    lib_err = max(e for e, _ in closes)
    lib_ok = all(o for _, o in closes)
    print(f"kernels: lamb_stage2 library call torch._foreach_addcmul_ "
          f"against the kernel: max|dp| {lib_err:.3g}  "
          f"{'ok' if lib_ok else 'MISMATCH'}")
    if not lib_ok:
        raise SystemExit("torch._foreach_addcmul_ does not compute "
                         "lamb_stage2's function")

    def plain_stage1():
        for i in range(len(p)):
            fo.lamb_stage1_plain(p[i], g[i], m[i], v[i], grad_scale=gscale,
                                 **hyper)

    def plain_stage2():
        for i in range(len(p)):
            fo.lamb_stage2_plain(p[i], u_views[i].view_as(p[i]),
                                 lr * ratio[i])

    rows = []
    # library calls' reps: a per-tensor foreach call issues 201 launches,
    # so fewer of them fit behind _device_ms's spin kernel
    spec = [
        ("multi_tensor_l2norm", "multi_tensor.cu",
         "apex_example_tpu/ops/multi_tensor.py:203", l2_err,
         lambda: mt.multi_tensor_l2norm_cuda(table, 1),
         lambda: mt.multi_tensor_l2norm_plain(g),
         lambda: torch._foreach_norm(g, 2), "torch._foreach_norm", 100,
         4 * numel, 2 * numel),
        ("lamb_stage1", "fused_optim.cu",
         "apex_example_tpu/ops/fused_optim.py:137", lamb1_err,
         lambda: fo.lamb_stage1_cuda(table, u, norm, max_grad_norm=1.0,
                                     **hyper),
         plain_stage1, None, None, 0, 28 * numel, 20 * numel),
        ("lamb_stage2", "fused_optim.cu",
         "apex_example_tpu/ops/fused_optim.py:219", lamb2_err,
         lambda: fo.lamb_stage2_cuda(table, u, ratio, lr),
         plain_stage2,
         lambda: torch._foreach_addcmul_(p_lib, u_list, ratios, value=-lr),
         "torch._foreach_addcmul_", 40, 12 * numel, 2 * numel),
    ]
    for (name, src, replaces, err, kernel, plain, library, lib_name,
         lib_reps, nbytes, ops) in spec:
        k_ms = _device_ms(kernel, reps=100, warmup=5)
        p_ms = _device_ms(plain, reps=20, warmup=2)
        call_ms = _call_ms(kernel, reps=100, warmup=5)
        bound_ms, bound_by = _bound(nbytes, ops)
        l_ms, lib_txt = None, "no single PyTorch call computes it"
        if library:
            l_ms = _device_ms(library, reps=lib_reps, warmup=5)
            lib_txt = (f"{lib_name} {l_ms:.5f} ms (per call from Python "
                       f"{_call_ms(library, reps=lib_reps, warmup=5):.5f} "
                       f"ms)")
        print(f"kernels: {name} over {len(p)} tensors device time: kernel "
              f"{k_ms:.5f} ms  plain {p_ms:.5f} ms  {lib_txt}  bound "
              f"{bound_ms:.6f} ms ({nbytes} bytes over 3.35 TB/s)  per call "
              f"from Python {call_ms:.5f} ms")
        rows.append({"name": name, "route": "cuda",
                     "source": f"apex_example_tpu_torch/csrc/{src}",
                     "replaces": replaces, "max_abs_err": err, "ms": k_ms,
                     "plain_ms": p_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": l_ms})
    return rows


def _zero_counts(counted):
    for fn in counted.values():
        fn.launches = 0


def _counts(counted):
    return {name: fn.launches for name, fn in counted.items()}


def phase_main(cli, gpt_base, counted):
    args = cli.build_parser().parse_args(SERVE_ARGS)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(counted)
    t0 = time.perf_counter()
    completions, summary, rc = cli.run_serve(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts(counted)
    launches = counts["layer_norm_fwd"]
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
    others = {k: v for k, v in counts.items() if k != "layer_norm_fwd"}
    print(f"main: other kernels' launches while serving: {others} (want 0)")
    if any(others.values()):
        raise SystemExit("serving launched a training kernel")

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
    return counts


def phase_train(train, counted):
    """bert_base MLM through the port's trainer: finite, falling loss and
    the kernels' launch counts per step."""
    path = os.path.join(ROOT, "build", "chip_smoke_train.jsonl")
    args = train.build_parser().parse_args(
        TRAIN_ARGS + ["--metrics-jsonl", path])
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(counted)
    t0 = time.perf_counter()
    rc = train.run_train(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts(counted)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    with open(path) as fh:
        records = [json.loads(line) for line in fh]
    steps = [r for r in records if r["record"] == "step"]
    n = len(steps)
    losses = [r["loss"] for r in steps]
    times = [r["step_time_ms"] for r in steps]
    steady = statistics.median(times[1:]) if n > 1 else float("nan")
    tokens = args.batch_size * args.seq_len
    print(f"train: bert_base {n} steps  loss first/last {losses[0]:.4f}/"
          f"{losses[-1]:.4f}  mean steps 1-5 "
          f"{statistics.fmean(losses[:5]):.4f}  mean steps 16-20 "
          f"{statistics.fmean(losses[-5:]):.4f}")
    print(f"train: step time median {steady:.2f} ms (steps 2-{n})  first "
          f"step {times[0]:.2f} ms  tokens/s {tokens / steady * 1e3:.1f}  "
          f"wall {wall:.1f} s  max memory {peak_gib:.2f} GiB")
    per_layer_norms = 2 * 12 + 2
    want = {"layer_norm_fwd": per_layer_norms * n,
            "layer_norm_bwd": per_layer_norms * n,
            "multi_tensor_l2norm": n, "lamb_stage1": n, "lamb_stage2": n}
    print(f"train: launches {counts} (want {want})")
    if rc != 0 or n != 20:
        raise SystemExit(f"training run: rc {rc}, {n} step records (want "
                         f"20)")
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"training loss is not finite: {losses}")
    if not statistics.fmean(losses[-5:]) < statistics.fmean(losses[:5]):
        raise SystemExit("training loss did not fall over 20 steps")
    if counts != want:
        raise SystemExit(f"kernel launches per step off: {counts}")
    return counts


KERNEL_GROUPS = (            # device-time categories, first match wins
    ("ported: layer_norm fwd", ("ln_fwd_kernel",)),
    ("ported: layer_norm bwd", ("ln_bwd_kernel", "ln_bwd_colsum")),
    ("ported: multi_tensor_l2norm", ("sqsum_chunks", "global_norm",
                                     "tensor_sums")),
    ("ported: lamb stages", ("lamb1_chunks", "trust_ratio",
                             "lamb2_chunks")),
    ("matrix products", ("gemm", "cutlass", "xmma", "cublas")),
    ("softmax", ("softmax",)),
    ("embedding", ("embedding",)),
    ("reductions", ("reduce_kernel",)),
    ("memset, memcpy", ("memset", "memcpy")),
)


def _group(name):
    low = name.lower()
    for label, keys in KERNEL_GROUPS:
        if any(k in low for k in keys):
            return label
    return "other elementwise"


def phase_profile(train, steps=3):
    """torch.profiler over a few bert_base train steps: device time by
    kernel group, and the share of the window the device sat idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from apex_example_tpu_torch.engine import (create_train_state,
                                               make_train_step)
    from apex_example_tpu_torch.workloads import mlm_loss
    args = train.build_parser().parse_args(TRAIN_ARGS)
    model = train.build_model(args, "cuda")
    state = create_train_state(model, train.build_optimizer(
        args, model.parameters()))
    step_fn = make_train_step(mlm_loss)
    batches = [train.batch_fn(args, model.vocab_size, i, "cuda")
               for i in range(steps + 2)]
    for b in batches[:2]:
        state, _ = step_fn(state, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[2:]:
            state, metrics = step_fn(state, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        print("profile: the profiler recorded no device events")
        return
    busy, end = 0.0, spans[0][0]
    by_group, by_name = {}, {}
    for a, b, name in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_group[_group(name)] = by_group.get(_group(name), 0.0) + (b - a)
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    window = spans[-1][1] - spans[0][0]
    total = sum(by_group.values())
    print(f"profile: {steps} bert_base steps: host wall {wall_ms:.2f} ms "
          f"({wall_ms / steps:.2f} ms a step)  device window "
          f"{window / 1e3:.2f} ms  device busy {busy / 1e3:.2f} ms  idle "
          f"share {1 - busy / window:.4f}  {len(spans)} device events "
          f"({len(spans) // steps} a step)")
    for label, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"profile:   {label:30s} {us / 1e3 / steps:9.3f} ms a step  "
              f"{us / total:7.2%}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"profile:   top kernel {us / 1e3 / steps:8.3f} ms a step  "
              f"{name[:90]}")


def one_step(train, args, dev, batch):
    """One train step of freshly built weights on ``dev``: (loss, grad
    norm, parameters after the step on the CPU, largest update)."""
    from apex_example_tpu_torch.engine import (create_train_state,
                                               make_train_step)
    from apex_example_tpu_torch.workloads import mlm_loss
    model = train.build_model(args, dev)
    init = {k: p.detach().to("cpu", copy=True)
            for k, p in model.named_parameters()}
    opt = train.build_optimizer(args, model.parameters())
    state = create_train_state(model, opt)
    ids, labels, w = (torch.from_numpy(a).to(dev) for a in batch)
    state, metrics = make_train_step(mlm_loss)(state, (ids, (labels, w)))
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    params = {k: p.detach().cpu() for k, p in model.named_parameters()}
    update = max(float((params[k] - init[k]).abs().max()) for k in init)
    return loss, gnorm, params, update


def phase_cross_check(train, counted):
    """One step of the same weights on one 2 x 128 batch, on the card
    (the kernels) and on the CPU (the plain versions)."""
    from apex_example_tpu_torch.data.synthetic import mlm_batch
    args = train.build_parser().parse_args(TRAIN_ARGS)
    batch = mlm_batch(0, batch_size=2, seq_len=128, vocab_size=30522,
                      mask_token_id=30521, seed=0)
    got = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        _zero_counts(counted)
        got[dev] = one_step(train, args, dev, batch)
        loss, gnorm, _, update = got[dev]
        counts = _counts(counted)
        print(f"train: cross-check on {dev}: loss {loss!r} grad norm "
              f"{gnorm!r} largest update {update:.3g}  kernel launches "
              f"{counts}  ({time.perf_counter() - t0:.1f} s)")
        want = {"layer_norm_fwd": 26, "layer_norm_bwd": 26,
                "multi_tensor_l2norm": 1, "lamb_stage1": 1, "lamb_stage2": 1}
        if counts != (want if dev == "cuda" else dict.fromkeys(want, 0)):
            raise SystemExit(f"the {dev} step launched {counts}")
        torch.cuda.empty_cache()
    (l_g, n_g, p_g, _), (l_c, n_c, p_c, _) = got["cuda"], got["cpu"]
    p_err = max(float((p_g[k] - p_c[k]).abs().max()) for k in p_c)
    l_ok = abs(l_g - l_c) <= 1e-5 * abs(l_c)
    n_ok = abs(n_g - n_c) <= 1e-4 * abs(n_c)
    p_ok = p_err <= 1e-5
    print(f"train: card vs CPU after one step: |dloss| {abs(l_g - l_c):.3g} "
          f"(rtol 1e-5)  |dgrad norm| {abs(n_g - n_c):.3g} (rtol 1e-4)  "
          f"max|dparam| {p_err:.3g} (atol 1e-5)  "
          f"{'ok' if l_ok and n_ok and p_ok else 'MISMATCH'}")
    if not (l_ok and n_ok and p_ok):
        raise SystemExit("the card's first training step disagrees with "
                         "the CPU's")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this check runs on "
              "an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from apex_example_tpu_torch import train
    from apex_example_tpu_torch.models.gpt import gpt_base
    from apex_example_tpu_torch.ops import _build
    from apex_example_tpu_torch.ops import fused_optim as fo
    from apex_example_tpu_torch.ops import layer_norm as ln
    from apex_example_tpu_torch.ops import multi_tensor as mt
    from apex_example_tpu_torch.serve import cli

    counted = {"layer_norm_fwd": ln.layer_norm_cuda,
               "layer_norm_bwd": ln.layer_norm_bwd_cuda,
               "multi_tensor_l2norm": mt.multi_tensor_l2norm_cuda,
               "lamb_stage1": fo.lamb_stage1_cuda,
               "lamb_stage2": fo.lamb_stage2_cuda}
    phase_env()
    phase_build(_build)
    rows = [phase_kernels(ln), phase_ln_bwd(ln)]
    rows += phase_optim_kernels(mt, fo)
    by_path = {"serve": phase_main(cli, gpt_base, counted),
               "train": phase_train(train, counted)}
    phase_cross_check(train, counted)
    phase_profile(train)
    for row in rows:
        row["launches_by_path"] = {k: v[row["name"]]
                                   for k, v in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
