#!/usr/bin/env python3
"""The attention phase of chip_smoke.py on the checkout's flash kernels and
on variants of apex_example_tpu_torch/csrc/attention.cu, in one process on
one card.

    python3 tools/attn_variants.py [VARIANT ...]   # from a checkout's root
    python3 tools/attn_variants.py --rounds=N [VARIANT ...]

A variant is the source with some texts replaced (VARIANTS below; names
joined by "+" combine their edits), or another attention.cu named by its
path (a parent checkout's, say), built beside the checkout's library with
the same flags, every nvcc started at once; each library in turn
runs chip_smoke.phase_attention (every ATTN_CASES check against the
limit, then the times at gpt_base's shape); a library that fails a check
prints which, then its times alone.  With no argument every variant
runs.  ``--rounds=N`` checks nothing: it times the fp32 forward at
gpt_base's shape on each library in turn, N rounds, and prints the medians.

- ``no_retake``: no pair's S and dP are taken again in the plain chain
  (flip_limit beyond any P or |dS|): the tensor cores' values everywhere.
- ``t_async``: the fp32 backward and forward copy their stationary tiles
  with 4-byte cp.async copies through the strides, as they do for any view
  that is not contiguous, in place of 16-byte loads.
- ``fwd_t_async``: the fp32 forward alone does so for its Q^T.
- ``fwd_fast_exp``: the fp32 forward's softmax takes __expf, not expf.
- ``unroll_s8``, ``unroll_acc16``, ``unroll_acc4``: the fp32 kernels'
  score loop unrolled by 8 steps (not 4), their row products by 16 or 4
  keys (not 8); every fp32 kernel changes.
- ``dq_scores_g0``: the fp32 dQ scales, biases and masks its scores in
  group 0 before the barrier, as dK/dV does, not in the shared pass.
- ``dkdv_scores_shared``: the fp32 dK/dV does it in the shared pass, as
  dQ does.
"""

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = {  # name: [(text, its replacement), ...]
    "no_retake": [(
        "return std::is_same<T, __half>::value ? 0.125f : 1.f / 64;",
        "return 1e30f;")],
    "t_async": [("  if (vec) {  // 16-byte loads, four stores",
                 "  if (false) {  // 16-byte loads, four stores")],
    "fwd_t_async": [(
        """p.vq, b, h,
                       q0, p.Sq, p.D);
  cp_async_commit();

  if (group == 0) {""",
        """0, b, h,
                       q0, p.Sq, p.D);
  cp_async_commit();

  if (group == 0) {""")],
    "fwd_fast_exp": [
        ("const float a = expf(", "const float a = __expf("),
        ("s[i][j] = expf(s[i][j] - m_new);",
         "s[i][j] = __expf(s[i][j] - m_new);")],
    "unroll_s8": [(
        "#pragma unroll 4\n  for (int d0 = 0; d0 < D; d0 += 4) step(d0);",
        "#pragma unroll 8\n  for (int d0 = 0; d0 < D; d0 += 4) step(d0);")],
    "unroll_acc16": [(
        "#pragma unroll 8\n  for (int c = 0; c < T::kCols; ++c) {",
        "#pragma unroll 16\n  for (int c = 0; c < T::kCols; ++c) {")],
    "unroll_acc4": [(
        "#pragma unroll 8\n  for (int c = 0; c < T::kCols; ++c) {",
        "#pragma unroll 4\n  for (int c = 0; c < T::kCols; ++c) {")],
    "dq_scores_g0": [(
        """    f32_scores<DP>(group ? sdOt : sQt, group ? sV : sK, p.D, rg, cg, s);
#pragma unroll
    for (int jj = 0; jj < T::kTC; ++jj)
      f32_put<DP>(group ? sdS : sX, rg, cg + T::kCG * jj, s, jj);""",
        """    f32_scores<DP>(group ? sdOt : sQt, group ? sV : sK, p.D, rg, cg, s);
    if (group == 0) {
      const bool edge0 = k0 + T::kCols > p.Sk || q0 + T::kRows > p.Sq ||
                         (p.causal && k0 + T::kCols - 1 > q0 + p.off);
#pragma unroll
      for (int jj = 0; jj < T::kTC; ++jj)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          s[i][jj] = f32_score(
              p, s[i][jj], sBias[cg + T::kCG * jj], edge0,
              q0 + (i >> 2) * (T::kRows / 2) + 4 * rg + (i & 3),
              k0 + cg + T::kCG * jj);
    }
#pragma unroll
    for (int jj = 0; jj < T::kTC; ++jj)
      f32_put<DP>(group ? sdS : sX, rg, cg + T::kCG * jj, s, jj);"""), (
        """      x.x = f32_score(p, x.x, bias, edge, q0 + row0, k0 + col);
      x.y = f32_score(p, x.y, bias, edge, q0 + row0 + 1, k0 + col);
      x.z = f32_score(p, x.z, bias, edge, q0 + row0 + 2, k0 + col);
      x.w = f32_score(p, x.w, bias, edge, q0 + row0 + 3, k0 + col);
""", "")],
    "dkdv_scores_shared": [(
        """    if (group == 0) {
      const bool edge = q0 + T::kCols > p.Sq || k0 + T::kRows > p.Sk ||
                        (p.causal && q0 + p.off < k0 + T::kRows - 1);
      float bias[8];
      const float4 b0 = ld4(sBias + 4 * rg);
      const float4 b1 = ld4(sBias + T::kRows / 2 + 4 * rg);
      bias[0] = b0.x, bias[1] = b0.y, bias[2] = b0.z, bias[3] = b0.w;
      bias[4] = b1.x, bias[5] = b1.y, bias[6] = b1.z, bias[7] = b1.w;
#pragma unroll
      for (int j = 0; j < T::kTC; ++j) {
        const int col = cg + T::kCG * j;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          s[i][j] = f32_score(p, s[i][j], bias[i], edge, q0 + col,
                              k0 + (i >> 2) * (T::kRows / 2) + 4 * rg +
                                  (i & 3));
      }
    }
""", ""), (
        """      float4 x = ld4(sP + at), dp = ld4(sdS + at);
      const float lse = sLse[col], delta = sDelta[col];""",
        """      float4 x = ld4(sP + at), dp = ld4(sdS + at);
      const bool edge = q0 + T::kCols > p.Sq || k0 + T::kRows > p.Sk ||
                        (p.causal && q0 + p.off < k0 + T::kRows - 1);
      const int key0 = group * (T::kRows / 2) + 4 * rg;
      const float4 kb = ld4(sBias + key0);
      x.x = f32_score(p, x.x, kb.x, edge, q0 + col, k0 + key0);
      x.y = f32_score(p, x.y, kb.y, edge, q0 + col, k0 + key0 + 1);
      x.z = f32_score(p, x.z, kb.z, edge, q0 + col, k0 + key0 + 2);
      x.w = f32_score(p, x.w, kb.w, edge, q0 + col, k0 + key0 + 3);
      const float lse = sLse[col], delta = sDelta[col];""")],
}
ENTRIES = ("apex_attn_fwd", "apex_attn_dq", "apex_attn_dkdv",
           "apex_cuda_error_string")


def start(build_mod, name):
    """Write variant ``name`` (names joined by "+" combine their edits)
    beside the checkout's build and start its nvcc, with the same flags."""
    if name.endswith(".cu"):
        src = Path(name).read_text()
        tag = "_".join(Path(name).resolve().parts[-4:]).replace(".", "_")
    else:
        src = (build_mod.CSRC / "attention.cu").read_text()
        for old, new in [e for part in name.split("+")
                         for e in VARIANTS[part]]:
            if src.count(old) != 1:
                raise SystemExit(f"variant {name}: a text is not in "
                                 f"attention.cu once")
            src = src.replace(old, new)
        tag = name
    path = build_mod.BUILD_DIR / "variants" / f"attention_{tag}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    out = path.with_suffix(".so")
    return out, subprocess.Popen(
        [build_mod.nvcc(), *build_mod.NVCC_FLAGS, "-I", str(build_mod.CSRC),
         "-o", str(out), str(path)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def bind(default, name, out, proc):
    """The variant's library once its nvcc ends, bound like the checkout's,
    and ptxas's report."""
    report, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(f"variant {name} did not build:\n{report}")
    lib = ctypes.CDLL(str(out))
    for entry in ENTRIES:
        fn, ref = getattr(lib, entry), getattr(default, entry)
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
    return lib, report


def fwd_rounds(att, chip_smoke, libs, rounds):
    """The fp32 forward at gpt_base's 8 x 2048 x 12 x 64 causal on each
    library in turn, ``rounds`` times (50 launches each, behind a spin
    kernel); prints every round and each library's median."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, *_ = chip_smoke._attn_inputs(8, 2048, 2048, 12, 64,
                                          torch.float32, gen, False, False)
    times = {name: [] for name in libs}
    for r in range(rounds):
        for name, (lib, _) in libs.items():
            att._library = lambda lib=lib: lib
            times[name].append(chip_smoke._device_ms(
                lambda: att.flash_attention_cuda(q, k, v, None, True),
                reps=50, warmup=5))
        print(f"attn_variants: round {r}: " + "  ".join(
            f"{n} {t[-1]:.4f}" for n, t in times.items()))
    for name, t in times.items():
        print(f"attn_variants: {name} fp32 forward median of {rounds} "
              f"rounds {statistics.median(t):.4f} ms")


def main(names):
    if not torch.cuda.is_available():
        print("attn_variants: torch sees no CUDA device", file=sys.stderr)
        return 2
    rounds = 0
    if names and names[0].startswith("--rounds="):
        rounds = int(names[0].split("=", 1)[1])
        names = names[1:]
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from apex_example_tpu_torch.ops import _build
    from apex_example_tpu_torch.ops import attention as att

    chip_smoke.phase_env()
    names = names or list(VARIANTS)
    started = {name: start(_build, name) for name in names}  # all at once
    report = _build.build(["attention"]).get("attention", "")
    default = att._library()
    libs = {"checkout": (default, report)}
    for name in names:
        libs[name] = bind(default, name, *started[name])
    if rounds:
        fwd_rounds(att, chip_smoke, libs, rounds)
        return 0
    failed = []
    for name, (lib, report) in libs.items():
        print(f"attn_variants: {name}")
        att._library = lambda lib=lib: lib
        chip_smoke.BUILD_REPORTS["attention"] = report   # its registers
        try:
            chip_smoke.phase_attention(att)
        except SystemExit as e:
            print(f"attn_variants: {name} fails: {e}; its times alone:")
            failed.append(name)
            cases, chip_smoke.ATTN_CASES = chip_smoke.ATTN_CASES, ()
            chip_smoke.phase_attention(att)
            chip_smoke.ATTN_CASES = cases
    print(f"attn_variants: failed {failed or 'none'}")
    return 1 if "checkout" in failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
