#!/usr/bin/env python3
"""The attention phase of chip_smoke.py on the checkout's flash kernels and
on variants of apex_example_tpu_torch/csrc/attention.cu, in one process on
one card.

    python3 tools/attn_variants.py [VARIANT ...]   # from a checkout's root

A variant is the source with some texts replaced (VARIANTS below), built
beside the checkout's library with the same flags; each library in turn
runs chip_smoke.phase_attention (every ATTN_CASES check against the
limit, then the times at gpt_base's shape); a library that fails a check
prints which, then its times alone.  With no argument every variant
runs.

- ``no_retake``: no pair's S and dP are taken again in the plain chain
  (flip_limit beyond any P or |dS|): the tensor cores' values everywhere.
- ``t_async``: the fp32 backward copies its stationary tiles with 4-byte
  cp.async copies through the strides, as it does for any view that is
  not contiguous, in place of 16-byte loads.
- ``dq_scores_g0``: the fp32 dQ scales, biases and masks its scores in
  group 0 before the barrier, as dK/dV does, not in the shared pass.
- ``dkdv_scores_shared``: the fp32 dK/dV does it in the shared pass, as
  dQ does.
"""

import ctypes
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


def build(build_mod, default, name, edits):
    """The variant's library, built beside the checkout's, bound like it."""
    src = (build_mod.CSRC / "attention.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: a text is not in attention.cu "
                             f"once")
        src = src.replace(old, new)
    path = build_mod.BUILD_DIR / "variants" / f"attention_{name}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    out = path.with_suffix(".so")
    proc = subprocess.run([build_mod.nvcc(), *build_mod.NVCC_FLAGS, "-I",
                           str(build_mod.CSRC), "-o", str(out), str(path)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"variant {name} did not build:\n{proc.stdout}"
                         f"{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    for entry in ENTRIES:
        fn, ref = getattr(lib, entry), getattr(default, entry)
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
    return lib


def main(names):
    if not torch.cuda.is_available():
        print("attn_variants: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from apex_example_tpu_torch.ops import _build
    from apex_example_tpu_torch.ops import attention as att

    chip_smoke.phase_env()
    default = att._library()
    libs = {"checkout": default}
    for name in names or VARIANTS:
        libs[name] = build(_build, default, name, VARIANTS[name])
    failed = []
    for name, lib in libs.items():
        print(f"attn_variants: {name}")
        att._library = lambda lib=lib: lib
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
