#!/usr/bin/env python3
"""The attention phase of chip_smoke.py on the checkout's flash kernels and
on variants of apex_example_tpu_torch/csrc/attention.cu, in one process on
one card.

    python3 tools/attn_variants.py [VARIANT ...]   # from a checkout's root

A variant is the source with one text replaced (VARIANTS below), built
beside the checkout's library with the same flags; each library in turn
runs chip_smoke.phase_attention (every ATTN_CASES check against the
limit, then the times at gpt_base's shape); a library that fails a check
prints which, then its times alone.  With no argument every variant
runs.

- ``no_retake``: no pair's S and dP are taken again in the plain chain
  (flip_limit beyond any P or |dS|): the tensor cores' values everywhere.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = {
    "no_retake": ("return std::is_same<T, __half>::value ? 0.125f : 1.f / 64;",
                  "return 1e30f;"),
}
ENTRIES = ("apex_attn_fwd", "apex_attn_dq", "apex_attn_dkdv",
           "apex_cuda_error_string")


def build(build_mod, default, name, old, new):
    """The variant's library, built beside the checkout's, bound like it."""
    src = (build_mod.CSRC / "attention.cu").read_text()
    if old not in src:
        raise SystemExit(f"variant {name}: its text is not in attention.cu")
    path = build_mod.BUILD_DIR / "variants" / f"attention_{name}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src.replace(old, new))
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
        libs[name] = build(_build, default, name, *VARIANTS[name])
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
