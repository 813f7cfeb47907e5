"""apex_example_tpu_torch: the PyTorch + CUDA port of apex_example_tpu.

The JAX package beside it is the reference each ported piece is held
against.  This package imports torch, numpy and the standard library only,
never jax nor any module of apex_example_tpu: what it needs from there it
keeps as its own copy.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU, where every kernel's plain PyTorch version runs instead.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.  Asking for CUDA on a
    machine without it raises: nothing carries on on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for, but torch sees no CUDA "
            "device; pass --device cpu (library: device='cpu') to run the "
            "plain versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {str(dev)!r}")
    return dev
