"""Launch wiring: port of apex_example_tpu/parallel/launch.py
(``maybe_initialize_distributed`` :57, ``is_main_process`` :74).

The JAX launch counts hosts: one process per host sees every chip of it.
The port counts processes, one per GPU, as the apex reference is launched
(``torchrun --nproc_per_node N``): torchrun's contract is read from the
environment, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``, and ``WORLD_SIZE`` counts processes, so GPUs.

On the card (``device`` cuda) each process takes ``cuda:LOCAL_RANK`` and
the NCCL backend; on the CPU gloo.  A library caller may name another
backend (gloo on the card, for several processes on one GPU, where NCCL
refuses two ranks); the command line cannot.  Where NCCL is missing or
fails to start on a CUDA run, this raises: nothing falls back to gloo.
With no launcher in the environment nothing is initialized and the
caller runs as one process.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Mapping, Optional, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class LaunchEnv:
    """torchrun's contract, read from the environment."""
    rank: int
    world: int
    local_rank: int
    master_addr: str
    master_port: int


def launch_env(env: Optional[Mapping[str, str]] = None
               ) -> Optional[LaunchEnv]:
    """The launcher's settings, or None where no launcher set
    ``MASTER_ADDR`` and ``WORLD_SIZE``."""
    env = os.environ if env is None else env
    if not (env.get("MASTER_ADDR") and env.get("WORLD_SIZE")):
        return None
    return LaunchEnv(rank=int(env.get("RANK", "0")),
                     world=int(env["WORLD_SIZE"]),
                     local_rank=int(env.get("LOCAL_RANK", "0")),
                     master_addr=env["MASTER_ADDR"],
                     master_port=int(env.get("MASTER_PORT", "29500")))


def local_device(device="cuda",
                 env: Optional[Mapping[str, str]] = None) -> torch.device:
    """The device of this process: ``cuda`` means ``cuda:LOCAL_RANK``
    under a launcher; any other device, or no launcher, leaves it as it
    is."""
    dev = torch.device(device)
    spec = launch_env(env)
    if dev.type != "cuda" or dev.index is not None or spec is None:
        return dev
    return torch.device("cuda", spec.local_rank)


def maybe_initialize_distributed(device="cuda", backend: Optional[str] = None,
                                 env: Optional[Mapping[str, str]] = None
                                 ) -> Tuple[int, int]:
    """Join the launcher's process group if the environment names one;
    returns ``(rank, world)``, ``(0, 1)`` with no launcher.  ``backend``:
    None picks NCCL for a CUDA ``device`` (raising where it is missing)
    and gloo for the CPU.  Idempotent: an initialized group is returned
    as it is."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    spec = launch_env(env)
    if spec is None:
        return 0, 1
    dev = local_device(device, env)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if backend == "nccl":
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA run takes the NCCL backend, and this "
                               "torch has no NCCL")
        torch.cuda.set_device(dev)
        kw["device_id"] = dev          # start the communicator now
    # torchrun's own rendezvous store sits at MASTER_PORT: env:// finds it
    init = ("env://" if env is None else
            f"tcp://{spec.master_addr}:{spec.master_port}")
    dist.init_process_group(backend, init_method=init,
                            world_size=spec.world, rank=spec.rank, **kw)
    return dist.get_rank(), dist.get_world_size()


def is_main_process() -> bool:
    """The rank-0 predicate (apex's ``rank == 0`` guards); True in a
    single process."""
    return not dist.is_initialized() or dist.get_rank() == 0
