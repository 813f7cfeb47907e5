"""The data-parallel group: the data part of
apex_example_tpu/parallel/mesh.py (``DATA_AXIS`` :27, ``make_data_mesh``
:33).

JAX names its data-parallel world by a mesh axis, ``"data"``, bound inside
``shard_map``; the port's world is a ``torch.distributed`` process group of
one process per GPU.  Every function of the port that reduces across the
world takes ``axis_name`` as the JAX one does, and reads it through
:func:`group_of`: ``DATA_AXIS`` (the default process group), a
:class:`DataMesh`, or a ``ProcessGroup``.  The model-parallel meshes
(``initialize_model_parallel``, the serving mesh) come with ROADMAP.md A.6.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch.distributed as dist

DATA_AXIS = "data"


@dataclass(frozen=True)
class DataMesh:
    """The data-parallel group of this process: ``group`` (None for the
    default group), its ``world`` size, this process's ``rank`` in it and
    the ``backend`` (nccl or gloo)."""
    group: Optional[dist.ProcessGroup]
    world: int
    rank: int
    backend: str


def make_data_mesh(group: Optional[dist.ProcessGroup] = None) -> DataMesh:
    """The :class:`DataMesh` of ``group`` (default: the default process
    group, which must be initialized: parallel/launch.py)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: initialize one first "
                           "(parallel.launch.maybe_initialize_distributed)")
    return DataMesh(group=group, world=dist.get_world_size(group),
                    rank=dist.get_rank(group),
                    backend=str(dist.get_backend(group)))


def group_of(axis_name) -> Optional[dist.ProcessGroup]:
    """The process group that ``axis_name`` names: ``DATA_AXIS`` the
    default one (None), a :class:`DataMesh` its group, a ``ProcessGroup``
    itself.  Raises where no process group is initialized."""
    if not dist.is_initialized():
        raise RuntimeError(f"reducing over {axis_name!r} needs a process "
                           "group; none is initialized "
                           "(parallel.launch.maybe_initialize_distributed)")
    if isinstance(axis_name, DataMesh):
        return axis_name.group
    if isinstance(axis_name, str):
        if axis_name != DATA_AXIS:
            raise ValueError(f"the port's only named axis is "
                             f"{DATA_AXIS!r}, got {axis_name!r}")
        return None
    if isinstance(axis_name, dist.ProcessGroup):
        return axis_name
    raise TypeError(f"axis_name must be {DATA_AXIS!r}, a DataMesh or a "
                    f"ProcessGroup, got {type(axis_name).__name__}")


def axis_size(axis_name) -> int:
    """The number of processes of ``axis_name``'s group."""
    return dist.get_world_size(group_of(axis_name))
