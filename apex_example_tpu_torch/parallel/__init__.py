"""apex.parallel's surface in the port, its data-parallel part: DDP and
its reduction options, SyncBatchNorm across processes, LARC, the data
group and the launch (apex_example_tpu/parallel/__init__.py; the model-
parallel meshes and context parallelism wait for ROADMAP.md A.6)."""

from apex_example_tpu_torch.parallel.distributed import (
    DDPConfig, DistributedDataParallel, Reducer, all_reduce_max,
    all_reduce_sum, allreduce_grads, broadcast_from_zero, reduce_mean,
    replicate_mean)
from apex_example_tpu_torch.parallel.larc import LARC
from apex_example_tpu_torch.parallel.launch import (
    is_main_process, local_device, maybe_initialize_distributed)
from apex_example_tpu_torch.parallel.mesh import (DATA_AXIS, DataMesh,
                                                  make_data_mesh)
from apex_example_tpu_torch.parallel.sync_batchnorm import (
    SyncBatchNorm, convert_syncbn_model)

__all__ = [
    "DATA_AXIS", "DDPConfig", "DataMesh", "DistributedDataParallel", "LARC",
    "Reducer", "SyncBatchNorm", "all_reduce_max", "all_reduce_sum",
    "allreduce_grads", "broadcast_from_zero", "convert_syncbn_model",
    "is_main_process", "local_device", "make_data_mesh",
    "maybe_initialize_distributed", "reduce_mean", "replicate_mean",
]
