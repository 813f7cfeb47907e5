"""Optimizers of the port (FusedLAMB, FusedAdam, FusedSGD, FusedNovoGrad,
FusedAdagrad) and learning-rate schedules."""

from apex_example_tpu_torch.optim.fused import (FusedAdagrad, FusedAdam,
                                                FusedLAMB, FusedNovoGrad,
                                                FusedSGD)
from apex_example_tpu_torch.optim.schedules import build_schedule

__all__ = ["FusedAdagrad", "FusedAdam", "FusedLAMB", "FusedNovoGrad",
           "FusedSGD", "build_schedule"]
