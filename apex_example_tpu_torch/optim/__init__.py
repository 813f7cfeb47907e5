"""Optimizers of the port (FusedLAMB, FusedAdam, FusedSGD) and learning-rate
schedules."""
