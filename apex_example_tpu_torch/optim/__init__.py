"""Optimizers of the port (FusedLAMB) and learning-rate schedules."""
