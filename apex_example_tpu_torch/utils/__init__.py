"""Utilities of the port (training-loop meters, checkpoints, FLOPs)."""
