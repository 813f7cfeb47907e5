"""Utilities of the port (training-loop meters)."""
