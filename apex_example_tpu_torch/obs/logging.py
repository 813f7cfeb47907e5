"""Rank-aware printing: a copy of ``rank_print`` (:49) of
apex_example_tpu/obs/logging.py, with the rank from torch.distributed.

Rank 0 prints through ``print`` itself; the other ranks send the same
line to the ``apex_example_tpu_torch`` logger at DEBUG, where a handler
can recover it.  Single-process (and before the process group starts)
the rank is 0.
"""

from __future__ import annotations

import builtins
import io
import logging
import sys

import torch.distributed as dist

LOGGER_NAME = "apex_example_tpu_torch"


def get_logger(name: str = LOGGER_NAME) -> logging.Logger:
    """The package logger, given a stderr handler at first use."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def rank_print(*args, sep: str = " ", end: str = "\n", file=None,
               flush: bool = False) -> None:
    """``print`` on rank 0; the rendered line at DEBUG on the others."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    if rank == 0:
        builtins.print(*args, sep=sep, end=end, file=file, flush=flush)
        return
    buf = io.StringIO()
    builtins.print(*args, sep=sep, end="", file=buf)
    get_logger().debug("rank %d: %s", rank, buf.getvalue())
