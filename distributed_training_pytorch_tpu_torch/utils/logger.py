"""Console + file logger.

Counterpart of ``distributed_training_pytorch_tpu/utils/logger.py``: a named stdlib
logger at INFO with a timestamped format, console and file handlers, and
``log(message, log_type)`` mapping warning/error/anything else to those levels. Only
rank 0 of a ``torch.distributed`` process group writes the file (mode ``"w"``: a fresh
file per run); with several ranks, console lines carry the rank.
"""

from __future__ import annotations

import logging
import os
import sys

from distributed_training_pytorch_tpu_torch.parallel.mesh import process_count, process_index

__all__ = ["Logger"]

_FORMAT = "%(asctime)s | %(name)s | %(levelname)s | %(message)s"


class Logger:
    """``Logger(name, log_file)``."""

    def __init__(self, name: str, log_file: "str | None" = None, *, level: int = logging.INFO):
        self.name = name
        self.log_file = log_file
        rank, world = process_index(), process_count()
        self._logger = logging.getLogger(f"{name}.{os.getpid()}")
        self._logger.setLevel(level)
        self._logger.propagate = False
        self._logger.handlers.clear()
        fmt = _FORMAT if world == 1 else f"%(asctime)s | p{rank} | %(name)s | %(levelname)s | %(message)s"
        formatter = logging.Formatter(fmt)
        console = logging.StreamHandler(sys.stdout)
        console.setFormatter(formatter)
        self._logger.addHandler(console)
        if log_file is not None and rank == 0:
            os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
            file_handler = logging.FileHandler(log_file, mode="w")
            file_handler.setFormatter(formatter)
            self._logger.addHandler(file_handler)

    def log(self, message: str, log_type: str = "info") -> None:
        """warning/error -> those levels, anything else -> info."""
        if log_type == "warning":
            self._logger.warning(message)
        elif log_type == "error":
            self._logger.error(message)
        else:
            self._logger.info(message)
