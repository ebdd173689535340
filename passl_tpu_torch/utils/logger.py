"""Primary-process logger to stdout and, optionally, a file.

Counterpart of `passl_tpu/utils/logger.py`, without jax: the primary
process is rank 0 of `torch.distributed` when that is initialized, else
this process.
"""
from __future__ import annotations

import functools
import logging
import os
import sys
from typing import Optional

import torch.distributed as dist

_NAME = "passl_tpu_torch"


def _is_primary() -> bool:
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def init_logger(log_file: Optional[str] = None) -> logging.Logger:
    """Log INFO and up to stdout (and to `log_file`) on the primary process."""
    logger = logging.getLogger(_NAME)
    logger.handlers.clear()
    logger.setLevel(logging.INFO if _is_primary() else logging.ERROR)
    logger.propagate = False
    fmt = logging.Formatter("[%(asctime)s] %(name)s %(levelname)s: %(message)s",
                            datefmt="%Y/%m/%d %H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file is not None and _is_primary():
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file, mode="a")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def get_logger() -> logging.Logger:
    logger = logging.getLogger(_NAME)
    return logger if logger.handlers else init_logger()


def _log(level: str, msg: str) -> None:
    getattr(get_logger(), level)(msg)


info = functools.partial(_log, "info")
warning = functools.partial(_log, "warning")
