"""Logging: a named stdlib logger with a console handler at ``level`` and,
with ``log_file``, a DEBUG file handler, in the JAX package's format
(``utils/logger.py``). Calling it again reconfigures the logger instead of
stacking handlers."""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Optional

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def setup_logger(name: str, log_file: Optional[str] = None, level: int = logging.INFO,
                 console_output: bool = True) -> logging.Logger:
    """Create (or fetch and reconfigure) the logger ``name``."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    formatter = logging.Formatter(_FORMAT)
    if console_output:
        ch = logging.StreamHandler(sys.stdout)
        ch.setLevel(level)
        ch.setFormatter(formatter)
        logger.addHandler(ch)
    if log_file is not None:
        path = Path(log_file)
        path.parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(path)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger


__all__ = ["setup_logger"]
