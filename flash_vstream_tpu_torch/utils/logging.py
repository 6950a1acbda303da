"""Logging: console plus an optional daily-rotating file.

Port of `build_logger` (flash_vstream_tpu/utils/logging.py:18-33), so the
port imports nothing of the JAX package.
"""
from __future__ import annotations

import logging
import logging.handlers
import os
from typing import Optional

_FMT = "%(asctime)s | %(levelname)s | %(name)s | %(message)s"


def build_logger(name: str, log_file: Optional[str] = None,
                 level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not any(isinstance(h, logging.StreamHandler) for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(sh)
    if log_file and not any(
            isinstance(h, logging.handlers.TimedRotatingFileHandler)
            for h in logger.handlers):
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.handlers.TimedRotatingFileHandler(log_file, when="D",
                                                       utc=True)
        fh.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(fh)
    return logger
