"""Structured logging (replaces the reference's FileLogger that re-opens
``logfile.log`` per message, src/filelogger.h:8-22)."""

from __future__ import annotations

import logging
import sys


def get_logger(name: str = "ahsoka_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    root = logging.getLogger("ahsoka_tpu_torch")
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        root.addHandler(handler)
        root.setLevel(logging.INFO)
    return logger
