"""Logging setup (copy of eitx/core/log.py, under the port's namespace).

The reference mixes stdlib basicConfig with emoji-prefixed messages, a
loguru file logger with rotation on the frontend, and a bespoke date-tree
logger in scripts (SURVEY component 26). Here one function configures the
whole framework: console + optional size-rotated file handler, consistent
format, per-module loggers under the "eitx_torch" namespace.
"""

from __future__ import annotations

import logging
import logging.handlers
import os
from typing import Optional

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def setup_logging(
    level: int = logging.INFO,
    log_dir: Optional[str] = None,
    filename: str = "eitx.log",
    max_bytes: int = 20 * 1024 * 1024,
    backups: int = 5,
) -> logging.Logger:
    root = logging.getLogger("eitx_torch")
    root.setLevel(level)
    root.handlers.clear()
    console = logging.StreamHandler()
    console.setFormatter(logging.Formatter(_FORMAT))
    root.addHandler(console)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.handlers.RotatingFileHandler(
            os.path.join(log_dir, filename),
            maxBytes=max_bytes,
            backupCount=backups,
        )
        fh.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(fh)
    return root
