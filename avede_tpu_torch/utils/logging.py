"""Structured logging (counterpart of ``avede_tpu/utils/logging.py``)."""

from __future__ import annotations

import logging
import os
import sys

_ROOT = "avede_tpu_torch"


def _configure() -> logging.Logger:
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        level = os.environ.get("LOG_LEVEL", "INFO").upper()
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
        root.setLevel(getattr(logging, level, logging.INFO))
        root.addHandler(handler)
        root.propagate = False
    return root


def get_logger(name: str) -> logging.Logger:
    _configure()
    if not name.startswith(_ROOT):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)
