"""Structured logging (glog-equivalent, ref: src/base/utils.hpp:9).

The reference logs a fixed-width table row per solver iteration
(src/solver/solver-inl.hpp:24-69). ``get_logger`` gives a process-wide
logger; on multi-host runs only process 0 should emit (the solver checks).
"""

from __future__ import annotations

import logging
import sys

_CONFIGURED = False


def get_logger(name: str = "cdae_jax") -> logging.Logger:
    global _CONFIGURED
    logger = logging.getLogger(name)
    if not _CONFIGURED:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(levelname).1s%(asctime)s] %(message)s", "%m%d %H:%M:%S")
        )
        root = logging.getLogger("cdae_jax")
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
        _CONFIGURED = True
    return logger
