"""Library logging — a copy of ``sparktorch_tpu/obs/log.py`` with the port's logger root.

Human-readable progress lines (the trainers' ``verbose`` output) go
through this logger, never through ``print``. One stderr handler,
configured once, never propagating into a host app's root logger; set
the ``SPARKTORCH_TPU_LOG_LEVEL`` env var (DEBUG, INFO, ...) to change
verbosity process-wide, as for the JAX package.
"""

from __future__ import annotations

import logging
import os
import threading

_ROOT = "sparktorch_tpu_torch"
_LOCK = threading.Lock()
_CONFIGURED = False


def get_logger(name: str = _ROOT) -> logging.Logger:
    global _CONFIGURED
    root = logging.getLogger(_ROOT)
    with _LOCK:
        if not _CONFIGURED:
            handler = logging.StreamHandler()
            handler.setFormatter(logging.Formatter("%(message)s"))
            root.addHandler(handler)
            root.setLevel(
                os.environ.get("SPARKTORCH_TPU_LOG_LEVEL", "INFO").upper()
            )
            root.propagate = False
            _CONFIGURED = True
    return logging.getLogger(name)
