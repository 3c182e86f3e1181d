"""Output streams (port of ``ompi_tpu/core/logging.py``, the
opal_output analog) on the stdlib ``logging`` module, under the
``ompi_tpu_torch`` logger tree.
"""

from __future__ import annotations

import logging
import sys
import threading

_LOCK = threading.Lock()
_CONFIGURED = False
_ROOT = "ompi_tpu_torch"


def _ensure_root() -> None:
    global _CONFIGURED
    with _LOCK:
        if _CONFIGURED:
            return
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter(f"[{_ROOT}:%(name)s] %(levelname)s %(message)s")
        )
        root = logging.getLogger(_ROOT)
        root.addHandler(handler)
        root.setLevel(logging.WARNING)
        root.propagate = False
        _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    """Get the logger for a logical stream, e.g. 'coll', 'mca'."""
    _ensure_root()
    return logging.getLogger(f"{_ROOT}.{name}")
