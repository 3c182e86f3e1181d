"""Trace instants, as a seam.

The JAX package's ``trace/span.instant`` records one event on the
timeline when tracing is on. The port has no recorder yet (ROADMAP
Queue 1 item 9), so ``instant`` is a no-op that takes the same
arguments; the call sites stay where the JAX package has them.
"""

from __future__ import annotations

from typing import Any


def instant(name: str, cat: str = "event", **args: Any) -> None:
    del name, cat, args
