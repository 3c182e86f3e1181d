"""coll/sync — periodic barrier injection for flow control.

Port of ``ompi_tpu/coll/sync.py`` (reference: ompi/mca/coll/sync, which
interposes on rooted collectives and injects a barrier every N calls so
that a root cannot run unbounded ahead of its consumers). On the card
the analog hazard is the stream's queue running far ahead of completion,
holding ever more live buffers; the injected barrier, waited for on its
completion event, bounds that depth.
"""

from __future__ import annotations

from typing import Any

from ..core import config
from ..core.counters import SPC
from .framework import COLL, record_completion
from .xla import XlaColl

_enable = config.register(
    "coll", "sync", "enable", type=bool, default=False,
    description="Enable periodic-barrier flow control",
)
_period = config.register(
    "coll", "sync", "barrier_before_nops", type=int, default=100,
    description="Inject a barrier every N rooted collectives "
    "(reference: coll_sync's barrier_before_nops)",
)


@COLL.register
class SyncColl(XlaColl):
    """XlaColl plus an injected barrier every N rooted ops. Selected
    only when enabled; its priority tops every data component (tuned is
    80) or the per-op merge would bypass the interposition."""

    NAME = "sync"
    PRIORITY = 90
    DESCRIPTION = "periodic barrier injection (reference coll/sync)"

    def __init__(self, framework) -> None:
        super().__init__(framework)
        self._counts: dict[int, int] = {}

    def available(self, **ctx: Any) -> bool:
        return bool(_enable.value)

    def _maybe_barrier(self, comm) -> None:
        n = self._counts.get(comm.cid, 0) + 1
        period = max(1, _period.value)
        if n >= period:
            n = 0
            token = super().barrier(comm)
            event = record_completion(token)
            if event is not None:
                event.synchronize()
            SPC.record("coll_sync_barriers")
        self._counts[comm.cid] = n

    # the reference interposes on the rooted ops (bcast/reduce/
    # gather/scatter) — the ones that let a root run ahead
    def bcast(self, comm, x, root):
        self._maybe_barrier(comm)
        return super().bcast(comm, x, root)

    def reduce(self, comm, x, op, root):
        self._maybe_barrier(comm)
        return super().reduce(comm, x, op, root)

    def gather(self, comm, x, root):
        self._maybe_barrier(comm)
        return super().gather(comm, x, root)

    def scatter(self, comm, x, root):
        self._maybe_barrier(comm)
        return super().scatter(comm, x, root)
