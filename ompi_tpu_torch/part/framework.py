"""part framework: partitioned-communication component selection.

Port of ``ompi_tpu/part/framework.py`` (reference: ompi/mca/part,
part.h:90- module struct; exactly one part component serves the job —
ompi_part_base_select picks the single highest-priority available
component). Selected once, lazily, against the first communicator that
needs it; the ``part_select`` filter cvar forces a component by name.
The JAX package wraps the winner in its sanitizer and trace
interpositions; the port has neither plane yet, so the component is
used as selected.
"""

from __future__ import annotations

from ..core import component as mca

PART = mca.framework("part", "partitioned point-to-point communication")


class PartComponent(mca.Component):
    """Base class: builds partitioned requests over the pml.

    psend_init(comm, value, partitions, dest, tag, source=) and
    precv_init(comm, partitions, source, tag, dest=, like=) return
    core.request.PartitionedRequest subclasses."""

    def psend_init(self, comm, value, partitions, dest, tag=0, *,
                   source=None):
        raise NotImplementedError

    def precv_init(self, comm, partitions, source, tag=0, *, dest, like):
        raise NotImplementedError


def block_range(i: int, n: int, total: int) -> tuple[int, int]:
    """Element range [lo, hi) of block i in an n-way block distribution
    of ``total`` elements (the first total % n blocks carry the extra
    element). Both sides of a partitioned pair, and the bucketed-coll
    hook, derive ranges from this one function, which keeps N sender
    partitions vs M receiver partitions well-defined without a wire
    handshake."""
    base, rem = divmod(total, n)
    lo = i * base + min(i, rem)
    return lo, lo + base + (1 if i < rem else 0)


_selected = None
_registered = False


def ensure_components() -> None:
    global _registered
    if not _registered:
        from . import persist  # noqa: F401 - self-registers

        _registered = True


def select_for_comm(comm) -> PartComponent:
    global _selected
    ensure_components()
    if _selected is None:
        _selected = PART.select_one(comm=comm)
    return _selected


def reset_selection() -> None:
    """Drop the cached component (used when selection config changes)."""
    global _selected
    _selected = None
