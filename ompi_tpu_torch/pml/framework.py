"""PML framework: point-to-point messaging layer selection.

Port of ``ompi_tpu/pml/framework.py`` (reference: ompi/mca/pml, pml.h:
494- module struct; exactly one PML per job, pml.h:40-47). One PML
serves all communicators; the component is selected once by priority
(select_one). The port registers ``ob1`` alone: ``cm`` (``pml/mtl.py``)
needs the native engine, so ``pml_select=cm`` raises
``ComponentError`` until then. The JAX package wraps the winner in its
fault-tolerance, sanitizer, trace and revocation interpositions; those
come with their planes.
"""

from __future__ import annotations

from ..core import component as mca

PML = mca.framework("pml", "point-to-point messaging layer")


class PmlComponent(mca.Component):
    """Base class: isend/send/irecv/recv/probe(comm, ...)."""


_selected = None
_registered = False


def ensure_components() -> None:
    global _registered
    if not _registered:
        from . import ob1  # noqa: F401 - self-register

        _registered = True


def select_for_comm(comm) -> PmlComponent:
    global _selected
    ensure_components()
    if _selected is None:
        _selected = PML.select_one(comm=comm)
    return _selected


def reset_selection() -> None:
    """Drop the cached PML (used when the selection config changes)."""
    global _selected
    _selected = None
