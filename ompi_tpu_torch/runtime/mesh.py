"""Rank discovery (port of ``ompi_tpu/runtime/mesh.py``).

The JAX package enumerates devices into ranks, one rank per TPU chip.
The port maps n virtual ranks onto one device: every rank's block of a
rank-major tensor lives in that device's memory, and a kernel plays
each rank in its own thread blocks. So there is one host and one slice,
and every ring order is as short as any other.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .proc import Proc, proc_on_device

#: The JAX package's test mesh size (tests/conftest.py: 8 CPU devices).
DEFAULT_NRANKS = 8


def discover(nranks: int = DEFAULT_NRANKS,
             device: torch.device | None = None) -> list[Proc]:
    """n world-ranked Procs, all on ``device``."""
    if nranks < 1:
        raise ValueError(f"nranks must be >= 1, got {nranks}")
    return [proc_on_device(i, device) for i in range(nranks)]


def live_procs() -> list[Proc]:
    """The initialized world's procs; before ``init``, the default
    world this machine would run (``cuda:0`` where there is a card).
    Read by the schedule compiler for topology, never to pick where a
    collective runs."""
    from .. import api

    if api._state is not None:
        return list(api._state.procs)
    dev = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    return discover(DEFAULT_NRANKS, dev)


def hosts_of(procs: Sequence[Proc]) -> dict[int, list[Proc]]:
    """Group procs by owning host process."""
    out: dict[int, list[Proc]] = {}
    for p in procs:
        out.setdefault(p.process_index, []).append(p)
    return out


def slices_of(procs: Sequence[Proc]) -> dict[int, list[Proc]]:
    """Group procs by slice (one card is one slice)."""
    out: dict[int, list[Proc]] = {}
    for p in procs:
        out.setdefault(p.slice_index, []).append(p)
    return out


def ring_order(procs: Sequence[Proc]) -> list[int]:
    """Ring order of the ranks: the identity, as the JAX package's on a
    mesh without coordinates. Every rank of the port shares one HBM, so
    no order has shorter hops than another."""
    return [p.rank for p in procs]
