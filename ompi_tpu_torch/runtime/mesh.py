"""Rank discovery (port of ``ompi_tpu/runtime/mesh.py``).

The JAX package enumerates devices into ranks, one rank per TPU chip.
The port maps n virtual ranks onto one device: every rank's block of a
rank-major tensor lives in that device's memory, and a kernel plays
each rank in its own thread blocks.
"""

from __future__ import annotations

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
