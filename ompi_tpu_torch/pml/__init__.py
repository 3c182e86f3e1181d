"""Point-to-point messaging layer (port of ``ompi_tpu/pml``; reference:
ompi/mca/pml)."""

from .framework import PML, PmlComponent, select_for_comm

__all__ = ["PML", "PmlComponent", "select_for_comm"]
