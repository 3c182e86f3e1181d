"""part — MPI-4 partitioned point-to-point communication (port of
``ompi_tpu/part``; reference: ompi/mca/part, part.h — the
MPI_Psend_init / MPI_Precv_init / MPI_Pready / MPI_Parrived framework).
One framework, one default component (part/persist) layering
partitioned requests over the selected pml.
"""

from .framework import PART, PartComponent, block_range, select_for_comm

__all__ = ["PART", "PartComponent", "block_range", "select_for_comm"]
