"""ompi_tpu_torch — the PyTorch/CUDA port of ``ompi_tpu`` for one
NVIDIA H100.

The port is a package of its own beside ``ompi_tpu/``, which stays the
reference. Its main path is the one ``ompi_tpu`` runs for IMB-MPI1
``MPI_Allreduce``, ``MPI_Bcast``, ``MPI_Reduce``,
``MPI_Reduce_scatter_block`` and ``MPI_Allgather``: ``init`` →
``Communicator`` → coll vtable → the collective, through hand-written
CUDA counterparts of the Pallas ring and tree kernels
(``coll/pallas_ring.py``, sources in ``csrc/``). The rest of the
collective surface (scan, exscan, barrier, the ragged and neighborhood
variants, the persistent ``*_init`` forms completing on CUDA events)
runs through the same vtable, and ``tools/imb.py`` sweeps it in
IMB-MPI1 style. The nonblocking ``i*`` forms are the blocking dispatch
completing on a CUDA event; point-to-point (``comm.send``/``recv``/
``isend``/``irecv``, ``comm.rank(r)``) runs ob1 matching over the
in-process BTLs (``pml/``, ``btl/``), and ``coll.nbc``'s libnbc-style
round schedules run over it; ``datatype/`` packs derived layouts.

Rules of the port:

- ``ompi_tpu/`` and every file that was in the repository before the
  port began stay as they are; only the docs (README, ROADMAP, CHANGES,
  PERF), ``.gitignore``, the verify notes and ``pytest.ini`` (to
  register a marker) may change. The JAX package's tests keep passing.
- The port imports ``torch``, never ``jax``, and nothing from
  ``ompi_tpu`` — not even its JAX-free modules such as
  ``core/config.py`` and ``ops/op.py``: the port keeps its own copy.
  Only the parity tests import both packages.
- Entry points run on ``cuda:0`` unless the caller passes
  ``device="cpu"``, as the CPU tests do; ``init()`` raises when CUDA is
  absent and no CPU device was asked for.
- No fallback hides the device or a kernel. A kernel that fails to
  build or to launch raises ``KernelError``. A wrapper takes its plain
  version only for a tensor on the CPU. ``TunedColl`` does not degrade
  to another tier on a fault: the fault propagates.
- Rank-major convention: a collective argument is a contiguous
  ``(n, ...)`` tensor holding n virtual ranks on one device.
"""

from . import coll
from .api import finalize, init, world
from .communicator import Communicator

__all__ = ["init", "finalize", "world", "Communicator", "coll"]
