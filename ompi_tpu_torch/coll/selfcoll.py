"""coll/self — trivial collectives for size-1 communicators.

Port of ``ompi_tpu/coll/selfcoll.py`` (reference: ompi/mca/coll/self, the
identity operations). Selected at priority 100 whenever the
communicator has one rank, so such a communicator compiles no plan and
launches no kernel: to reach a kernel's one-rank form (the chunked
identity) through ``TunedColl``, lower ``coll_self_priority`` below
tuned's 80 before the communicator is made.
"""

from __future__ import annotations

import torch

from ..ops import lookup as op_lookup
from .framework import COLL, CollComponent
from .spmd import _exscan_identity, _tree_map
from .xla import scatter_buffer


@COLL.register
class SelfColl(CollComponent):
    NAME = "self"
    PRIORITY = 100
    DESCRIPTION = "size-1 communicator fast paths (reference: coll/self)"

    def available(self, comm=None, **_):
        return comm is not None and comm.size == 1

    def allreduce(self, comm, x, op):
        return x

    def bcast(self, comm, x, root):
        return x

    def reduce(self, comm, x, op, root):
        return _tree_map(lambda leaf: leaf[0], x)

    def allgather(self, comm, x):
        return torch.as_tensor(x)[:, None]

    def reduce_scatter_block(self, comm, x, op):
        return torch.as_tensor(x)[:, 0]

    def alltoall(self, comm, x):
        return x

    def gather(self, comm, x, root):
        return torch.as_tensor(x)

    def scatter(self, comm, x, root):
        return scatter_buffer(comm, x)

    def scan(self, comm, x, op):
        return x

    def exscan(self, comm, x, op):
        return _exscan_identity(torch.as_tensor(x), op_lookup(op))

    def barrier(self, comm):
        return None
