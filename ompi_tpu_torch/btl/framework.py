"""BTL — byte/buffer transfer layer between ranks.

Port of ``ompi_tpu/btl/framework.py`` (reference: opal/mca/btl, btl.h:
1210-1219 module struct with eager/rndv/max-send limits; btl/self,
btl/sm, btl/smcuda) plus the BML multiplexer choosing a BTL per peer
(reference: bml/r2, bml_r2.c:131-148).

In the port every rank of a process shares one device, so a transfer
is a copy within that device's memory:

- ``self``: the same rank (loopback). The JAX package compares devices,
  which on one card would match every pair; the port compares world
  ranks.
- ``ici``: any other rank of this process, a device-to-device copy in
  the one HBM (the btl/smcuda analog).

Tensors are mutable, so every transfer, loopback included, hands the
receiver a tensor of its own (``copy_payload``): a sender may write its
buffer once the send completes, as MPI allows, without changing what
the receiver got. A copy onto a card is enqueued on the current stream;
the PML records a CUDA event after it.

Each BTL advertises ``eager_limit``: payloads at or below it are copied
at send time (possibly before the recv is posted — "unexpected" delivery
buffered at the destination); larger payloads use the PML's rendezvous
protocol and move only once the recv is matched (reference: ob1's
eager/rndv split, pml_ob1_sendreq.h:385-455).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core import component as mca
from ..core import config
from ..core.errors import CommError
from ..core.tree import map_leaves
from ..trace import span as tspan

BTL = mca.framework("btl", "inter-device transfer layer")


def _copy_leaf(leaf: Any, device: torch.device) -> Any:
    if isinstance(leaf, torch.Tensor):
        out = leaf.to(device)
        # .to() returns the tensor itself when it already lies there.
        return out.clone() if out is leaf else out
    if isinstance(leaf, (np.ndarray, np.generic, bool, int, float)):
        return torch.tensor(leaf, device=device)
    return leaf  # immutable (str, bytes, ...): nothing to own


def copy_payload(value: Any, device: torch.device) -> Any:
    """``value`` (a tensor, numpy array or scalar, or nested tuples,
    lists and dicts of them) as new tensors on ``device``, in storage
    of their own."""
    return map_leaves(lambda leaf: _copy_leaf(leaf, device), value)


class BtlComponent(mca.Component):
    """A transfer method between a pair of ranks."""

    #: bytes at/below which sends ship immediately (reference default
    #: lineage: tcp 64KiB, sm 32KiB — btl_tcp_component.c:322,
    #: btl_sm_component.c:243)
    EAGER_LIMIT = 64 * 1024

    def __init__(self, framework: mca.Framework) -> None:
        super().__init__(framework)
        self._eager_var = config.register(
            framework.name,
            self.NAME,
            "eager_limit",
            type=int,
            default=self.EAGER_LIMIT,
            description=f"Eager-send byte limit for btl/{self.NAME}",
        )

    @property
    def eager_limit(self) -> int:
        return self._eager_var.value

    def can_reach(self, src_proc, dst_proc) -> bool:
        raise NotImplementedError

    def transfer(self, value: Any, src_proc, dst_proc) -> Any:
        """Copy a value onto dst's device (enqueued on the current
        stream; returns the new tensors at once)."""
        return copy_payload(value, dst_proc.device)

    def wire_label(self, comm, src_rank: int, dst_rank: int) -> str:
        """comm_method detail string for this pair: the component name
        (a component that muxes several mechanisms appends its lanes)."""
        return self.NAME


@BTL.register
class SelfBtl(BtlComponent):
    """Loopback: source and destination are the same rank."""

    NAME = "self"
    PRIORITY = 100
    EAGER_LIMIT = 1 << 62  # one local copy, no reason to delay

    def can_reach(self, src_proc, dst_proc) -> bool:
        return src_proc.rank == dst_proc.rank


@BTL.register
class IciBtl(BtlComponent):
    """Rank-to-rank copy within one process (one device's memory)."""

    NAME = "ici"
    PRIORITY = 50
    EAGER_LIMIT = 64 * 1024

    def can_reach(self, src_proc, dst_proc) -> bool:
        return src_proc.process_index == dst_proc.process_index


class Bml:
    """Per-communicator endpoint table: the chosen BTL per peer pair
    (reference: bml/r2 building per-proc endpoint arrays)."""

    def __init__(self, comm) -> None:
        self._comm = comm
        self._cache: dict[tuple[int, int], BtlComponent] = {}

    def btl_for(self, src_rank: int, dst_rank: int) -> BtlComponent:
        key = (src_rank, dst_rank)
        btl = self._cache.get(key)
        if btl is None:
            src = self._comm.procs[src_rank]
            dst = self._comm.procs[dst_rank]
            for cand in BTL.select_all():
                if cand.can_reach(src, dst):
                    btl = cand
                    break
            if btl is None:
                raise CommError(
                    f"no btl reaches rank {src_rank}->{dst_rank} "
                    f"({src.device} -> {dst.device})"
                )
            # once per pair: which wire won the reachability race
            tspan.instant("btl.select", cat="btl", src=src_rank,
                          dst=dst_rank, btl=btl.NAME)
            self._cache[key] = btl
        return btl

    def wire_label(self, src_rank: int, dst_rank: int) -> str:
        """The selected BTL's lane-qualified label for this pair
        (reference: hook_comm_method printing the chosen mechanism)."""
        btl = self.btl_for(src_rank, dst_rank)
        return btl.wire_label(self._comm, src_rank, dst_rank)
