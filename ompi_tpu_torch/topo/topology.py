"""Process topologies: cartesian, graph, and distributed graph.

Port of ``ompi_tpu/topo/topology.py`` (reference: topo_base_cart_create.c
and friends). Topologies attach to a communicator (``comm.topo``) and
give rank <-> coordinate mapping and neighbor enumeration, the substrate
of the neighborhood collectives. ``reorder=True`` raises until
treematch is ported (ROADMAP Queue 1 item 7): all ranks share one card,
so the identity order is as short as any other. The hardware
fingerprint keys the schedule cache.
"""

from __future__ import annotations

import hashlib
import json
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.errors import ArgumentError, TopologyError


class CartTopology:
    """MPI_Cart: n-dimensional (optionally periodic) grid."""

    def __init__(self, comm, dims: Sequence[int], periods: Sequence[bool],
                 ) -> None:
        total = int(np.prod(dims))
        if total != comm.size:
            raise ArgumentError(
                f"cart dims {tuple(dims)} need {total} ranks, comm has "
                f"{comm.size}"
            )
        self.comm = comm
        self.dims = tuple(int(d) for d in dims)
        self.periods = tuple(bool(p) for p in periods)
        if len(self.periods) != len(self.dims):
            raise ArgumentError("dims/periods length mismatch")

    @property
    def ndims(self) -> int:
        return len(self.dims)

    def coords(self, rank: int) -> tuple[int, ...]:
        """MPI_Cart_coords (row-major, C order)."""
        self.comm.check_rank(rank)
        out = []
        r = rank
        for d in reversed(self.dims):
            out.append(r % d)
            r //= d
        return tuple(reversed(out))

    def rank(self, coords: Sequence[int]) -> int:
        """MPI_Cart_rank; periodic dims wrap, others must be in range."""
        if len(coords) != self.ndims:
            raise ArgumentError("coords length mismatch")
        r = 0
        for c, d, p in zip(coords, self.dims, self.periods):
            if p:
                c = c % d
            elif not 0 <= c < d:
                raise TopologyError(
                    f"coordinate {c} out of range for non-periodic dim {d}"
                )
            r = r * d + c
        return r

    def shift(self, direction: int, disp: int
              ) -> tuple[Optional[int], Optional[int]]:
        """MPI_Cart_shift for every rank is derivable; the
        single-controller form returns (source, dest) for a given rank
        via shift_for."""
        raise TypeError("use shift_for(rank, direction, disp)")

    def shift_for(self, rank: int, direction: int, disp: int
                  ) -> tuple[Optional[int], Optional[int]]:
        if not 0 <= direction < self.ndims:
            raise ArgumentError(f"direction {direction} out of range")
        c = list(self.coords(rank))
        src_c, dst_c = list(c), list(c)
        src_c[direction] -= disp
        dst_c[direction] += disp

        def resolve(cc):
            try:
                return self.rank(cc)
            except TopologyError:
                return None  # MPI_PROC_NULL

        return resolve(src_c), resolve(dst_c)

    def neighbors(self, rank: int) -> list[int]:
        """±1 neighbors per dimension, in (dim, -/+) order; PROC_NULL
        omitted — the neighbor-collective ordering."""
        out = []
        for d in range(self.ndims):
            src, dst = self.shift_for(rank, d, 1)
            for n in (src, dst):
                if n is not None:
                    out.append(n)
        return out

    def sub(self, remain_dims: Sequence[bool]) -> dict[tuple, object]:
        """MPI_Cart_sub: partition into sub-grids along kept dims;
        returns {fixed_coords: communicator-with-CartTopology}."""
        if len(remain_dims) != self.ndims:
            raise ArgumentError("remain_dims length mismatch")
        drop = [d for d in range(self.ndims) if not remain_dims[d]]
        colors: list[int] = []
        keys: list[int] = []
        for r in range(self.comm.size):
            c = self.coords(r)
            color = 0
            for d in drop:
                color = color * self.dims[d] + c[d]
            key = 0
            for d in range(self.ndims):
                if remain_dims[d]:
                    key = key * self.dims[d] + c[d]
            colors.append(color)
            keys.append(key)
        split = self.comm.split(colors, keys)
        out = {}
        sub_dims = [self.dims[d] for d in range(self.ndims)
                    if remain_dims[d]]
        sub_periods = [self.periods[d] for d in range(self.ndims)
                       if remain_dims[d]]
        for color, comm in split.items():
            fixed = []
            cc = color
            for d in reversed(drop):
                fixed.append(cc % self.dims[d])
                cc //= self.dims[d]
            comm.topo = CartTopology(comm, sub_dims, sub_periods)
            out[tuple(reversed(fixed))] = comm
        return out


class GraphTopology:
    """MPI_Graph: global adjacency (index/edges CSR form)."""

    def __init__(self, comm, index: Sequence[int], edges: Sequence[int]
                 ) -> None:
        if len(index) != comm.size:
            raise ArgumentError("index length must equal comm size")
        self.comm = comm
        self.index = tuple(index)
        self.edges = tuple(edges)
        for e in self.edges:
            comm.check_rank(e)

    def neighbors(self, rank: int) -> list[int]:
        self.comm.check_rank(rank)
        lo = self.index[rank - 1] if rank else 0
        return list(self.edges[lo:self.index[rank]])

    def neighbor_count(self, rank: int) -> int:
        return len(self.neighbors(rank))


class DistGraphTopology:
    """MPI_Dist_graph: per-rank in/out neighbor lists (single-controller
    form: the controller supplies all ranks' adjacency)."""

    def __init__(self, comm, sources: dict[int, Sequence[int]],
                 destinations: dict[int, Sequence[int]]) -> None:
        self.comm = comm
        self.sources = {r: tuple(v) for r, v in sources.items()}
        self.destinations = {r: tuple(v) for r, v in destinations.items()}

    def in_neighbors(self, rank: int) -> tuple[int, ...]:
        return self.sources.get(rank, ())

    def out_neighbors(self, rank: int) -> tuple[int, ...]:
        return self.destinations.get(rank, ())


def dims_create(nnodes: int, ndims: int) -> tuple[int, ...]:
    """MPI_Dims_create: balanced factorization, decreasing order."""
    dims = [1] * ndims
    n = nnodes
    f = 2
    factors = []
    while f * f <= n:
        while n % f == 0:
            factors.append(f)
            n //= f
        f += 1
    if n > 1:
        factors.append(n)
    for f in sorted(factors, reverse=True):
        dims[dims.index(min(dims))] *= f
    return tuple(sorted(dims, reverse=True))


def _no_reorder(reorder: bool) -> None:
    """``reorder=True`` needs treematch, which is not ported yet."""
    if reorder:
        raise ArgumentError(
            "reorder=True needs topo/treematch.py, not ported yet "
            "(ROADMAP Queue 1 item 7)"
        )


def cart_create(comm, dims: Sequence[int],
                periods: Optional[Sequence[bool]] = None,
                reorder: bool = False):
    """MPI_Cart_create: returns a new communicator with `.topo` set."""
    if periods is None:
        periods = [False] * len(dims)
    _no_reorder(reorder)
    new = comm.dup()
    new.topo = CartTopology(new, dims, periods)
    new.set_name(f"{comm.name}.cart{tuple(dims)}")
    return new


def graph_create(comm, index: Sequence[int], edges: Sequence[int],
                 reorder: bool = False):
    """MPI_Graph_create."""
    _no_reorder(reorder)
    new = comm.dup()
    new.topo = GraphTopology(new, index, edges)
    return new


def dist_graph_create(comm, sources: dict, destinations: dict,
                      reorder: bool = False):
    """MPI_Dist_graph_create."""
    _no_reorder(reorder)
    new = comm.dup()
    new.topo = DistGraphTopology(new, sources, destinations)
    return new


# ---------------------------------------------------------------------------
# Neighbor collectives (reference: coll_base_functions.h:62-66,
# libnbc nbc_ineighbor_*.c) — single-controller forms over rank-major
# tensors.
# ---------------------------------------------------------------------------

def neighbor_allgather(comm, x):
    """Each rank receives its topology neighbors' blocks, in neighbor
    order (in-neighbors for dist_graph). x: rank-major (size, ...).
    Returns {rank: (n_neigh, ...)}, tensors on the comm's device."""
    topo = comm.topo
    if topo is None:
        raise TopologyError("communicator has no topology")
    _, ins = edge_fns(topo)
    arr = comm.put_rank_major(x)
    out = {}
    for r in range(comm.size):
        neigh = list(ins(r))
        out[r] = arr[neigh] if neigh else arr.new_zeros(
            (0,) + tuple(arr.shape[1:]))
    return out


def edge_fns(topo):
    """(outs, ins) accessor pair for any topology kind — dist_graph
    distinguishes directions, cart/graph edges are symmetric."""
    def outs(r):
        if isinstance(topo, DistGraphTopology):
            return topo.out_neighbors(r)
        return topo.neighbors(r)

    def ins(r):
        if isinstance(topo, DistGraphTopology):
            return topo.in_neighbors(r)
        return topo.neighbors(r)

    return outs, ins


def neighbor_alltoall(comm, sendblocks: dict):
    """sendblocks[r] = (n_out_neighbors(r), ...) blocks, one per out
    neighbor in order; returns recvblocks[r] likewise from in neighbors.
    """
    topo = comm.topo
    if topo is None:
        raise TopologyError("communicator has no topology")
    outs, ins = edge_fns(topo)

    # Mailbox delivery: a FIFO per (src, dst) pair — duplicate edges
    # (e.g. a periodic cart dimension of size 2 lists the same neighbor
    # twice) pair the k-th out-occurrence with the k-th in-occurrence,
    # the MPI position-wise matching; a plain dict would silently drop
    # all but the last duplicate's block.
    mail: dict[tuple[int, int], list] = {}
    for r in range(comm.size):
        blocks = sendblocks[r]
        for j, dst in enumerate(outs(r)):
            mail.setdefault((r, dst), []).append(blocks[j])
    out = {}
    for r in range(comm.size):
        got = []
        for src in ins(r):
            q = mail.get((src, r))
            if not q:
                # MPI semantics: every in-edge occurrence must have a
                # matching out-edge occurrence at the source; a silent
                # skip would misalign received blocks against
                # in-neighbor order.
                raise TopologyError(
                    f"rank {r} lists {src} as in-neighbor but rank "
                    f"{src} does not list {r} as out-neighbor (or edge "
                    f"multiplicities differ)"
                )
            got.append(q.pop(0))
        out[r] = torch.stack(
            [torch.as_tensor(b).to(comm.device) for b in got]
        ) if got else None
    return out


def hardware_fingerprint(procs=None) -> str:
    """Stable digest of the hardware topology a schedule was tuned on.

    Canonicalizes what changes a collective schedule's cost surface —
    rank count, the host-group and slice-group partition shapes, and
    the device kinds (the platform: ``gpu`` or ``cpu``) — with the JAX
    package's canonical JSON and hash, so the tuned schedule cache is
    keyed to "machines shaped like this": a cache warmed on the card is
    never replayed on the CPU, nor one warmed on a TPU on the card.
    """
    from ..runtime import mesh

    if procs is None:
        procs = mesh.live_procs()
    canon = {
        "nranks": len(procs),
        "hosts": sorted(len(g) for g in mesh.hosts_of(procs).values()),
        "slices": sorted(len(g) for g in mesh.slices_of(procs).values()),
        "kinds": sorted({p.platform for p in procs}),
    }
    blob = json.dumps(canon, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]
