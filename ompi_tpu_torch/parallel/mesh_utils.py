"""Multi-axis meshes of virtual ranks (port of
``ompi_tpu/parallel/mesh_utils.py``).

The JAX package builds a ``jax.sharding.Mesh`` whose named axes are the
communicator structure: each axis is a family of sub-communicators (all
ranks differing only along that axis). The port holds n virtual ranks
in one rank-major ``(n, ...)`` tensor, so a mesh here is the named axis
sizes over that leading axis: rank ``r`` sits at the row-major
coordinate of ``r`` in ``(d0, d1, ...)``, the JAX mesh's device order.

A collective over one axis (``Axis.apply``) moves that axis to the
front, folds the other axes into the payload after the collective's
own rank-structured axes, calls the ``coll/spmd`` function on the
``(k, ...)`` tensor, and restores the order.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from ..core.device import resolve_device
from ..core.errors import ArgumentError


def factorize(n: int, num_axes: int) -> tuple[int, ...]:
    """Split n devices into `num_axes` near-balanced power factors,
    favoring later axes (innermost = fastest-varying = most tightly
    coupled, where tp wants to live)."""
    dims = [1] * num_axes
    remaining = n
    i = num_axes - 1
    while remaining > 1:
        # Peel the smallest prime factor into axis i, round-robin from
        # the innermost axis outward.
        for p in (2, 3, 5, 7, 11, 13):
            if remaining % p == 0:
                dims[i] *= p
                remaining //= p
                break
        else:  # remaining is prime (> 13): absorb it whole
            dims[i] *= remaining
            remaining = 1
        i = i - 1 if i > 0 else num_axes - 1
    return tuple(dims)


class Mesh:
    """Named axis sizes (major to minor) over n = their product virtual
    ranks on one device."""

    def __init__(self, axis_sizes: dict[str, int],
                 device: torch.device) -> None:
        self.shape = dict(axis_sizes)
        self.axis_names = tuple(axis_sizes)
        self.dims = tuple(axis_sizes.values())
        self.size = math.prod(self.dims)
        self.device = torch.device(device)
        self._coords: Optional[torch.Tensor] = None

    def axis(self, name: str) -> "Axis":
        if name not in self.shape:
            raise ArgumentError(f"mesh {self.shape} has no axis {name!r}")
        return Axis(self, name)

    def coords(self) -> torch.Tensor:
        """(n, axes) int64: each rank's coordinate along every axis."""
        if self._coords is None:
            idx = torch.arange(self.size, device=self.device)
            out = []
            for d in reversed(self.dims):
                out.append(idx % d)
                idx = idx // d
            self._coords = torch.stack(out[::-1], dim=1)
        return self._coords

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


class Axis:
    """One named axis of a :class:`Mesh`: the sub-communicators of the
    ranks that differ only along it."""

    def __init__(self, mesh: Mesh, name: str) -> None:
        self.mesh = mesh
        self.name = name
        self.pos = mesh.axis_names.index(name)
        self.size = mesh.dims[self.pos]

    def index(self) -> torch.Tensor:
        """(n,) int64: each rank's coordinate along this axis (the JAX
        package's ``lax.axis_index``)."""
        return self.mesh.coords()[:, self.pos]

    def apply(self, fn: Callable[[torch.Tensor], torch.Tensor],
              x: torch.Tensor, lead_in: int = 0,
              lead_out: int = 0) -> torch.Tensor:
        """Run the rank-axis collective ``fn`` (rank-major ``(k, ...)``
        in and out) along this axis of the rank-major ``(n, ...)`` x.
        ``lead_in``/``lead_out``: how many axes of fn's per-rank input
        and output are themselves indexed by rank (1 for the second axis
        of an alltoall's or a reduce-scatter's input, of an allgather's
        or an alltoall's output); the other mesh axes are folded in
        after them."""
        mesh = self.mesh
        dims, m, k = mesh.dims, len(mesh.dims), self.size
        if x.shape[0] != mesh.size:
            raise ArgumentError(f"rank-major tensor of {x.shape[0]} rows on "
                                f"a mesh of {mesh.size} ranks")
        v = x.reshape(dims + tuple(x.shape[1:])).movedim(self.pos, 0)
        others = tuple(v.shape[1:m])
        v = v.reshape((k, math.prod(others)) + tuple(v.shape[m:]))
        out = fn(v.movedim(1, 1 + lead_in))
        out = out.movedim(1 + lead_out, 1)
        out = out.reshape((k,) + others + tuple(out.shape[2:]))
        return out.movedim(0, self.pos).reshape(
            (mesh.size,) + tuple(out.shape[m:]))


def rank_axis(x: torch.Tensor, axis: Optional[Axis] = None) -> Axis:
    """``axis``, or the one axis of a 1-D mesh over x's leading rank
    axis (a strategy called on its own, as under a one-axis
    ``shard_map``)."""
    if axis is not None:
        return axis
    return Axis(Mesh({"ranks": x.shape[0]}, x.device), "ranks")


def make_mesh(axis_sizes: dict[str, int], nranks: Optional[int] = None,
              device: Optional[torch.device] = None) -> Mesh:
    """A mesh with the given axis sizes (major to minor) over ``nranks``
    virtual ranks (default: their product); the sizes must multiply to
    it. It lives on ``cuda:0`` unless ``device`` says otherwise."""
    total = math.prod(axis_sizes.values())
    if nranks is not None and total != nranks:
        raise ArgumentError(
            f"mesh axes {axis_sizes} need {total} ranks, have {nranks}")
    return Mesh(axis_sizes, resolve_device(device))


def auto_mesh(nranks: int, axes: Sequence[str] = ("dp", "tp"),
              device: Optional[torch.device] = None) -> Mesh:
    """Factorize the rank count over the requested axis names."""
    dims = factorize(nranks, len(axes))
    return make_mesh(dict(zip(axes, dims)), nranks, device)
