"""MPI-style datatypes: architecture-neutral memory-layout descriptions.

Port of ``ompi_tpu/datatype/datatype.py`` (reference: opal/datatype —
the engine; ompi/datatype — the MPI constructors,
ompi_datatype_create_*.c). A datatype describes *where the bytes live*:
a typemap of (byte_offset, element_dtype) pairs with an overall extent,
built by the MPI constructor algebra (contiguous / vector / indexed /
struct / subarray / darray / resized).

Design notes vs the reference:
- The reference stores an optimized run-length description and walks it
  with a resumable state machine (opal_datatype_optimize.c,
  dt_stack_t). Here the canonical form is the *segment list*: merged
  (offset, nbytes) contiguous runs per element, computed once at
  commit() — the convertor (convertor.py) iterates it resumably, and
  the device path compiles it into gather/scatter index tensors.
- Heterogeneous-width conversion (the reference's other convertor job)
  reduces to numpy dtype casting + external32 byte order (external32.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..core.errors import DatatypeError

ORDER_C = "C"
ORDER_FORTRAN = "F"

# Distribution kinds for darray (MPI_DISTRIBUTE_*).
DISTRIBUTE_NONE = "none"
DISTRIBUTE_BLOCK = "block"
DISTRIBUTE_CYCLIC = "cyclic"
DISTRIBUTE_DFLT_DARG = -1


@dataclasses.dataclass(frozen=True)
class _Element:
    """One primitive element in the typemap."""

    offset: int  # byte offset from the datatype origin
    dtype: np.dtype  # primitive numpy dtype


class Datatype:
    """An immutable memory-layout description."""

    def __init__(
        self,
        elements: Sequence[_Element],
        extent: int,
        *,
        lb: int = 0,
        name: str = "",
        envelope: Optional[tuple] = None,
    ) -> None:
        self._elements = tuple(elements)
        self._lb = lb
        self._extent = extent
        self.name = name
        # Constructor call reconstruction (MPI_Type_get_envelope/contents
        # — reference: ompi/datatype/ompi_datatype_args.c).
        self.envelope = envelope or ("named", name)
        self._committed = False
        self._segments: Optional[tuple[tuple[int, int], ...]] = None

    # -- queries ----------------------------------------------------------

    @property
    def size(self) -> int:
        """True payload bytes per element (MPI_Type_size)."""
        return sum(e.dtype.itemsize for e in self._elements)

    @property
    def extent(self) -> int:
        """Span in memory between consecutive elements
        (MPI_Type_get_extent)."""
        return self._extent

    @property
    def lb(self) -> int:
        return self._lb

    @property
    def ub(self) -> int:
        return self._lb + self._extent

    @property
    def true_lb(self) -> int:
        return min((e.offset for e in self._elements), default=0)

    @property
    def true_extent(self) -> int:
        if not self._elements:
            return 0
        hi = max(e.offset + e.dtype.itemsize for e in self._elements)
        return hi - self.true_lb

    @property
    def is_contiguous(self) -> bool:
        segs = self.segments
        return (
            len(segs) <= 1
            and self.extent == self.size
        )

    @property
    def num_elements(self) -> int:
        return len(self._elements)

    # -- commit / segments -------------------------------------------------

    def commit(self) -> "Datatype":
        """Finalize: compute the merged segment list (the reference's
        opal_datatype_commit + optimize pass)."""
        if not self._committed:
            self._segments = self._merge_segments()
            self._committed = True
        return self

    def _merge_segments(self) -> tuple[tuple[int, int], ...]:
        # Typemap order, NOT memory order: MPI pack order is typemap
        # order (reference: opal_datatype_optimize.c merges only
        # consecutive typemap entries), and the device pack path
        # (_element_indices) walks the typemap too — sorting here would
        # silently reorder the packed stream for non-monotone typemaps.
        spans = [(e.offset, e.dtype.itemsize) for e in self._elements]
        merged: list[list[int]] = []
        for off, ln in spans:
            if merged and merged[-1][0] + merged[-1][1] == off:
                merged[-1][1] += ln
            else:
                merged.append([off, ln])
        return tuple((o, l) for o, l in merged)

    @property
    def segments(self) -> tuple[tuple[int, int], ...]:
        """(offset, nbytes) contiguous runs, merged, per element."""
        if self._segments is None:
            self._segments = self._merge_segments()
        return self._segments

    @property
    def elements(self) -> tuple[_Element, ...]:
        return self._elements

    # -- constructor algebra ----------------------------------------------

    def dup(self) -> "Datatype":
        return Datatype(
            self._elements, self._extent, lb=self._lb,
            name=f"{self.name}.dup", envelope=("dup", self),
        )

    def contiguous(self, count: int) -> "Datatype":
        return contiguous(count, self)

    def resized(self, lb: int, extent: int) -> "Datatype":
        return Datatype(
            self._elements, extent, lb=lb,
            name=f"{self.name}.resized", envelope=("resized", self, lb, extent),
        )

    def __repr__(self) -> str:
        return (
            f"Datatype({self.name or 'derived'}, size={self.size}, "
            f"extent={self.extent}, nsegs={len(self.segments)})"
        )


# ---------------------------------------------------------------------------
# Named (predefined) datatypes
# ---------------------------------------------------------------------------

def _named(np_dtype, name: str) -> Datatype:
    dt = np.dtype(np_dtype)
    return Datatype(
        (
            _Element(0, dt),
        ),
        dt.itemsize,
        name=name,
    ).commit()


INT8 = _named(np.int8, "int8")
INT16 = _named(np.int16, "int16")
INT32 = _named(np.int32, "int32")
INT64 = _named(np.int64, "int64")
UINT8 = _named(np.uint8, "uint8")
UINT16 = _named(np.uint16, "uint16")
UINT32 = _named(np.uint32, "uint32")
UINT64 = _named(np.uint64, "uint64")
FLOAT16 = _named(np.float16, "float16")
FLOAT32 = _named(np.float32, "float32")
FLOAT64 = _named(np.float64, "float64")
COMPLEX64 = _named(np.complex64, "complex64")
COMPLEX128 = _named(np.complex128, "complex128")
BYTE = _named(np.uint8, "byte")
BOOL = _named(np.bool_, "bool")

# MPI-name aliases.
CHAR, SHORT, INT, LONG_LONG = INT8, INT16, INT32, INT64
FLOAT, DOUBLE = FLOAT32, FLOAT64

NAMED = {
    t.name: t
    for t in (
        INT8, INT16, INT32, INT64, UINT8, UINT16, UINT32, UINT64,
        FLOAT16, FLOAT32, FLOAT64, COMPLEX64, COMPLEX128, BYTE, BOOL,
    )
}


def from_numpy(np_dtype) -> Datatype:
    dt = np.dtype(np_dtype)
    got = NAMED.get(dt.name)
    if got is None:
        if dt.names:  # structured dtype -> struct datatype
            types = []
            displs = []
            lens = []
            for field in dt.names:
                fdt, off = dt.fields[field][:2]
                types.append(from_numpy(fdt))
                displs.append(off)
                lens.append(1)
            return struct(lens, displs, types).resized(0, dt.itemsize)
        raise DatatypeError(f"no named datatype for numpy {dt}")
    return got


def lookup(dt) -> Datatype:
    if isinstance(dt, Datatype):
        return dt
    if isinstance(dt, str):
        got = NAMED.get(dt)
        if got is None:
            raise DatatypeError(
                f"unknown datatype {dt!r}; known: {sorted(NAMED)}"
            )
        return got
    return from_numpy(dt)


# ---------------------------------------------------------------------------
# Derived-type constructors (reference: ompi_datatype_create_*.c)
# ---------------------------------------------------------------------------

def _replicate(base: Datatype, count: int, stride_bytes: int):
    """Yield base's elements replicated `count` times at stride."""
    for i in range(count):
        off = i * stride_bytes
        for e in base.elements:
            yield _Element(off + e.offset, e.dtype)


def contiguous(count: int, base) -> Datatype:
    base = lookup(base)
    if count < 0:
        raise DatatypeError(f"negative count {count}")
    return Datatype(
        tuple(_replicate(base, count, base.extent)),
        count * base.extent,
        name=f"contig({count},{base.name})",
        envelope=("contiguous", count, base),
    )


def vector(count: int, blocklength: int, stride: int, base) -> Datatype:
    """stride in *elements* (MPI_Type_vector)."""
    base = lookup(base)
    return hvector(count, blocklength, stride * base.extent, base)


def hvector(count: int, blocklength: int, stride_bytes: int, base
            ) -> Datatype:
    """stride in *bytes* (MPI_Type_create_hvector)."""
    base = lookup(base)
    elements = []
    for i in range(count):
        block_off = i * stride_bytes
        for e in _replicate(base, blocklength, base.extent):
            elements.append(_Element(block_off + e.offset, e.dtype))
    # MPI extent: from lb to ub of the spanned region.
    if count == 0 or blocklength == 0:
        extent = 0
    else:
        last_block = (count - 1) * stride_bytes
        extent = last_block + blocklength * base.extent
    return Datatype(
        tuple(elements),
        extent,
        name=f"hvector({count},{blocklength},{stride_bytes})",
        envelope=("hvector", count, blocklength, stride_bytes, base),
    )


def indexed(blocklengths: Sequence[int], displacements: Sequence[int],
            base) -> Datatype:
    """displacements in elements (MPI_Type_indexed)."""
    base = lookup(base)
    return hindexed(
        blocklengths, [d * base.extent for d in displacements], base
    )


def indexed_block(blocklength: int, displacements: Sequence[int],
                  base) -> Datatype:
    return indexed([blocklength] * len(displacements), displacements, base)


def hindexed(blocklengths: Sequence[int], byte_displacements: Sequence[int],
             base) -> Datatype:
    base = lookup(base)
    if len(blocklengths) != len(byte_displacements):
        raise DatatypeError("blocklengths/displacements length mismatch")
    elements = []
    ub = 0
    for bl, disp in zip(blocklengths, byte_displacements):
        for e in _replicate(base, bl, base.extent):
            elements.append(_Element(disp + e.offset, e.dtype))
        ub = max(ub, disp + bl * base.extent)
    return Datatype(
        tuple(elements),
        ub,
        name="hindexed",
        envelope=("hindexed", tuple(blocklengths),
                  tuple(byte_displacements), base),
    )


def struct(blocklengths: Sequence[int], byte_displacements: Sequence[int],
           types: Sequence) -> Datatype:
    """MPI_Type_create_struct."""
    if not (len(blocklengths) == len(byte_displacements) == len(types)):
        raise DatatypeError("struct argument length mismatch")
    elements = []
    ub = 0
    for bl, disp, ty in zip(blocklengths, byte_displacements, types):
        ty = lookup(ty)
        for e in _replicate(ty, bl, ty.extent):
            elements.append(_Element(disp + e.offset, e.dtype))
        ub = max(ub, disp + bl * ty.extent)
    return Datatype(
        tuple(elements),
        ub,
        name="struct",
        envelope=("struct", tuple(blocklengths),
                  tuple(byte_displacements), tuple(types)),
    )


def subarray(sizes: Sequence[int], subsizes: Sequence[int],
             starts: Sequence[int], base, order: str = ORDER_C) -> Datatype:
    """MPI_Type_create_subarray: an n-D slab out of an n-D array."""
    base = lookup(base)
    ndim = len(sizes)
    if not (len(subsizes) == len(starts) == ndim):
        raise DatatypeError("subarray argument length mismatch")
    for d in range(ndim):
        if starts[d] + subsizes[d] > sizes[d]:
            raise DatatypeError(
                f"subarray dim {d}: start {starts[d]} + sub {subsizes[d]} "
                f"> size {sizes[d]}"
            )
    if order == ORDER_FORTRAN:
        sizes = list(reversed(sizes))
        subsizes = list(reversed(subsizes))
        starts = list(reversed(starts))
    # Row-major strides in elements of base.
    strides = [1] * ndim
    for d in range(ndim - 2, -1, -1):
        strides[d] = strides[d + 1] * sizes[d + 1]
    elements = []
    idx = [0] * ndim

    def rec(d: int, elem_off: int):
        if d == ndim - 1:
            start = elem_off + starts[d]
            for j in range(subsizes[d]):
                byte_off = (start + j) * base.extent
                for e in base.elements:
                    elements.append(_Element(byte_off + e.offset, e.dtype))
            return
        for j in range(subsizes[d]):
            rec(d + 1, elem_off + (starts[d] + j) * strides[d])

    rec(0, 0)
    total = 1
    for s in sizes:
        total *= s
    return Datatype(
        tuple(elements),
        total * base.extent,
        name=f"subarray{tuple(subsizes)}of{tuple(sizes)}",
        envelope=("subarray", tuple(sizes), tuple(subsizes),
                  tuple(starts), base, order),
    )


def darray(size: int, rank: int, gsizes: Sequence[int],
           distribs: Sequence[str], dargs: Sequence[int],
           psizes: Sequence[int], base, order: str = ORDER_C) -> Datatype:
    """MPI_Type_create_darray: this rank's piece of a block/cyclic
    distributed global array (reference:
    ompi/datatype/ompi_datatype_create_darray.c)."""
    base = lookup(base)
    ndim = len(gsizes)
    total_procs = 1
    for p in psizes:
        total_procs *= p
    if total_procs != size:
        raise DatatypeError(f"psizes product {total_procs} != size {size}")
    # Rank coordinates in the process grid (C order).
    coords = []
    r = rank
    for d in range(ndim):
        trailing = 1
        for p in psizes[d + 1:]:
            trailing *= p
        coords.append(r // trailing)
        r %= trailing

    # Per-dim index lists owned by this rank.
    def dim_indices(d: int) -> list[int]:
        g, dist, darg, p, c = (
            gsizes[d], distribs[d], dargs[d], psizes[d], coords[d]
        )
        if dist == DISTRIBUTE_NONE or p == 1:
            return list(range(g))
        if dist == DISTRIBUTE_BLOCK:
            bsize = darg if darg != DISTRIBUTE_DFLT_DARG else (g + p - 1) // p
            start = c * bsize
            return list(range(start, min(start + bsize, g)))
        if dist == DISTRIBUTE_CYCLIC:
            bsize = darg if darg != DISTRIBUTE_DFLT_DARG else 1
            out = []
            blk = 0
            while True:
                base_i = (blk * p + c) * bsize
                if base_i >= g:
                    break
                out.extend(range(base_i, min(base_i + bsize, g)))
                blk += 1
            return out
        raise DatatypeError(f"unknown distribution {dist}")

    dims = [dim_indices(d) for d in range(ndim)]
    if order == ORDER_FORTRAN:
        gs = list(reversed(gsizes))
        dims = list(reversed(dims))
    else:
        gs = list(gsizes)
    strides = [1] * ndim
    for d in range(ndim - 2, -1, -1):
        strides[d] = strides[d + 1] * gs[d + 1]
    elements = []

    def rec(d: int, elem_off: int):
        if d == ndim:
            byte_off = elem_off * base.extent
            for e in base.elements:
                elements.append(_Element(byte_off + e.offset, e.dtype))
            return
        for i in dims[d]:
            rec(d + 1, elem_off + i * strides[d])

    rec(0, 0)
    total = 1
    for g in gs:
        total *= g
    return Datatype(
        tuple(elements),
        total * base.extent,
        name=f"darray(rank{rank})",
        envelope=("darray", size, rank, tuple(gsizes), tuple(distribs),
                  tuple(dargs), tuple(psizes), base, order),
    )
