"""The convertor: resumable pack/unpack between user layouts and packed
streams.

Port of ``ompi_tpu/datatype/convertor.py`` (reference: opal_convertor,
opal/datatype/opal_convertor.h:140-293 — pack/unpack/position/
prepare_for_send/prepare_for_recv; the resumable iteration stack in
opal_datatype_fake_stack.c). Two execution tiers:

1. **host**: a walk over the committed segment table with numpy slicing
   (the JAX package's fallback when its native C++ engine is absent;
   the port has no native engine yet).
2. **device** (torch tensors): pack is a gather, unpack a scatter, each
   an ``index_select``/``index_copy`` on a flat view with int64 element
   indices, kept on the tensor's device (the convertor equivalent of
   keeping buffers HBM-resident instead of the reference's CUDA staging
   path, opal_convertor.h:50-57 CONVERTOR_CUDA flags).

Position semantics match the reference: the packed stream of
(count × datatype) is a deterministic byte sequence; ``set_position(p)``
seeks to any byte boundary, and pack/unpack chunks of arbitrary sizes
reassemble exactly (reference test: test/datatype/ddt_pack.c,
position.c).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.counters import SPC
from ..core.errors import DatatypeError, TruncationError
from .datatype import Datatype, lookup


def _span_bytes(datatype: Datatype, count: int) -> int:
    """Bytes of storage that ``count`` x ``datatype`` spans from the
    buffer's start."""
    if not count:
        return 0
    return ((count - 1) * datatype.extent + datatype.true_lb
            + datatype.true_extent)


class Convertor:
    """Pack/unpack engine bound to (datatype, count) and a user buffer."""

    def __init__(self, datatype, count: int) -> None:
        self.datatype = lookup(datatype).commit()
        self.count = int(count)
        if self.datatype.size == 0 and self.count > 0:
            raise DatatypeError("cannot convert an empty datatype")
        self._buffer: Optional[np.ndarray] = None  # raw byte view
        self._packed_pos = 0

    # -- binding ----------------------------------------------------------

    @property
    def total_bytes(self) -> int:
        return self.datatype.size * self.count

    def _bind(self, buffer: np.ndarray, *, writable: bool) -> None:
        arr = np.asarray(buffer)
        if writable and not arr.flags.writeable:
            raise DatatypeError("receive buffer is not writable")
        if not arr.flags.c_contiguous:
            # The datatype describes the layout; the underlying storage
            # region itself must be addressable as flat bytes.
            raise DatatypeError(
                "convertor needs a C-contiguous storage region (the "
                "datatype encodes the non-contiguity)"
            )
        raw = arr.view(np.uint8).reshape(-1)
        need = _span_bytes(self.datatype, self.count)
        if raw.nbytes < need:
            raise TruncationError(
                f"buffer has {raw.nbytes} bytes; datatype x{self.count} "
                f"spans {need}"
            )
        self._buffer = raw
        self._packed_pos = 0

    def prepare_for_send(self, buffer) -> "Convertor":
        self._bind(buffer, writable=False)
        return self

    def prepare_for_recv(self, buffer) -> "Convertor":
        self._bind(buffer, writable=True)
        return self

    # -- position ---------------------------------------------------------

    @property
    def position(self) -> int:
        return self._packed_pos

    def set_position(self, packed_byte_offset: int) -> None:
        if not 0 <= packed_byte_offset <= self.total_bytes:
            raise DatatypeError(
                f"position {packed_byte_offset} outside packed size "
                f"{self.total_bytes}"
            )
        self._packed_pos = packed_byte_offset

    @property
    def remaining(self) -> int:
        return self.total_bytes - self._packed_pos

    # -- pack -------------------------------------------------------------

    def pack(self, max_bytes: Optional[int] = None) -> bytes:
        """Pack up to max_bytes from the current position; advances."""
        if self._buffer is None:
            raise DatatypeError("prepare_for_send first")
        max_bytes = self.remaining if max_bytes is None else min(
            int(max_bytes), self.remaining
        )
        if max_bytes <= 0:
            return b""
        out = np.empty(max_bytes, np.uint8)
        done = self._py_walk(out, max_bytes, packing=True)
        SPC.record("convertor_pack_python_bytes", done)
        self._packed_pos += done
        return out[:done].tobytes()

    def unpack(self, data: bytes) -> int:
        """Consume packed bytes into the bound buffer; advances; returns
        bytes consumed."""
        if self._buffer is None:
            raise DatatypeError("prepare_for_recv first")
        src = np.frombuffer(data, np.uint8)
        max_bytes = min(src.nbytes, self.remaining)
        if src.nbytes > self.remaining:
            raise TruncationError(
                f"{src.nbytes} packed bytes exceed remaining "
                f"{self.remaining} (MPI_ERR_TRUNCATE)"
            )
        if max_bytes == 0:
            return 0
        done = self._py_walk(src, max_bytes, packing=False)
        SPC.record("convertor_unpack_python_bytes", done)
        self._packed_pos += done
        return int(done)

    # -- the walk ---------------------------------------------------------

    def _py_walk(self, stream: np.ndarray, max_bytes: int,
                 packing: bool) -> int:
        dt = self.datatype
        segs = dt.segments
        elem_size = dt.size
        pos = self._packed_pos
        elem = pos // elem_size
        rem = pos % elem_size
        seg = 0
        while seg < len(segs) and rem >= segs[seg][1]:
            rem -= segs[seg][1]
            seg += 1
        moved = 0
        buf = self._buffer
        while moved < max_bytes and elem < self.count:
            ebase = elem * dt.extent
            while seg < len(segs) and moved < max_bytes:
                off, seg_len = segs[seg]
                avail = seg_len - rem
                start = ebase + off + rem
                ln = min(avail, max_bytes - moved)
                if packing:
                    stream[moved:moved + ln] = buf[start:start + ln]
                else:
                    buf[start:start + ln] = stream[moved:moved + ln]
                moved += ln
                if ln < avail:
                    return moved
                rem = 0
                seg += 1
            if seg == len(segs):
                seg = 0
                elem += 1
        return moved


# ---------------------------------------------------------------------------
# Whole-buffer conveniences (the common non-resumable case)
# ---------------------------------------------------------------------------

def pack(buffer, datatype, count: int) -> bytes:
    return Convertor(datatype, count).prepare_for_send(buffer).pack()


def unpack(data: bytes, buffer, datatype, count: int) -> None:
    conv = Convertor(datatype, count).prepare_for_recv(buffer)
    conv.unpack(data)
    if conv.remaining:
        raise DatatypeError(
            f"short unpack: {conv.remaining} bytes missing"
        )


# ---------------------------------------------------------------------------
# Device tier: gather/scatter plans for torch tensors
# ---------------------------------------------------------------------------

def _element_indices(datatype: Datatype, count: int,
                     itemsize: int) -> np.ndarray:
    """Linear element indices (in units of itemsize) of the packed
    order, as int64: int32 would wrap past 2**31 elements. Requires a
    uniform primitive dtype."""
    dts = {e.dtype for e in datatype.elements}
    if len(dts) != 1:
        raise DatatypeError(
            "device convertor needs a uniform primitive dtype; "
            f"got {sorted(str(d) for d in dts)}"
        )
    (prim,) = dts
    if prim.itemsize != itemsize:
        raise DatatypeError(
            f"buffer itemsize {itemsize} != datatype primitive "
            f"{prim.itemsize}"
        )
    per_elem = []
    for e in datatype.elements:
        if e.offset % itemsize:
            raise DatatypeError("unaligned element offset for device path")
        per_elem.append(e.offset // itemsize)
    if datatype.extent % itemsize:
        raise DatatypeError("unaligned extent for device path")
    stride = datatype.extent // itemsize
    base = np.asarray(per_elem, np.int64)
    return (
        np.arange(count, dtype=np.int64)[:, None] * stride + base[None, :]
    ).reshape(-1)


#: (layout, count, itemsize, device) -> the packed order's element
#: indices (int64) on that device
_device_plan_cache: dict[tuple, torch.Tensor] = {}


def _structural_key(datatype: Datatype) -> tuple:
    """Layout-identity key: two datatypes with the same typemap and
    extent share a plan; id() would alias a dead datatype's plan onto a
    new object reusing its address."""
    return (
        tuple((e.offset, str(e.dtype)) for e in datatype.elements),
        datatype.extent,
        datatype.lb,
    )


def _plan(datatype: Datatype, count: int, x: torch.Tensor) -> torch.Tensor:
    """The element indices of ``count`` x ``datatype`` over ``x``'s
    storage, on ``x``'s device. A tensor shorter than the layout spans
    raises, as a short host buffer does (an index past the end would be
    a device-side fault on a card)."""
    size = x.element_size()
    need = _span_bytes(datatype, count)
    if x.numel() * size < need:
        raise TruncationError(
            f"tensor has {x.numel() * size} bytes; datatype x{count} "
            f"spans {need}"
        )
    key = (_structural_key(datatype), count, size, str(x.device))
    idx = _device_plan_cache.get(key)
    if idx is None:
        idx = _device_plan_cache[key] = torch.from_numpy(
            _element_indices(datatype, count, size)).to(x.device)
    return idx


def pack_device(x, datatype, count: int) -> torch.Tensor:
    """Gather a non-contiguous layout out of a tensor into a packed
    tensor on the same device."""
    datatype = lookup(datatype).commit()
    arr = torch.as_tensor(x)
    idx = _plan(datatype, count, arr)
    SPC.record("convertor_pack_device_bytes",
               idx.numel() * arr.element_size())
    return arr.reshape(-1).index_select(0, idx)


def unpack_device(packed, out_template, datatype, count: int
                  ) -> torch.Tensor:
    """Scatter a packed tensor into the non-contiguous layout of
    ``out_template`` (returns a new tensor; the template is unchanged,
    as in the JAX package)."""
    datatype = lookup(datatype).commit()
    tmpl = torch.as_tensor(out_template)
    idx = _plan(datatype, count, tmpl)
    SPC.record("convertor_unpack_device_bytes",
               idx.numel() * tmpl.element_size())
    flat = torch.as_tensor(packed, device=tmpl.device).reshape(-1)
    return tmpl.reshape(-1).index_copy(0, idx, flat).reshape(tmpl.shape)
