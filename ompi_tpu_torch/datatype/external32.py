"""external32: the canonical interchange representation.

Port of ``ompi_tpu/datatype/external32.py`` (reference: ompi/datatype
external32 support, test/datatype/external32.c — MPI's defined
big-endian, fixed-size wire format so heterogeneous systems
interoperate). Pack here = convertor pack + big-endian byteswap per
primitive; sizes are already IEEE/two's-complement on every platform
the port runs on, so only byte order changes.
"""

from __future__ import annotations

import numpy as np

from ..core.errors import DatatypeError
from .convertor import Convertor
from .datatype import lookup


def _uniform_dtype(datatype):
    dts = {e.dtype for e in datatype.elements}
    if len(dts) != 1:
        raise DatatypeError(
            "external32 pack of mixed-primitive datatypes: pack each "
            "struct field separately"
        )
    (d,) = dts
    return d


def pack_external32(buffer, datatype, count: int) -> bytes:
    datatype = lookup(datatype).commit()
    native = Convertor(datatype, count).prepare_for_send(buffer).pack()
    prim = _uniform_dtype(datatype)
    arr = np.frombuffer(native, dtype=prim)
    return arr.astype(prim.newbyteorder(">")).tobytes()


def unpack_external32(data: bytes, buffer, datatype, count: int) -> None:
    datatype = lookup(datatype).commit()
    prim = _uniform_dtype(datatype)
    arr = np.frombuffer(data, dtype=prim.newbyteorder(">"))
    native = arr.astype(prim).tobytes()
    conv = Convertor(datatype, count).prepare_for_recv(buffer)
    conv.unpack(native)
    if conv.remaining:
        raise DatatypeError(f"short unpack: {conv.remaining} bytes missing")
