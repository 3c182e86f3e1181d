"""Datatype engine (port of ``ompi_tpu/datatype``; reference:
opal/datatype + ompi/datatype)."""

from .convertor import (
    Convertor,
    pack,
    pack_device,
    unpack,
    unpack_device,
)
from .datatype import (
    BOOL,
    BYTE,
    COMPLEX64,
    COMPLEX128,
    DISTRIBUTE_BLOCK,
    DISTRIBUTE_CYCLIC,
    DISTRIBUTE_DFLT_DARG,
    DISTRIBUTE_NONE,
    FLOAT16,
    FLOAT32,
    FLOAT64,
    INT8,
    INT16,
    INT32,
    INT64,
    NAMED,
    ORDER_C,
    ORDER_FORTRAN,
    UINT8,
    UINT16,
    UINT32,
    UINT64,
    Datatype,
    contiguous,
    darray,
    from_numpy,
    hindexed,
    hvector,
    indexed,
    indexed_block,
    lookup,
    struct,
    subarray,
    vector,
)
from .external32 import pack_external32, unpack_external32

__all__ = [
    "Convertor", "pack", "pack_device", "unpack", "unpack_device",
    "BOOL", "BYTE", "COMPLEX64", "COMPLEX128", "DISTRIBUTE_BLOCK",
    "DISTRIBUTE_CYCLIC", "DISTRIBUTE_DFLT_DARG", "DISTRIBUTE_NONE",
    "FLOAT16", "FLOAT32", "FLOAT64", "INT8", "INT16", "INT32", "INT64",
    "NAMED", "ORDER_C", "ORDER_FORTRAN", "UINT8", "UINT16", "UINT32",
    "UINT64", "Datatype", "contiguous", "darray", "from_numpy",
    "hindexed", "hvector", "indexed", "indexed_block", "lookup",
    "struct", "subarray", "vector", "pack_external32",
    "unpack_external32",
]
