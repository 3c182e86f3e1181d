"""Reduction operators (port of ``ompi_tpu/ops``)."""

from .device import reduce_local, reduce_ranks
from .op import (BAND, BOR, BXOR, LAND, LOR, LXOR, MAX, MAXLOC, MIN,
                 MINLOC, NO_OP, PREDEFINED, PROD, REPLACE, SUM, Op,
                 create_op, lookup)

__all__ = [
    "Op", "create_op", "lookup", "PREDEFINED", "SUM", "PROD", "MAX", "MIN",
    "LAND", "LOR", "LXOR", "BAND", "BOR", "BXOR", "MAXLOC", "MINLOC",
    "REPLACE", "NO_OP", "reduce_local", "reduce_ranks",
]
