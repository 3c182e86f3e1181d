"""Collective framework and components (port of ``ompi_tpu/coll``).

``coll.quant`` (the quantized wire: its codec, rings, error bound and
error feedback) is importable from here, as in the JAX package.
"""

from . import quant

__all__ = ["quant"]
