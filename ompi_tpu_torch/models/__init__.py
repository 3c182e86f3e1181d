"""Demonstration models exercising the full parallelism stack (port of
``ompi_tpu/models``)."""

from . import transformer

__all__ = ["transformer"]
