"""Collective framework and components (port of ``ompi_tpu/coll``)."""
