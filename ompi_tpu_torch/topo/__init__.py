"""Process topologies (port of ``ompi_tpu/topo``): cartesian, graph and
distributed graph, the neighborhood collectives, and the hardware
fingerprint of the schedule cache."""

from .topology import (CartTopology, DistGraphTopology, GraphTopology,
                       cart_create, dims_create, dist_graph_create,
                       graph_create, hardware_fingerprint)

__all__ = [
    "CartTopology", "GraphTopology", "DistGraphTopology", "dims_create",
    "cart_create", "graph_create", "dist_graph_create",
    "hardware_fingerprint",
]
