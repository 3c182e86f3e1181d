"""Inter-rank transfer layer (port of ``ompi_tpu/btl``; reference:
opal/mca/btl). The port has the in-process components: ``self``,
``ici`` and the disabled ``template`` test double."""

from .framework import BTL, Bml, BtlComponent
from . import template  # noqa: F401 - register the component

__all__ = ["BTL", "Bml", "BtlComponent", "template"]
