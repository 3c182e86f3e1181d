"""Topology (the port has only the hardware fingerprint so far)."""

from .topology import hardware_fingerprint

__all__ = ["hardware_fingerprint"]
