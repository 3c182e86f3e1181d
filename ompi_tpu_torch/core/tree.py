"""Nested values (the p2p layer's payloads) walked leaf by leaf.

The JAX package walks a payload with ``jax.tree.leaves`` and moves it
with ``jax.device_put``, which map over nested tuples, lists and dicts
(dicts in sorted key order) and skip ``None``. The port does the same
on its own: ``leaves`` lists the leaves, ``map_leaves`` rebuilds the
structure with ``fn`` applied to each leaf.
"""

from __future__ import annotations

from typing import Any, Callable


def leaves(value: Any) -> list:
    """Every leaf of ``value`` in ``jax.tree.leaves`` order."""
    if value is None:
        return []
    if isinstance(value, dict):
        return [leaf for k in sorted(value) for leaf in leaves(value[k])]
    if isinstance(value, (tuple, list)):
        return [leaf for v in value for leaf in leaves(v)]
    return [value]


def map_leaves(fn: Callable[[Any], Any], value: Any) -> Any:
    """``value`` with each leaf replaced by ``fn(leaf)``."""
    if value is None:
        return None
    if isinstance(value, dict):
        return type(value)((k, map_leaves(fn, v)) for k, v in value.items())
    if isinstance(value, (tuple, list)):
        return type(value)(map_leaves(fn, v) for v in value)
    return fn(value)
