"""Nested values (payloads, gradient pytrees) walked leaf by leaf.

The JAX package walks a value with ``jax.tree`` and ``jax.tree_util``,
which map over nested tuples, lists and dicts (dicts in SORTED key
order) and skip ``None``. The port does the same on its own:

- ``leaves`` lists the leaves, ``map_leaves`` rebuilds the structure
  with ``fn`` applied to each leaf;
- ``flatten`` / ``flatten_with_path`` return the leaves (with their key
  paths) and a ``TreeDef``; ``unflatten(treedef, leaves)`` rebuilds;
- ``keystr`` renders a key path as ``jax.tree_util.keystr`` does:
  ``['name']`` for a dict key, ``[i]`` for a sequence index, so a
  gradient leaf has the same name in both packages. An unflattened
  dict has its keys in sorted order, as ``jax.tree.unflatten`` gives.

``torch.utils._pytree`` is not used: it keeps a dict's insertion order,
and the order decides the bucket plan, the leaf names and the digests.
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


class DictKey:
    """A dict entry on a key path (renders ``[key!r]``)."""

    __slots__ = ("key",)

    def __init__(self, key: Any) -> None:
        self.key = key

    def __str__(self) -> str:
        return f"[{self.key!r}]"


class SequenceKey:
    """A tuple or list element on a key path (renders ``[idx]``)."""

    __slots__ = ("idx",)

    def __init__(self, idx: int) -> None:
        self.idx = idx

    def __str__(self) -> str:
        return f"[{self.idx}]"


def keystr(path: tuple) -> str:
    """``jax.tree_util.keystr`` of a key path."""
    return "".join(str(k) for k in path)


class TreeDef:
    """The structure of a flattened value: its containers with a
    placeholder where each leaf was."""

    __slots__ = ("_skeleton", "num_leaves")

    def __init__(self, skeleton: Any, num_leaves: int) -> None:
        self._skeleton = skeleton
        self.num_leaves = num_leaves


_LEAF = object()  # a leaf's place in a TreeDef's skeleton


def flatten_with_path(value: Any) -> tuple[list, TreeDef]:
    """``([(path, leaf), ...], treedef)`` in ``jax.tree`` order."""
    out: list = []

    def walk(v: Any, path: tuple) -> Any:
        if v is None:
            return None
        if isinstance(v, dict):
            skel = {k: None for k in v}
            for k in sorted(v):
                skel[k] = walk(v[k], path + (DictKey(k),))
            return type(v)(skel) if type(v) is not dict else skel
        if isinstance(v, (tuple, list)):
            return type(v)(walk(x, path + (SequenceKey(i),))
                           for i, x in enumerate(v))
        out.append((path, v))
        return _LEAF

    skel = walk(value, ())
    return out, TreeDef(skel, len(out))


def flatten(value: Any) -> tuple[list, TreeDef]:
    """``(leaves, treedef)`` as ``jax.tree.flatten`` gives them."""
    pairs, treedef = flatten_with_path(value)
    return [leaf for _, leaf in pairs], treedef


def unflatten(treedef: TreeDef, values: list) -> Any:
    """Rebuild ``treedef``'s structure around ``values`` (in flatten
    order)."""
    values = list(values)
    if len(values) != treedef.num_leaves:
        raise ValueError(f"unflatten: {len(values)} leaves for a tree of "
                         f"{treedef.num_leaves}")
    it = iter(values)

    def build(skel: Any) -> Any:
        if skel is _LEAF:
            return next(it)
        if skel is None:
            return None
        if isinstance(skel, dict):
            # rebuilt in sorted key order, as jax.tree.unflatten does
            got = {k: build(skel[k]) for k in sorted(skel)}
            return got if type(skel) is dict else type(skel)(got)
        return type(skel)(build(x) for x in skel)

    return build(treedef._skeleton)
