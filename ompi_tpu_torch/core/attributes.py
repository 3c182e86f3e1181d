"""Keyval attribute system for communicators/windows/datatypes.

Reference: ompi/attribute/attribute.c — keyvals with copy/delete callbacks
invoked on dup/free. Pythonic: keyvals are integer handles into a registry
holding the callbacks; objects mix in `HasAttributes`.

The PyTorch port's own copy of ``ompi_tpu/core/attributes.py``.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Optional

CopyFn = Callable[[Any, int, Any], tuple[bool, Any]]  # (obj, keyval, val) -> (copy?, newval)
DeleteFn = Callable[[Any, int, Any], None]

_counter = itertools.count(1)
_lock = threading.Lock()
_keyvals: dict[int, tuple[Optional[CopyFn], Optional[DeleteFn], Any]] = {}


def create_keyval(
    copy_fn: Optional[CopyFn] = None,
    delete_fn: Optional[DeleteFn] = None,
    extra_state: Any = None,
) -> int:
    with _lock:
        kv = next(_counter)
        _keyvals[kv] = (copy_fn, delete_fn, extra_state)
        return kv


def free_keyval(keyval: int) -> None:
    with _lock:
        _keyvals.pop(keyval, None)


class HasAttributes:
    """Mixin for objects carrying keyval attributes."""

    def _attrs(self) -> dict[int, Any]:
        d = getattr(self, "_attributes", None)
        if d is None:
            d = {}
            self._attributes = d
        return d

    def set_attr(self, keyval: int, value: Any) -> None:
        if keyval not in _keyvals:
            raise KeyError(f"unknown keyval {keyval}")
        self.delete_attr(keyval)
        self._attrs()[keyval] = value

    def get_attr(self, keyval: int) -> tuple[bool, Any]:
        d = self._attrs()
        if keyval in d:
            return True, d[keyval]
        return False, None

    def delete_attr(self, keyval: int) -> None:
        d = self._attrs()
        if keyval in d:
            val = d.pop(keyval)
            entry = _keyvals.get(keyval)
            if entry and entry[1] is not None:
                entry[1](self, keyval, val)

    def copy_attrs_to(self, other: "HasAttributes") -> None:
        """Invoked on dup: run copy callbacks per keyval."""
        for kv, val in list(self._attrs().items()):
            entry = _keyvals.get(kv)
            if entry is None:
                continue
            copy_fn = entry[0]
            if copy_fn is None:
                continue  # MPI_KEYVAL default: do not copy
            do_copy, newval = copy_fn(self, kv, val)
            if do_copy:
                other._attrs()[kv] = newval

    def free_attrs(self) -> None:
        for kv in list(self._attrs()):
            self.delete_attr(kv)
