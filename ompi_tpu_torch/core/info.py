"""MPI_Info equivalent: string key/value hint dictionaries.

Reference: ompi/info/info.c. A thin, case-preserving dict with the MPI
surface (get/set/delete/dup/nkeys) — Pythonic but API-compatible in spirit.

The PyTorch port's own copy of ``ompi_tpu/core/info.py``.
"""

from __future__ import annotations

from typing import Iterator, Optional


class Info:
    def __init__(self, initial: Optional[dict] = None) -> None:
        self._d: dict[str, str] = dict(initial or {})

    def set(self, key: str, value: str) -> None:
        self._d[str(key)] = str(value)

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self._d.get(key, default)

    def delete(self, key: str) -> None:
        self._d.pop(key, None)

    def dup(self) -> "Info":
        return Info(self._d)

    @property
    def nkeys(self) -> int:
        return len(self._d)

    def keys(self) -> list[str]:
        return list(self._d)

    def items(self) -> Iterator[tuple[str, str]]:
        return iter(self._d.items())

    def __contains__(self, key: str) -> bool:
        return key in self._d

    def __repr__(self) -> str:
        return f"Info({self._d!r})"


INFO_NULL = Info()
