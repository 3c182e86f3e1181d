"""Component/framework registry with priority selection.

TPU-native equivalent of Open MPI's MCA base
(reference: opal/mca/base/mca_base_framework.h:61-138 lifecycle,
mca_base_component_find.c, mca_base_components_select.c,
ompi/mca/coll/base/coll_base_comm_select.c:110-152 priority merge).

A *framework* is a named extension point ("coll", "pml", "btl", "osc", ...).
A *component* is a pluggable implementation registered with the framework.
Selection honors the reference's user-filter syntax: the framework-level
config var (e.g. ``coll = tuned,basic`` or ``coll = ^sm``) includes or
excludes components; priority ints (each component auto-registers a
``<framework>_<component>_priority`` var) pick winners.

Two selection modes mirror the reference:
- ``select_one``: exactly one winner (PML-style, pml.h:40-47).
- ``select_all``: all available components sorted by priority (coll-style;
  the caller merges per-function tables as coll_base_comm_select does).

The PyTorch port's own copy of ``ompi_tpu/core/component.py``.
"""

from __future__ import annotations

import threading
from typing import Any

from . import config
from .errors import ComponentError
from .logging import get_logger

logger = get_logger("mca")


class Component:
    """Base class for framework components.

    Subclasses set ``NAME`` and ``PRIORITY`` and may override
    ``available(**ctx)`` (can this component run in this context? —
    the reference's component_query) and ``open()/close()`` lifecycle.
    """

    NAME: str = ""
    PRIORITY: int = 0
    DESCRIPTION: str = ""

    def __init__(self, framework: "Framework") -> None:
        self.framework = framework
        self._prio_var = config.register(
            framework.name,
            self.NAME,
            "priority",
            type=int,
            default=self.PRIORITY,
            description=f"Selection priority of {framework.name}/{self.NAME}",
        )
        self.opened = False

    @property
    def priority(self) -> int:
        return self._prio_var.value

    def available(self, **ctx: Any) -> bool:
        """Can this component serve the given context (e.g. a communicator)?"""
        return True

    def open(self) -> None:
        self.opened = True

    def close(self) -> None:
        self.opened = False

    def __repr__(self) -> str:
        return f"<{self.framework.name}/{self.NAME} prio={self.priority}>"


class Framework:
    """A named extension point holding registered components."""

    def __init__(self, name: str, description: str = "") -> None:
        self.name = name
        self.description = description
        self._component_classes: dict[str, type] = {}
        self._components: dict[str, Component] = {}
        self._lock = threading.RLock()
        # Framework-level selection filter, reference `--mca <fw> <list>`.
        self._filter_var = config.register(
            name,
            "",
            "select",
            type=str,
            default="",
            description=(
                f"Comma-separated component filter for the {name} framework "
                "(prefix with ^ to negate, e.g. '^sm')"
            ),
        )

    # -- registration -----------------------------------------------------

    def register(self, cls: type) -> type:
        """Register a Component subclass. Usable as a decorator."""
        if not cls.NAME:
            raise ComponentError(f"{cls} has no NAME")
        with self._lock:
            self._component_classes[cls.NAME] = cls
        return cls

    def _instantiate(self, name: str) -> Component:
        with self._lock:
            inst = self._components.get(name)
            if inst is None:
                inst = self._component_classes[name](self)
                self._components[name] = inst
            return inst

    # -- filtering & selection --------------------------------------------

    def _filtered_names(self) -> list[str]:
        spec = (self._filter_var.value or "").strip()
        names = list(self._component_classes)
        if not spec:
            return names
        if spec.startswith("^"):
            banned = {p.strip() for p in spec[1:].split(",") if p.strip()}
            return [n for n in names if n not in banned]
        wanted = [p.strip() for p in spec.split(",") if p.strip()]
        unknown = [w for w in wanted if w not in self._component_classes]
        if unknown:
            raise ComponentError(
                f"framework {self.name}: unknown component(s) {unknown}; "
                f"known: {sorted(names)}"
            )
        return wanted

    def candidates(self, **ctx: Any) -> list[Component]:
        """Available components, highest priority first."""
        out = []
        for name in self._filtered_names():
            comp = self._instantiate(name)
            try:
                ok = comp.available(**ctx)
            except Exception as exc:  # availability probe must not raise
                logger.debug(
                    "%s/%s availability probe failed: %s", self.name, name, exc
                )
                ok = False
            if ok:
                out.append(comp)
        out.sort(key=lambda c: (-c.priority, c.NAME))
        return out

    def select_one(self, **ctx: Any) -> Component:
        """Exactly-one selection (PML-style)."""
        cands = self.candidates(**ctx)
        if not cands:
            raise ComponentError(
                f"framework {self.name}: no available component "
                f"(registered: {sorted(self._component_classes)})"
            )
        winner = cands[0]
        if not winner.opened:
            winner.open()
        logger.debug("framework %s selected %s", self.name, winner.NAME)
        return winner

    def select_all(self, **ctx: Any) -> list[Component]:
        """All available components by priority (coll-style merge input)."""
        cands = self.candidates(**ctx)
        for c in cands:
            if not c.opened:
                c.open()
        return cands

    def component(self, name: str) -> Component:
        if name not in self._component_classes:
            raise ComponentError(f"framework {self.name}: no component {name}")
        return self._instantiate(name)

    def component_names(self) -> list[str]:
        return sorted(self._component_classes)

    def close(self) -> None:
        with self._lock:
            for comp in self._components.values():
                if comp.opened:
                    comp.close()


class FrameworkRegistry:
    """Process-global registry of frameworks (the MCA itself)."""

    def __init__(self) -> None:
        self._frameworks: dict[str, Framework] = {}
        self._lock = threading.RLock()

    def framework(self, name: str, description: str = "") -> Framework:
        with self._lock:
            fw = self._frameworks.get(name)
            if fw is None:
                fw = Framework(name, description)
                self._frameworks[name] = fw
            return fw

    def names(self) -> list[str]:
        return sorted(self._frameworks)

    def dump(self) -> dict[str, list[str]]:
        return {n: f.component_names() for n, f in self._frameworks.items()}


MCA = FrameworkRegistry()


def framework(name: str, description: str = "") -> Framework:
    return MCA.framework(name, description)
