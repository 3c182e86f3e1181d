"""MCA-style configuration variable registry.

TPU-native re-design of Open MPI's MCA var system
(reference: opal/mca/base/mca_base_var.c, mca_base_var.h:430 —
``mca_base_var_register(project, framework, component, name, ...)``) with the
same 4-source precedence model (reference mca_base_var.h:119-132):

    DEFAULT  <  FILE  <  ENV  <  API (set() / command line)

Variables are namespaced ``<framework>_<component>_<name>`` (the reference's
``ompi_coll_tuned_priority`` style). Environment variables use the prefix
``OMPITPU_MCA_`` (reference: ``OMPI_MCA_*``). Parameter files are
``~/.ompi_tpu/params.conf`` and ``$OMPITPU_PARAMS_FILE``
(reference: $HOME/.openmpi/mca-params.conf, mca_base_var.c:429-433).

Unlike the reference's string-typed C registry, variables here are typed
Python descriptors with validation — idiomatic, but the observable surface
(precedence, env override, file override, introspection dump) is the same.

The PyTorch port keeps its own copy of ``ompi_tpu/core/config.py`` (it
imports nothing from the JAX package). Variable names, the environment
prefix and the parameter files are the same, so a name such as
``coll_pallas_priority`` means one thing in both packages.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import threading
from typing import Any, Callable, Iterable, Optional

ENV_PREFIX = "OMPITPU_MCA_"
PARAMS_FILE_ENV = "OMPITPU_PARAMS_FILE"


class VarSource(enum.IntEnum):
    """Where a variable's current value came from. Higher wins."""

    DEFAULT = 0
    FILE = 1
    ENV = 2
    API = 3  # set() call / command line


class VarFlag(enum.IntFlag):
    NONE = 0
    READONLY = 1  # cannot be set after registration
    INTERNAL = 2  # hidden from default info listings
    DEPRECATED = 4


def _parse_bool(s: str) -> bool:
    s = s.strip().lower()
    if s in ("1", "true", "yes", "on", "enabled"):
        return True
    if s in ("0", "false", "no", "off", "disabled"):
        return False
    raise ValueError(f"not a boolean: {s!r}")


def _coerce(value: Any, ty: type) -> Any:
    if ty is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, (int, float)):
            return bool(value)
        return _parse_bool(str(value))
    if ty is int:
        if isinstance(value, bool):
            return int(value)
        if isinstance(value, int):
            return value
        return int(str(value).strip(), 0)  # base 0: allow 0x / 0o
    if ty is float:
        return float(value)
    if ty is str:
        return str(value)
    if ty is list:
        if isinstance(value, (list, tuple)):
            return list(value)
        s = str(value).strip()
        return [p.strip() for p in s.split(",") if p.strip()] if s else []
    raise TypeError(f"unsupported var type: {ty}")


@dataclasses.dataclass
class Var:
    """A single registered configuration variable."""

    framework: str
    component: str
    name: str
    type: type
    default: Any
    description: str = ""
    flags: VarFlag = VarFlag.NONE
    choices: Optional[tuple] = None
    validator: Optional[Callable[[Any], bool]] = None

    value: Any = None
    source: VarSource = VarSource.DEFAULT

    @property
    def full_name(self) -> str:
        parts = [p for p in (self.framework, self.component, self.name) if p]
        return "_".join(parts)

    @property
    def env_name(self) -> str:
        return ENV_PREFIX + self.full_name

    def _check(self, value: Any) -> Any:
        value = _coerce(value, self.type)
        if self.choices is not None and value not in self.choices:
            raise ValueError(
                f"{self.full_name}: {value!r} not in {self.choices}"
            )
        if self.validator is not None and not self.validator(value):
            raise ValueError(f"{self.full_name}: {value!r} failed validation")
        return value

    def _apply(self, value: Any, source: VarSource) -> None:
        # Higher-precedence sources win; equal-precedence last-writer-wins
        # (matches reference semantics where later files override earlier).
        if source < self.source:
            return
        self.value = self._check(value)
        self.source = source


class VarRegistry:
    """Process-global registry of configuration variables."""

    def __init__(self) -> None:
        self._vars: dict[str, Var] = {}
        self._lock = threading.RLock()
        self._file_values: dict[str, str] = {}
        self._files_loaded = False
        # Bumped on every post-registration mutation (set /
        # set_if_unset / load_param_file / reset). Fast-path caches
        # (coll/tuned's memoized dispatch) key their validity on this
        # instead of re-reading every cvar per call.
        self._generation = 0

    # -- registration -----------------------------------------------------

    def register(
        self,
        framework: str,
        component: str,
        name: str,
        *,
        type: type = str,
        default: Any = None,
        description: str = "",
        flags: VarFlag = VarFlag.NONE,
        choices: Optional[Iterable] = None,
        validator: Optional[Callable[[Any], bool]] = None,
    ) -> Var:
        """Register a variable and resolve its initial value.

        Idempotent: re-registering an existing full name returns the
        existing Var (matching mca_base_var_register's behavior for
        duplicate registration of synonyms/re-open).
        """
        with self._lock:
            var = Var(
                framework=framework,
                component=component,
                name=name,
                type=type,
                default=default,
                description=description,
                flags=flags,
                choices=tuple(choices) if choices is not None else None,
                validator=validator,
            )
            existing = self._vars.get(var.full_name)
            if existing is not None:
                return existing
            var.value = var._check(default) if default is not None else None
            var.source = VarSource.DEFAULT
            self._vars[var.full_name] = var
            self._resolve(var)
            return var

    def _resolve(self, var: Var) -> None:
        """Apply FILE then ENV sources (ascending precedence)."""
        self._ensure_files()
        if var.full_name in self._file_values:
            var._apply(self._file_values[var.full_name], VarSource.FILE)
        env = os.environ.get(var.env_name)
        if env is not None:
            var._apply(env, VarSource.ENV)

    # -- file source ------------------------------------------------------

    def _ensure_files(self) -> None:
        if self._files_loaded:
            return
        self._files_loaded = True
        paths = []
        home = os.path.expanduser("~/.ompi_tpu/params.conf")
        paths.append(home)
        extra = os.environ.get(PARAMS_FILE_ENV)
        if extra:
            paths.extend(extra.split(os.pathsep))
        for path in paths:
            self._load_file(path)

    def _load_file(self, path: str) -> None:
        try:
            with open(path, "r", encoding="utf-8") as f:
                text = f.read()
        except OSError:
            return
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if "=" not in line:
                continue
            key, _, val = line.partition("=")
            self._file_values[key.strip()] = val.strip()

    def load_param_file(self, path: str) -> None:
        """Explicitly load a params file (AMCA-param-set style) and
        re-resolve already-registered vars."""
        with self._lock:
            self._ensure_files()
            self._load_file(path)
            for var in self._vars.values():
                if var.full_name in self._file_values:
                    var._apply(
                        self._file_values[var.full_name], VarSource.FILE
                    )
            self._generation += 1

    # -- access -----------------------------------------------------------

    def lookup(self, full_name: str) -> Optional[Var]:
        return self._vars.get(full_name)

    def get(self, full_name: str, default: Any = None) -> Any:
        var = self._vars.get(full_name)
        return default if var is None else var.value

    def set(self, full_name: str, value: Any) -> None:
        """API-source assignment (highest precedence)."""
        var = self._vars.get(full_name)
        if var is None:
            raise KeyError(f"unknown config var: {full_name}")
        if var.flags & VarFlag.READONLY:
            raise PermissionError(f"{full_name} is read-only")
        var._apply(value, VarSource.API)
        with self._lock:
            self._generation += 1

    def set_if_unset(self, full_name: str, value: Any) -> None:
        var = self._vars.get(full_name)
        if var is None:
            raise KeyError(f"unknown config var: {full_name}")
        if var.source == VarSource.DEFAULT:
            var._apply(value, VarSource.API)
            with self._lock:
                self._generation += 1

    def generation(self) -> int:
        """Monotonic mutation counter (cache-invalidation stamp)."""
        with self._lock:
            return self._generation

    def dump(self, include_internal: bool = False) -> list[dict]:
        """Introspection dump (ompi_info equivalent)."""
        out = []
        for name in sorted(self._vars):
            var = self._vars[name]
            if (var.flags & VarFlag.INTERNAL) and not include_internal:
                continue
            out.append(
                {
                    "name": name,
                    "value": var.value,
                    "default": var.default,
                    "source": var.source.name,
                    "type": var.type.__name__,
                    "description": var.description,
                }
            )
        return out

    def all_vars(self) -> list["Var"]:
        """Registered Var objects, sorted by name (MPI_T cvar iter)."""
        return [self._vars[n] for n in sorted(self._vars)]

    def __contains__(self, full_name: str) -> bool:
        return full_name in self._vars

    def reset_for_testing(self) -> None:
        """Drop all registrations (test isolation only)."""
        with self._lock:
            self._vars.clear()
            self._file_values.clear()
            self._files_loaded = False
            self._generation += 1


# The process-global registry (the reference has exactly one, too).
VARS = VarRegistry()


def register(framework: str, component: str, name: str, **kw) -> Var:
    return VARS.register(framework, component, name, **kw)


def get(full_name: str, default: Any = None) -> Any:
    return VARS.get(full_name, default)


def set(full_name: str, value: Any) -> None:  # noqa: A001 - mirrors API name
    VARS.set(full_name, value)


def generation() -> int:
    """Registry mutation stamp — see VarRegistry.generation()."""
    return VARS.generation()
