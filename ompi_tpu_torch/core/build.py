"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library
with a plain C interface (``lib<name>-<hash>.so`` under
``ompi_tpu_torch/_build/``) and loaded with ``ctypes``. The hash covers
the source, every header in ``csrc/`` and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. ``build``
starts one ``nvcc`` per source, all at once, and waits for all of them.
A failed build raises ``KernelError`` with the compiler's output.
``defines`` builds a variant of a source with preprocessor macros set
(``-D``), as its own library: the measurement tools' probe builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

from .device import find_nvcc
from .errors import KernelError

PKG = Path(__file__).resolve().parent.parent
SRC_DIR = PKG / "csrc"
BUILD_DIR = PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[tuple, ctypes.CDLL] = {}
#: name -> the compiler's output of the build that made the loaded
#: library (ptxas register/shared-memory lines included); "cached" when
#: the library was already on disk.
BUILD_LOGS: dict[str, str] = {}


def _flags(defines: Sequence[str]) -> list[str]:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def _lib_path(name: str, defines: Sequence[str] = ()) -> Path:
    h = hashlib.sha256()
    h.update((SRC_DIR / f"{name}.cu").read_bytes())
    for hdr in sorted(SRC_DIR.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(_flags(defines)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str], defines: Sequence[str] = ()
          ) -> dict[str, Path]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name, defines) for name in names}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            BUILD_LOGS.setdefault(name, "cached")
            continue
        if nvcc is None:
            raise KernelError(f"cannot build {name}: nvcc not found")
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(defines), "-o", str(tmp),
               str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, paths[name])
    if failed:
        raise KernelError("kernel build failed: " + "\n".join(failed))
    return paths


def library(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built with
    ``defines``), built on first use."""
    key = (name, tuple(defines))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            path = build([name], defines)[name]
            lib = _libs[key] = ctypes.CDLL(str(path))
        return lib
