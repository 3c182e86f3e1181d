"""Device capability probe: the port's counterpart of ``core/jax_compat``.

Every kernel gate reads ``probe()``: is CUDA present, is device 0 a
Hopper card (``sm_90``), is ``nvcc`` there to build the hand-written
kernels. ``resolve_device`` is what entry points call: they run on
``cuda:0`` unless the caller asks for the CPU, and they raise when
neither is possible. Nothing here falls back from the card to the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import shutil
from typing import Optional

import torch

from .errors import KernelError, NotInitializedError


@dataclasses.dataclass(frozen=True)
class Capability:
    cuda: bool
    device_name: Optional[str]
    sm: Optional[tuple[int, int]]
    sm_count: int
    nvcc: Optional[str]

    @property
    def hopper(self) -> bool:
        return self.sm == (9, 0)


def find_nvcc() -> Optional[str]:
    """nvcc on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.access(cand, os.X_OK):
                return cand
    return None


@functools.lru_cache(maxsize=1)
def probe() -> Capability:
    """What this process can run. Cached: the card and the toolkit do
    not change while a process runs, and every kernel launch asks."""
    if not torch.cuda.is_available():
        return Capability(False, None, None, 0, find_nvcc())
    props = torch.cuda.get_device_properties(0)
    return Capability(
        cuda=True,
        device_name=props.name,
        sm=(props.major, props.minor),
        sm_count=props.multi_processor_count,
        nvcc=find_nvcc(),
    )


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda:0`` by default, the CPU
    only when asked for. Raises when CUDA was wanted but is absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise NotInitializedError(
                "CUDA is not available; pass device='cpu' to run the "
                "port's plain versions on the CPU"
            )
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NotInitializedError(f"{dev} requested but CUDA is absent")
        return torch.device("cuda", 0 if dev.index is None else dev.index)
    if dev.type != "cpu":
        raise NotInitializedError(f"unsupported device {dev}")
    return dev


def require_kernel_device(t: torch.Tensor) -> Capability:
    """Gate for launching a hand-written kernel on ``t``'s card."""
    cap = probe()
    if not t.is_cuda or not cap.cuda:
        raise KernelError(f"kernel needs a CUDA tensor, got {t.device}")
    if not cap.hopper:
        raise KernelError(
            f"kernels are built for sm_90a; {cap.device_name} is sm_"
            f"{cap.sm[0]}{cap.sm[1]}"
        )
    if cap.nvcc is None:
        raise KernelError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda)")
    return cap
