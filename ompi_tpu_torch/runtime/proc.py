"""Per-rank process descriptors (port of ``ompi_tpu/runtime/proc.py``).

In the port a rank is a virtual rank on one device: n ranks share one
card (or the CPU), and a rank-major ``(n, ...)`` tensor holds one block
per rank in that device's memory.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Proc:
    rank: int  # world rank
    device: torch.device
    process_index: int = 0  # owning controller process
    platform: str = "gpu"  # 'gpu' | 'cpu'
    slice_index: int = 0  # all ranks of one card form one slice

    def __repr__(self) -> str:
        return f"Proc(rank={self.rank}, dev={self.device})"


def proc_on_device(rank: int, device: torch.device) -> Proc:
    return Proc(rank=rank, device=device,
                platform="gpu" if device.type == "cuda" else "cpu")
