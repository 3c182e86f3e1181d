"""btl/template — scaffold + test-double transport.

Port of ``ompi_tpu/btl/template.py`` (reference: opal/mca/btl/template,
the scaffold for writing a new BTL, used as a mock in tests). Copy this
file to start a new transport; registered but disabled by default
(priority 0, available() False unless ``btl_template_enable`` is set).
When enabled it records every transfer so tests can assert on traffic.
"""

from __future__ import annotations

from typing import Any

from ..core import config
from ..core.tree import leaves
from .framework import BTL, BtlComponent, copy_payload

_enable = config.register(
    "btl", "template", "enable", type=bool, default=False,
    description="Enable the template/test-double BTL",
)


@BTL.register
class TemplateBtl(BtlComponent):
    NAME = "template"
    PRIORITY = 0
    EAGER_LIMIT = 4 * 1024
    DESCRIPTION = "scaffold transport (test double)"

    def __init__(self, framework) -> None:
        super().__init__(framework)
        #: every transfer as (src_device, dst_device, nbytes)
        self.transfers: list[tuple] = []

    def available(self, **ctx: Any) -> bool:
        return _enable.value

    def can_reach(self, src_proc, dst_proc) -> bool:
        # reach everything — tests drive exact routing through config
        return True

    def transfer(self, value, src_proc, dst_proc):
        nbytes = sum(getattr(leaf, "nbytes", 0) for leaf in leaves(value))
        self.transfers.append(
            (str(src_proc.device), str(dst_proc.device), nbytes)
        )
        return copy_payload(value, dst_proc.device)
