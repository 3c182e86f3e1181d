"""The health ledger's routing query, as a seam.

The JAX package's ``health/ledger.py`` quarantines transport tiers that
fail and ``LEDGER.is_denied`` keeps the autotuner from timing them.
The port has no health plane yet (ROADMAP Queue 1 item 9): no tier is
ever quarantined, so ``is_denied`` is always False.
"""

from __future__ import annotations

from typing import Optional


class _Ledger:
    """The ledger's read side, with nothing ever quarantined."""

    def is_denied(self, tier: str, scope: Optional[str] = None) -> bool:
        del tier, scope
        return False


LEDGER = _Ledger()


def is_denied(tier: str, scope: Optional[str] = None) -> bool:
    return LEDGER.is_denied(tier, scope)
