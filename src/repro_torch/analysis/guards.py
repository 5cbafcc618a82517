"""The deliberate-sync marker of the dispatch discipline.

:func:`deliberate_sync` marks a deliberate device→host readback at a
cadence boundary (a drift gate, a refit-search result). slablint's HS001
skips host-materialising sinks lexically inside
``with deliberate_sync(...):``, so every readback of a device tensor on a
``@hot_path`` sits in one of these blocks and nowhere else.

The reference package also arms a runtime transfer guard around code
regions; the port has none yet, so here the marker is a no-op at run time.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

__all__ = ["deliberate_sync"]


@contextlib.contextmanager
def deliberate_sync(label: Optional[str] = None) -> Iterator[None]:
    """Mark a deliberate device→host readback named ``label``."""
    yield
