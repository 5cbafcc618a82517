"""Dispatch-discipline markers read by slablint: ``@hot_path`` and
``deliberate_sync``. The analyzer itself lives in the reference package
(``python -m repro.analysis src``) and scans this package too."""
from repro_torch.analysis.guards import deliberate_sync
from repro_torch.analysis.registry import HOT_PATHS, hot_path

__all__ = ["HOT_PATHS", "deliberate_sync", "hot_path"]
