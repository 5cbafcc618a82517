"""The hot-path registry: one source of truth for "what counts as hot".

``@hot_path`` marks a function or method as dispatch-sensitive — part
of the observe/tick/fused-window surface whose cost model assumes no
implicit host syncs. Both halves of the discipline read it:

* slablint's HS001/RT001 rules seed their call-graph reachability walk
  from these decorators (statically, from the AST — importing the
  decorated module is never required);
* runtime accounting can introspect :data:`HOT_PATHS` to know which
  dispatch counters (``counters=...``) guard each path, and tests can
  assert the registry matches the objects they exercise.

The decorator is deliberately **zero-overhead**: it registers the
function and returns it *unchanged* — no wrapper frame — because
several hot paths (``observe``) are called per item inside benchmarked
loops. This module is stdlib-only.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

# qualified name -> {"fn": callable, "label": str, "counters": tuple}
HOT_PATHS: Dict[str, dict] = {}


def hot_path(fn: Optional[Callable] = None, *, label: Optional[str] = None,
             counters: Tuple[str, ...] = ()) -> Callable:
    """Register ``fn`` as a dispatch-discipline hot path.

    Usable bare (``@hot_path``) or with arguments
    (``@hot_path(counters=("n_dispatches",))``). ``counters`` names the
    stat counters whose accounting guards this path at runtime; CC001
    cross-checks that they exist and are read by tests.
    """
    def register(f: Callable) -> Callable:
        key = label or f"{f.__module__}.{f.__qualname__}"
        HOT_PATHS[key] = {"fn": f, "label": key,
                          "counters": tuple(counters)}
        f.__hot_path__ = key
        return f

    if fn is None:
        return register
    return register(fn)


def hot_path_counters() -> Dict[str, Tuple[str, ...]]:
    """Map of registered hot-path label -> declared guard counters."""
    return {k: v["counters"] for k, v in HOT_PATHS.items()}
