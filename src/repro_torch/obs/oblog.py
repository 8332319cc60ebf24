"""Deduplicating warning funnel.

Port of ``repro.obs.oblog``.  ``warn_once(message, category, key=...)``
emits a real ``warnings.warn`` the FIRST time each key is seen in the
process and silently counts the rest (``obs.warnings.suppressed`` in the
metrics registry; emissions count under ``obs.warnings.emitted``), so a
sweep calling ``run_batch`` repeatedly with a demoting configuration
warns once per distinct fallback reason.  ``reset_warn_once()`` re-arms
everything (a test isolation hook).
"""
from __future__ import annotations

import threading
import warnings

from repro_torch.obs import metrics

_lock = threading.Lock()
_seen: set = set()


def warn_once(message: str, category: type[Warning] = UserWarning, *,
              key=None, stacklevel: int = 2) -> bool:
    """Emit ``warnings.warn(message, category)`` once per distinct key.

    ``key`` defaults to ``(category name, message)``; pass an explicit
    key to dedup across varying message decorations (e.g. one warning
    per distinct ``fallback_reason``).  Returns True when the warning
    was emitted, False when suppressed as a duplicate.
    """
    k = (category.__name__, message) if key is None else key
    with _lock:
        if k in _seen:
            metrics.counter("obs.warnings.suppressed").inc()
            return False
        _seen.add(k)
    metrics.counter("obs.warnings.emitted").inc()
    # +1 skips this frame so the warning points at warn_once's caller
    warnings.warn(message, category, stacklevel=stacklevel + 1)
    return True


def reset_warn_once() -> None:
    """Forget every seen key (test isolation hook)."""
    with _lock:
        _seen.clear()


def seen_count() -> int:
    with _lock:
        return len(_seen)
