"""Per-cycle cache: what Redis was for.

The reference uses an external Redis purely as shared memory between the N
concurrent per-node Score invocations of one scheduling cycle — statistics
keys "U-<node>"/"V-<node>"/"U-AVG"/"M-tmp"/"nodeLen" and score memos
"S-<node>" (pkg/yoda/score/algorithm.go:57-89,116), wiped with FlushDB at
PreScore and NormalizeScore (pkg/yoda/scheduler.go:103,160). The batched
engine computes the whole matrix in one pass, so the cross-call
side-channel disappears; this in-process cache remains for (a) the scalar
fallback path, which has the same memoization structure, and (b) optional
TTL'd entries like the dead path's 60-minute score cache
(algorithm.go:171).
"""

from __future__ import annotations

import time
from typing import Any


class CycleCache:
    def __init__(self, *, clock=time.monotonic):
        self._data: dict[str, tuple[Any, float | None]] = {}
        self._clock = clock

    def set(self, key: str, value: Any, ttl_seconds: float | None = None) -> None:
        expires = None if ttl_seconds is None else self._clock() + ttl_seconds
        self._data[key] = (value, expires)

    def get(self, key: str, default: Any = None) -> Any:
        item = self._data.get(key)
        if item is None:
            return default
        value, expires = item
        if expires is not None and self._clock() > expires:
            del self._data[key]
            return default
        return value

    def __contains__(self, key: str) -> bool:
        return self.get(key, _MISSING) is not _MISSING

    def flush(self) -> None:
        """FlushDB equivalent (scheduler.go:103,160)."""
        self._data.clear()


_MISSING = object()
