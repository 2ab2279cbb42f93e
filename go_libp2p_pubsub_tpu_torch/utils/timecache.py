"""Seen-message TTL caches on the virtual clock.

Mirrors timecache/ (time_cache.go:22-53, first_seen_cache.go,
last_seen_cache.go, util.go). Two fidelity-relevant details kept:

- ``has`` does NOT itself expire entries; expiry happens in ``sweep`` which
  the runtime calls every ``SWEEP_INTERVAL`` (util.go:9,26-35). An entry can
  thus remain visible slightly past its TTL, exactly like the reference.
- LastSeen ``has``/``add`` refresh the expiry; FirstSeen never refreshes.
"""

from __future__ import annotations

import enum
from typing import Callable

from ..core.clock import MINUTE

SWEEP_INTERVAL = 1 * MINUTE


class Strategy(enum.Enum):
    FIRST_SEEN = 0
    LAST_SEEN = 1


class TimeCache:
    """TTL dedup cache. ``now`` is a callable returning virtual time."""

    def __init__(self, ttl: float, now: Callable[[], float], strategy: Strategy = Strategy.FIRST_SEEN):
        self._m: dict[str, float] = {}
        self._ttl = ttl
        self._now = now
        self._strategy = strategy

    def add(self, key: str) -> bool:
        """Insert; returns True if newly added (first_seen_cache.go:46-56)."""
        present = key in self._m
        if self._strategy is Strategy.FIRST_SEEN:
            if present:
                return False
            self._m[key] = self._now() + self._ttl
            return True
        # last-seen: always refresh (last_seen_cache.go:40-47)
        self._m[key] = self._now() + self._ttl
        return not present

    def has(self, key: str) -> bool:
        present = key in self._m
        if present and self._strategy is Strategy.LAST_SEEN:
            self._m[key] = self._now() + self._ttl
        return present

    def sweep(self) -> None:
        """Drop expired entries (util.go:26-35); call every SWEEP_INTERVAL."""
        now = self._now()
        expired = [k for k, exp in self._m.items() if exp < now]
        for k in expired:
            del self._m[k]

    def done(self) -> None:
        self._m.clear()

    def __len__(self) -> int:
        return len(self._m)
