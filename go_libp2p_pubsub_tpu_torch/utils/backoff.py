"""Dead-peer reconnect exponential backoff (backoff.go:13-107).

Schedule: attempt 1 fires immediately; then 100ms; then doubling plus
0-99ms jitter, capped at 10s; after ``max_attempts`` updates the peer is
ejected with an error. Entries expire after ``TIME_TO_LIVE`` since last try
(both lazily in ``update_and_get`` and via ``cleanup``).

Jitter draws from an injected ``random.Random`` so runs are reproducible —
the deterministic-simulation replacement for backoff.go:47's global seed.
"""

from __future__ import annotations

import random
from typing import Callable

from ..core.clock import MILLISECOND, MINUTE, SECOND

MIN_BACKOFF_DELAY = 100 * MILLISECOND
MAX_BACKOFF_DELAY = 10 * SECOND
TIME_TO_LIVE = 10 * MINUTE
BACKOFF_CLEANUP_INTERVAL = 1 * MINUTE
BACKOFF_MULTIPLIER = 2
MAX_BACKOFF_JITTER_COFF = 100
MAX_BACKOFF_ATTEMPTS = 4


class MaxBackoffAttemptsError(RuntimeError):
    pass


class _History:
    __slots__ = ("duration", "last_tried", "attempts")

    def __init__(self):
        self.duration = 0.0
        self.last_tried = 0.0
        self.attempts = 0


class Backoff:
    def __init__(self, now: Callable[[], float], rng: random.Random,
                 max_attempts: int = MAX_BACKOFF_ATTEMPTS):
        self._now = now
        self._info: dict[str, _History] = {}
        self._max_attempts = max_attempts
        self._rng = rng

    def update_and_get(self, peer: str) -> float:
        """Next delay for ``peer`` (backoff.go:52-82). Raises after max attempts."""
        now = self._now()
        h = self._info.get(peer)
        if h is None or now - h.last_tried > TIME_TO_LIVE:
            h = _History()  # first request goes immediately
        elif h.attempts >= self._max_attempts:
            raise MaxBackoffAttemptsError(
                f"peer {peer} has reached its maximum backoff attempts")
        elif h.duration < MIN_BACKOFF_DELAY:
            h.duration = MIN_BACKOFF_DELAY
        elif h.duration < MAX_BACKOFF_DELAY:
            jitter = self._rng.randrange(MAX_BACKOFF_JITTER_COFF)
            h.duration = BACKOFF_MULTIPLIER * h.duration + jitter * MILLISECOND
            if h.duration > MAX_BACKOFF_DELAY or h.duration < 0:
                h.duration = MAX_BACKOFF_DELAY

        h.attempts += 1
        h.last_tried = now
        self._info[peer] = h
        return h.duration

    def cleanup(self) -> None:
        """Expire stale entries (backoff.go:84-93); call every BACKOFF_CLEANUP_INTERVAL."""
        now = self._now()
        stale = [p for p, h in self._info.items() if now - h.last_tried > TIME_TO_LIVE]
        for p in stale:
            del self._info[p]

    def __len__(self) -> int:
        return len(self._info)
