"""Virtual time for the deterministic runtime.

The reference mixes wall-clock durations (backoff expiry, TTLs, score
activation windows) with tick-based logic (heartbeats). Here everything lives
in ONE virtual-clock domain measured in float seconds; the batched engine
further quantizes to heartbeat ticks (SURVEY.md §7 "Time").

Durations are plain floats in seconds. Constants below mirror Go's
time.Millisecond / time.Second / time.Minute units so parameter defaults read
the same as the reference's (e.g. gossipsub.go:41-58).
"""

from __future__ import annotations

MILLISECOND = 1e-3
SECOND = 1.0
MINUTE = 60.0
HOUR = 3600.0


class VirtualClock:
    """A monotonically advancing virtual clock owned by the scheduler."""

    __slots__ = ("_now",)

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance_to(self, t: float) -> None:
        if t < self._now:
            raise ValueError(f"clock going backwards: {t} < {self._now}")
        self._now = t
