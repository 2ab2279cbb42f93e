"""Peer blacklists (blacklist.go:12-58): set-backed and TTL-backed."""

from __future__ import annotations

from typing import Callable, Protocol

from .timecache import TimeCache


class Blacklist(Protocol):
    def add(self, peer: str) -> bool: ...
    def contains(self, peer: str) -> bool: ...


class MapBlacklist:
    def __init__(self):
        self._s: set[str] = set()

    def add(self, peer: str) -> bool:
        self._s.add(peer)
        return True

    def contains(self, peer: str) -> bool:
        return peer in self._s


class TimeCachedBlacklist:
    """Blacklist whose entries expire after ``expiry`` (blacklist.go:36-58)."""

    def __init__(self, expiry: float, now: Callable[[], float]):
        self._tc = TimeCache(expiry, now)

    def add(self, peer: str) -> bool:
        if self._tc.has(peer):
            return False
        self._tc.add(peer)
        return True

    def contains(self, peer: str) -> bool:
        return self._tc.has(peer)

    def sweep(self) -> None:
        self._tc.sweep()
