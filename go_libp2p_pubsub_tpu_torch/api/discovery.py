"""Discovery bridge (discovery.go).

A poll loop asks the router ``enough_peers`` per joined topic and fans out
``find_peers`` to a pluggable discovery service; joined topics are advertised
with periodic re-advertisement; ``bootstrap`` blocks publishing readiness
until the router reports enough peers (discovery.go:51-297).

The default service is ``NetworkDiscovery``: a rendezvous registry over the
simulated substrate (the stand-in for the DHT), namespaced ``floodsub:<topic>``
like the reference (discovery.go:324-328).
"""

from __future__ import annotations

import random
from typing import TYPE_CHECKING, Callable, Protocol

from ..core.clock import SECOND
from ..core.types import PeerID

if TYPE_CHECKING:
    from .pubsub import PubSub

DISCOVERY_POLL_INITIAL_DELAY = 0 * SECOND
DISCOVERY_POLL_INTERVAL = 1 * SECOND


def namespace(topic: str) -> str:
    return f"floodsub:{topic}"


class DiscoveryService(Protocol):
    """discovery.Discovery analogue: advertise + find_peers."""

    def advertise(self, ns: str, peer: PeerID) -> float:
        """Register; returns the TTL until re-advertisement is needed."""
        ...

    def find_peers(self, ns: str, limit: int) -> list[PeerID]: ...


class NetworkDiscovery:
    """Rendezvous registry over the substrate (the mock DHT the reference's
    tests build by hand, discovery_test.go:27-113)."""

    def __init__(self, ttl: float = 120.0, rng: random.Random | None = None):
        self.ttl = ttl
        self._reg: dict[str, dict[PeerID, float]] = {}
        self.rng = rng or random.Random(0)
        self._now: Callable[[], float] = lambda: 0.0

    def bind(self, now: Callable[[], float]) -> None:
        self._now = now

    def advertise(self, ns: str, peer: PeerID) -> float:
        self._reg.setdefault(ns, {})[peer] = self._now() + self.ttl
        return self.ttl

    def find_peers(self, ns: str, limit: int) -> list[PeerID]:
        now = self._now()
        entries = self._reg.get(ns, {})
        live = sorted(p for p, exp in entries.items() if exp > now)
        self.rng.shuffle(live)
        return live[:limit] if limit else live


class Discover:
    """The per-node discovery pipeline (discovery.go:50-84)."""

    def __init__(self, service: DiscoveryService | None,
                 min_peers: int = 0):
        self.service = service
        self.p: "PubSub | None" = None
        self.advertising: dict[str, int] = {}  # topic -> chain generation
        self.min_peers = min_peers

    def start(self, p: "PubSub") -> None:
        if self.service is None:
            return
        self.p = p
        if isinstance(self.service, NetworkDiscovery):
            self.service.bind(p.scheduler.now)
        p.scheduler.call_every(DISCOVERY_POLL_INTERVAL, self._poll)

    def _poll(self) -> None:
        """requestDiscovery (discovery.go:139-145)."""
        assert self.p is not None
        for topic in list(self.p.my_topics):
            if not self.p.rt.enough_peers(topic, 0):
                self._handle_discovery(topic)

    def _handle_discovery(self, topic: str) -> None:
        assert self.p is not None and self.service is not None
        found = self.service.find_peers(namespace(topic), limit=0)
        for pid in found:
            if pid == self.p.pid or pid in self.p.host.conns:
                continue
            other = self.p.host.network.hosts.get(pid)
            if other is not None:
                self.p.host.connect(other)

    def advertise(self, topic: str) -> None:
        """discovery.go:177-218, with TTL-driven re-advertisement."""
        if self.service is None or self.p is None:
            return
        if topic in self.advertising:
            return
        # generation guard: a cancel+re-advertise cycle must not leave the old
        # timer chain alive alongside the new one
        gen = self.advertising[topic] = self._gen = getattr(self, "_gen", 0) + 1

        def readvertise():
            if self.advertising.get(topic) != gen:
                return  # chain superseded or stopped
            assert self.p is not None
            ttl = self.service.advertise(namespace(topic), self.p.pid)
            self.p.scheduler.call_later(max(ttl * 0.8, 1.0), readvertise)

        readvertise()

    def stop_advertise(self, topic: str) -> None:
        self.advertising.pop(topic, None)

    def discover(self, topic: str) -> None:
        if self.service is not None and self.p is not None:
            self._handle_discovery(topic)

    def bootstrap(self, topic: str, ready: Callable[[], bool] | None = None,
                  timeout: float = 60.0) -> bool:
        """Drive discovery until the router is ready (discovery.go:242-297).
        Runs the scheduler in 1s slices up to ``timeout`` virtual seconds."""
        assert self.p is not None
        sched = self.p.scheduler
        deadline = sched.now() + timeout
        is_ready = ready or (lambda: self.p.rt.enough_peers(topic, self.min_peers))
        while sched.now() < deadline:
            if is_ready():
                return True
            self._handle_discovery(topic)
            sched.run_for(1.0)
        return is_ready()
