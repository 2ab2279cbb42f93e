"""Gossip promise tracker (gossip_tracer.go).

Tracks IWANT promises probabilistically: ONE random message id per IWANT is
tracked (gossip_tracer.go:48-66); if the message hasn't arrived (in any form)
within ``followup_time`` the promise is broken and the router applies a P7
penalty per broken promise (gossipsub.go:1620-1625).
"""

from __future__ import annotations

import random
from typing import Callable

from ..core.types import Message, PeerID
from ..trace.events import RawTracerBase
from ..utils.midgen import MsgIdGenerator
from .. import trace


class GossipPromiseTracker(RawTracerBase):
    def __init__(self, now: Callable[[], float], followup_time: float,
                 rng: random.Random | None = None,
                 id_gen: MsgIdGenerator | None = None):
        self._now = now
        self.followup_time = followup_time
        self.rng = rng or random.Random(0)
        self.id_gen = id_gen or MsgIdGenerator()
        # mid -> peer -> expiry (gossip_tracer.go:21)
        self.promises: dict[str, dict[PeerID, float]] = {}
        # peers with broken promises already counted this round
        self.peer_promises: dict[PeerID, set[str]] = {}

    def add_promise(self, peer: PeerID, mids: list[str]) -> None:
        """Track one random id from the IWANT (gossip_tracer.go:48-66)."""
        if not mids:
            return
        mid = mids[self.rng.randrange(len(mids))]
        peers = self.promises.setdefault(mid, {})
        if peer not in peers:
            peers[peer] = self._now() + self.followup_time
            self.peer_promises.setdefault(peer, set()).add(mid)

    def get_broken_promises(self) -> dict[PeerID, int]:
        """Expired, unfulfilled promises per peer; expired entries are dropped
        (gossip_tracer.go:79-105)."""
        now = self._now()
        result: dict[PeerID, int] = {}
        to_del = []
        for mid, peers in self.promises.items():
            broken = [p for p, exp in peers.items() if exp < now]
            for p in broken:
                result[p] = result.get(p, 0) + 1
                del peers[p]
                pp = self.peer_promises.get(p)
                if pp is not None:
                    pp.discard(mid)
                    if not pp:
                        del self.peer_promises[p]
            if not peers:
                to_del.append(mid)
        for mid in to_del:
            del self.promises[mid]
        return result

    def _fulfill(self, msg: Message) -> None:
        """Message arrived in ANY form -> promises for its id are satisfied
        (gossip_tracer.go:109-133)."""
        mid = self.id_gen.id(msg)
        peers = self.promises.pop(mid, None)
        if peers:
            for p in peers:
                pp = self.peer_promises.get(p)
                if pp is not None:
                    pp.discard(mid)
                    if not pp:
                        del self.peer_promises[p]

    # RawTracer hooks (gossip_tracer.go:141-200)
    def deliver_message(self, msg: Message) -> None:
        self._fulfill(msg)

    def reject_message(self, msg: Message, reason: str) -> None:
        # obviously-invalid deliveries (bad/missing signature) keep the
        # promise penalty on top of the invalid-delivery one
        # (gossip_tracer.go:146-159)
        if reason in (trace.events.REJECT_MISSING_SIGNATURE,
                      trace.events.REJECT_INVALID_SIGNATURE):
            return
        self._fulfill(msg)

    def validate_message(self, msg: Message) -> None:
        # fulfilled as soon as validation begins (gossip_tracer.go:161-166)
        self._fulfill(msg)

    def throttle_peer(self, peer: PeerID) -> None:
        """Validation throttled the peer: stop tracking all its promises
        (gossip_tracer.go:182-200)."""
        pp = self.peer_promises.pop(peer, None)
        if not pp:
            return
        for mid in pp:
            peers = self.promises.get(mid)
            if peers is not None:
                peers.pop(peer, None)
                if not peers:
                    del self.promises[mid]
