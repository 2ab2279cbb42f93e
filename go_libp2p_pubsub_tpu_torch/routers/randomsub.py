"""RandomSubRouter: probabilistic flooding (randomsub.go).

Forward to max(RandomSubD, ceil(sqrt(network size))) randomly selected topic
peers (randomsub.go:124-143).
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING

from ..core.types import RPC, AcceptStatus, Message, PeerID

if TYPE_CHECKING:
    from ..api.pubsub import PubSub

RANDOMSUB_ID = "/randomsub/1.0.0"
RANDOMSUB_D = 6  # randomsub.go:16


class RandomSubRouter:
    def __init__(self, size: int):
        """``size`` estimates the network size (NewRandomSub, randomsub.go:21-35)."""
        self.p: "PubSub | None" = None
        self.size = size
        self.peers: dict[PeerID, str] = {}

    def protocols(self) -> list[str]:
        from .floodsub import FLOODSUB_ID
        return [RANDOMSUB_ID, FLOODSUB_ID]

    def attach(self, p: "PubSub") -> None:
        self.p = p

    def add_peer(self, peer: PeerID, proto: str) -> None:
        self.peers[peer] = proto

    def remove_peer(self, peer: PeerID) -> None:
        self.peers.pop(peer, None)

    def enough_peers(self, topic: str, suggested: int) -> bool:
        """randomsub.go:60-74."""
        assert self.p is not None
        tmap = self.p.topics.get(topic, ())
        if suggested == 0:
            suggested = RANDOMSUB_D
        return len(tmap) >= suggested

    def accept_from(self, peer: PeerID) -> AcceptStatus:
        return AcceptStatus.ACCEPT_ALL

    def handle_rpc(self, rpc: RPC) -> None:
        pass

    def publish(self, msg: Message) -> None:
        """randomsub.go:99-160: floodsub peers always get it; randomsub peers
        get it with probability target/candidates."""
        p = self.p
        assert p is not None
        from .floodsub import FLOODSUB_ID
        src = msg.received_from
        author = msg.from_peer
        tmap = p.topics.get(msg.topic, set())
        flood_targets: list[PeerID] = []
        rs_candidates: list[PeerID] = []
        for peer in sorted(tmap):
            if peer == src or peer == author or peer not in p.peers:
                continue
            if self.peers.get(peer) == FLOODSUB_ID:
                flood_targets.append(peer)
            else:
                rs_candidates.append(peer)

        target = max(RANDOMSUB_D, math.isqrt(self.size)
                     + (0 if math.isqrt(self.size) ** 2 == self.size else 1))
        if len(rs_candidates) > target:
            p.rng.shuffle(rs_candidates)
            rs_candidates = rs_candidates[:target]
        for peer in flood_targets + rs_candidates:
            p.send_rpc(peer, RPC(publish=[msg]))

    def join(self, topic: str) -> None:
        assert self.p is not None
        self.p.tracer.join(topic)

    def leave(self, topic: str) -> None:
        assert self.p is not None
        self.p.tracer.leave(topic)
