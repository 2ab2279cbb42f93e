"""FloodSubRouter: baseline flooding (floodsub.go).

Forward every validated message to every connected topic peer except the
source and the author (floodsub.go:76-100).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from ..core.types import RPC, AcceptStatus, Message, PeerID

if TYPE_CHECKING:
    from ..api.pubsub import PubSub

FLOODSUB_ID = "/floodsub/1.0.0"
FLOODSUB_TOPIC_SEARCH_SIZE = 5  # floodsub.go:13


class FloodSubRouter:
    def __init__(self, protocols: list[str] | None = None):
        """``protocols`` is NewFloodsubWithProtocols (floodsub.go:29-38):
        a custom protocol list replacing the default floodsub id."""
        self.p: "PubSub | None" = None
        self._protocols = list(protocols) if protocols is not None \
            else [FLOODSUB_ID]

    def protocols(self) -> list[str]:
        return list(self._protocols)

    def attach(self, p: "PubSub") -> None:
        self.p = p

    def add_peer(self, peer: PeerID, proto: str) -> None:
        pass

    def remove_peer(self, peer: PeerID) -> None:
        pass

    def enough_peers(self, topic: str, suggested: int) -> bool:
        """floodsub.go:52-66."""
        assert self.p is not None
        tmap = self.p.topics.get(topic, ())
        if suggested == 0:
            suggested = FLOODSUB_TOPIC_SEARCH_SIZE
        return len(tmap) >= suggested

    def accept_from(self, peer: PeerID) -> AcceptStatus:
        return AcceptStatus.ACCEPT_ALL

    def handle_rpc(self, rpc: RPC) -> None:
        pass  # floodsub has no control plane

    def publish(self, msg: Message) -> None:
        """floodsub.go:76-100."""
        p = self.p
        assert p is not None
        src = msg.received_from
        author = msg.from_peer
        tmap = p.topics.get(msg.topic, set())
        for peer in sorted(tmap):
            if peer == src or peer == author or peer not in p.peers:
                continue
            p.send_rpc(peer, RPC(publish=[msg]))

    def join(self, topic: str) -> None:
        assert self.p is not None
        self.p.tracer.join(topic)

    def leave(self, topic: str) -> None:
        assert self.p is not None
        self.p.tracer.leave(topic)
