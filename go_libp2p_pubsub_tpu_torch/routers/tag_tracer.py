"""Connmgr tag tracer (tag_tracer.go).

Protects direct and mesh peers in the connection manager and bumps decaying
per-topic delivery tags for first and near-first deliverers (peers who
delivered while the message was still validating).
"""

from __future__ import annotations

from ..core.clock import MINUTE
from ..core.types import Message, PeerID
from ..net.connmgr import ConnManager
from ..trace import events as ev
from ..trace.events import RawTracerBase
from ..utils.midgen import MsgIdGenerator

# tag_tracer.go:13-31
CONN_TAG_BUMP_MESSAGE_DELIVERY = 1
CONN_TAG_DECAY_INTERVAL = 10 * MINUTE
CONN_TAG_DECAY_AMOUNT = 1
CONN_TAG_MESSAGE_DELIVERY_CAP = 15


def topic_tag(topic: str) -> str:
    return f"pubsub:{topic}"


class TagTracer(RawTracerBase):
    def __init__(self, cmgr: ConnManager, id_gen: MsgIdGenerator | None = None,
                 direct: set[PeerID] | None = None):
        self.cmgr = cmgr
        self.id_gen = id_gen or MsgIdGenerator()
        self.direct = direct or set()
        self.decaying: dict[str, object] = {}
        # message id -> peers who delivered during validation (tag_tracer.go:55)
        self.near_first: dict[str, set[PeerID]] = {}

    def start(self, gs) -> None:
        """Wire to the router's idGen and direct set (tag_tracer.go:73-81)."""
        self.id_gen = gs.p.id_gen
        self.direct = gs.direct

    # -- RawTracer hooks (tag_tracer.go:177-259) --

    def add_peer(self, peer: PeerID, proto: str) -> None:
        if peer in self.direct:
            self.cmgr.protect(peer, "pubsub:<direct>")

    def join(self, topic: str) -> None:
        self.decaying[topic] = self.cmgr.register_decaying_tag(
            f"pubsub-deliveries:{topic}", CONN_TAG_DECAY_INTERVAL,
            CONN_TAG_DECAY_AMOUNT, CONN_TAG_MESSAGE_DELIVERY_CAP)

    def leave(self, topic: str) -> None:
        tag = self.decaying.pop(topic, None)
        if tag is not None:
            tag.close()

    def graft(self, peer: PeerID, topic: str) -> None:
        self.cmgr.protect(peer, topic_tag(topic))

    def prune(self, peer: PeerID, topic: str) -> None:
        self.cmgr.unprotect(peer, topic_tag(topic))

    def validate_message(self, msg: Message) -> None:
        self.near_first.setdefault(self.id_gen.id(msg), set())

    def duplicate_message(self, msg: Message) -> None:
        peers = self.near_first.get(self.id_gen.id(msg))
        if peers is not None and msg.received_from is not None:
            peers.add(msg.received_from)

    def deliver_message(self, msg: Message) -> None:
        mid = self.id_gen.id(msg)
        near = self.near_first.pop(mid, set())
        self._bump(msg.received_from, msg.topic)
        for p in near:
            self._bump(p, msg.topic)

    def reject_message(self, msg: Message, reason: str) -> None:
        # only drop tracking for messages that passed through validation
        # (tag_tracer.go:240-254)
        if reason in (ev.REJECT_VALIDATION_THROTTLED, ev.REJECT_VALIDATION_IGNORED,
                      ev.REJECT_VALIDATION_FAILED):
            self.near_first.pop(self.id_gen.id(msg), None)

    def _bump(self, peer: PeerID | None, topic: str) -> None:
        tag = self.decaying.get(topic)
        if tag is not None and peer is not None:
            tag.bump(peer, CONN_TAG_BUMP_MESSAGE_DELIVERY)
