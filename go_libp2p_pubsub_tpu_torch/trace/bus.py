"""Tracer bus: fans every router/runtime event to one EventTracer (structured
events for offline analysis) and N RawTracers (synchronous hooks).

Mirrors trace.go:63-531. Events are dicts shaped after pb/trace.proto's
TraceEvent (type, peerID, timestamp, per-type payload); the pb layer
serializes them for interop. The RawTracer bus is also the internal wiring
mechanism: scoring, promise tracking, connmgr tags, and the gater subscribe
to it (SURVEY.md §1 L5).
"""

from __future__ import annotations

from typing import Callable, Protocol

from ..core.types import RPC, Message, PeerID
from .events import RawTracer


class EventTracer(Protocol):
    """Structured trace sink (trace.go:15-17)."""

    def trace(self, evt: dict) -> None: ...


def _rpc_meta(rpc: RPC) -> dict:
    meta: dict = {}
    if rpc.subscriptions:
        meta["subscription"] = [
            {"subscribe": s.subscribe, "topic": s.topicid} for s in rpc.subscriptions]
    if rpc.publish:
        meta["messages"] = [{"messageID": m._id, "topic": m.topic} for m in rpc.publish]
    if rpc.control is not None and not rpc.control.is_empty():
        c = rpc.control
        meta["control"] = {
            "ihave": [{"topic": ih.topic, "messageIDs": list(ih.message_ids)}
                      for ih in c.ihave],
            "iwant": [{"messageIDs": list(iw.message_ids)} for iw in c.iwant],
            "graft": [{"topic": g.topic} for g in c.graft],
            "prune": [{"topic": p.topic, "peers": [pi.peer_id for pi in p.peers]}
                      for p in c.prune],
        }
    return meta


class PubsubTracer:
    """The per-node fan-out bus (trace.go:63-76)."""

    def __init__(self, now: Callable[[], float], pid: PeerID,
                 msg_id: Callable[[Message], str],
                 tracer: EventTracer | None = None,
                 raw: list[RawTracer] | None = None):
        self._now = now
        self._pid = pid
        self._msg_id = msg_id
        self.tracer = tracer
        self.raw: list[RawTracer] = list(raw or [])

    def add_raw(self, rt: RawTracer) -> None:
        self.raw.append(rt)

    def _emit(self, typ: str, **payload) -> None:
        if self.tracer is not None:
            self.tracer.trace({"type": typ, "peerID": self._pid,
                               "timestamp": self._now(), **payload})

    # --- event methods (trace.go:78-531) ---

    def publish_message(self, msg: Message) -> None:
        self._emit("PUBLISH_MESSAGE", publishMessage={
            "messageID": self._msg_id(msg), "topic": msg.topic})

    def validate_message(self, msg: Message) -> None:
        if msg.received_from != self._pid:
            for rt in self.raw:
                rt.validate_message(msg)

    def reject_message(self, msg: Message, reason: str) -> None:
        if msg.received_from != self._pid:
            for rt in self.raw:
                rt.reject_message(msg, reason)
        self._emit("REJECT_MESSAGE", rejectMessage={
            "messageID": self._msg_id(msg), "receivedFrom": msg.received_from,
            "reason": reason, "topic": msg.topic})

    def duplicate_message(self, msg: Message) -> None:
        if msg.received_from != self._pid:
            for rt in self.raw:
                rt.duplicate_message(msg)
        self._emit("DUPLICATE_MESSAGE", duplicateMessage={
            "messageID": self._msg_id(msg), "receivedFrom": msg.received_from,
            "topic": msg.topic})

    def deliver_message(self, msg: Message) -> None:
        if msg.received_from != self._pid:
            for rt in self.raw:
                rt.deliver_message(msg)
        self._emit("DELIVER_MESSAGE", deliverMessage={
            "messageID": self._msg_id(msg), "topic": msg.topic,
            "receivedFrom": msg.received_from})

    def add_peer(self, peer: PeerID, proto: str) -> None:
        for rt in self.raw:
            rt.add_peer(peer, proto)
        self._emit("ADD_PEER", addPeer={"peerID": peer, "proto": proto})

    def remove_peer(self, peer: PeerID) -> None:
        for rt in self.raw:
            rt.remove_peer(peer)
        self._emit("REMOVE_PEER", removePeer={"peerID": peer})

    def recv_rpc(self, rpc: RPC) -> None:
        for rt in self.raw:
            rt.recv_rpc(rpc)
        self._emit("RECV_RPC", receivedFrom=rpc.from_peer, meta=_rpc_meta(rpc))

    def send_rpc(self, rpc: RPC, peer: PeerID) -> None:
        for rt in self.raw:
            rt.send_rpc(rpc, peer)
        self._emit("SEND_RPC", sendTo=peer, meta=_rpc_meta(rpc))

    def drop_rpc(self, rpc: RPC, peer: PeerID) -> None:
        for rt in self.raw:
            rt.drop_rpc(rpc, peer)
        self._emit("DROP_RPC", sendTo=peer, meta=_rpc_meta(rpc))

    def undeliverable_message(self, msg: Message) -> None:
        for rt in self.raw:
            rt.undeliverable_message(msg)

    def throttle_peer(self, peer: PeerID) -> None:
        for rt in self.raw:
            rt.throttle_peer(peer)

    def join(self, topic: str) -> None:
        for rt in self.raw:
            rt.join(topic)
        self._emit("JOIN", join={"topic": topic})

    def leave(self, topic: str) -> None:
        for rt in self.raw:
            rt.leave(topic)
        self._emit("LEAVE", leave={"topic": topic})

    def graft(self, peer: PeerID, topic: str) -> None:
        for rt in self.raw:
            rt.graft(peer, topic)
        self._emit("GRAFT", graft={"peerID": peer, "topic": topic})

    def prune(self, peer: PeerID, topic: str) -> None:
        for rt in self.raw:
            rt.prune(peer, topic)
        self._emit("PRUNE", prune={"peerID": peer, "topic": topic})
