"""Core wire-level and router-level types.

Dataclass mirrors of go-libp2p-pubsub's wire schema (pb/rpc.proto:5-57) used
by the in-process runtime; a copy of the JAX package's core/types.py. Peer
identity is an opaque string (libp2p uses peer.ID); the batched engine maps
peers to dense int32 indices.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


# Peer identifiers are opaque strings in the functional core.
PeerID = str


class AcceptStatus(enum.Enum):
    """Router vetting verdict for an incoming RPC (pubsub.go:217-227)."""

    ACCEPT_NONE = 0      # drop the RPC entirely (graylisted peer)
    ACCEPT_CONTROL = 1   # process control messages only, strip payloads
    ACCEPT_ALL = 2       # process everything


@dataclass
class Message:
    """A pubsub message (pb/rpc.proto Message{from,data,seqno,topic,signature,key}).

    ``from_peer`` is the author (may differ from the forwarding peer);
    ``received_from`` is runtime metadata, not serialized.
    """

    from_peer: PeerID | None = None
    data: bytes = b""
    seqno: bytes | None = None
    topic: str = ""
    signature: bytes | None = None
    key: bytes | None = None
    # runtime-only metadata (Message wrapper, pubsub.go:986-1007)
    received_from: PeerID | None = None
    validator_data: object = None
    local: bool = False
    # cached canonical id (midgen.go:39-52); cache state, not identity
    _id: str | None = field(default=None, compare=False, repr=False)

    def get_from(self) -> PeerID | None:
        return self.from_peer


@dataclass
class SubOpts:
    """A subscription announcement (pb/rpc.proto SubOpts)."""

    subscribe: bool = True
    topicid: str = ""


@dataclass
class ControlIHave:
    topic: str = ""
    message_ids: list[str] = field(default_factory=list)


@dataclass
class ControlIWant:
    message_ids: list[str] = field(default_factory=list)


@dataclass
class ControlGraft:
    topic: str = ""


@dataclass
class PeerInfo:
    """Peer-exchange record carried in PRUNE (pb/rpc.proto PeerInfo)."""

    peer_id: PeerID = ""
    signed_peer_record: bytes | None = None


@dataclass
class ControlPrune:
    topic: str = ""
    peers: list[PeerInfo] = field(default_factory=list)
    backoff: float = 0.0  # seconds; wire uses uint64 seconds


@dataclass
class ControlMessage:
    ihave: list[ControlIHave] = field(default_factory=list)
    iwant: list[ControlIWant] = field(default_factory=list)
    graft: list[ControlGraft] = field(default_factory=list)
    prune: list[ControlPrune] = field(default_factory=list)

    def is_empty(self) -> bool:
        return not (self.ihave or self.iwant or self.graft or self.prune)


@dataclass
class RPC:
    """One wire frame (pb/rpc.proto RPC{subscriptions, publish, control})."""

    subscriptions: list[SubOpts] = field(default_factory=list)
    publish: list[Message] = field(default_factory=list)
    control: ControlMessage | None = None
    # runtime-only: which peer this RPC came from (comm.go:84)
    from_peer: PeerID | None = None

    def size(self) -> int:
        """Approximate serialized size, used for fragmentation decisions
        (gossipsub.go:1204-1293). Computed from the dataclass contents with
        protobuf-style overhead estimates; exactness is not required, only a
        consistent, monotone measure."""
        n = 0
        for s in self.subscriptions:
            n += len(s.topicid.encode()) + 4
        for m in self.publish:
            n += len(m.data) + len(m.topic.encode())
            n += len(m.seqno or b"") + len(m.signature or b"") + len(m.key or b"")
            n += len((m.from_peer or "").encode()) + 12
        if self.control is not None:
            c = self.control
            for ih in c.ihave:
                n += len(ih.topic.encode()) + sum(len(mid.encode()) + 2 for mid in ih.message_ids) + 4
            for iw in c.iwant:
                n += sum(len(mid.encode()) + 2 for mid in iw.message_ids) + 4
            for g in c.graft:
                n += len(g.topic.encode()) + 4
            for pr in c.prune:
                n += len(pr.topic.encode()) + 14
                for pi in pr.peers:
                    n += len(pi.peer_id.encode()) + len(pi.signed_peer_record or b"") + 4
        return n


def trim_rpc(rpc: RPC) -> RPC | None:
    """Return None if the RPC carries nothing."""
    if rpc.subscriptions or rpc.publish or (rpc.control and not rpc.control.is_empty()):
        return rpc
    return None
