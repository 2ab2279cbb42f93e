"""Built-in seqno replay validator (validation_builtin.go).

Suppresses replayed/out-of-order messages via a per-author max-seqno table in
a pluggable metadata store (validation_builtin.go:12-101). The reference's
double-checked locking collapses to a single check on the deterministic
scheduler.
"""

from __future__ import annotations

from typing import Protocol

from ..core.types import Message, PeerID
from .validation import VALIDATION_ACCEPT, VALIDATION_IGNORE


class PeerMetadataStore(Protocol):
    """validation_builtin.go:12-18."""

    def get(self, peer: PeerID) -> bytes | None: ...
    def put(self, peer: PeerID, val: bytes) -> None: ...


class InMemoryPeerMetadataStore:
    def __init__(self):
        self._m: dict[PeerID, bytes] = {}

    def get(self, peer: PeerID) -> bytes | None:
        return self._m.get(peer)

    def put(self, peer: PeerID, val: bytes) -> None:
        self._m[peer] = val


class BasicSeqnoValidator:
    """validation_builtin.go:32-101; use as a default (all-topic) validator."""

    def __init__(self, meta: PeerMetadataStore | None = None):
        self.meta = meta or InMemoryPeerMetadataStore()

    def __call__(self, src: PeerID, msg: Message) -> int:
        author = msg.from_peer or ""
        seqno = int.from_bytes(msg.seqno or b"", "big")
        prev_raw = self.meta.get(author)
        prev = int.from_bytes(prev_raw, "big") if prev_raw else 0
        if seqno <= prev:
            return VALIDATION_IGNORE
        self.meta.put(author, seqno.to_bytes(8, "big"))
        return VALIDATION_ACCEPT
