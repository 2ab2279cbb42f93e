"""Sliding-window message cache for gossip (mcache.go).

Window semantics: ``put`` appends to slot 0; ``shift`` (called once per
heartbeat, gossipsub.go:1605) evicts the oldest slot and rotates.
``get_gossip_ids`` only reads the first ``gossip`` slots (mcache.go:82-92).
Per-peer IWANT retransmission counters live here (mcache.go:66-80) and feed
the GossipRetransmission cutoff (gossipsub.go:719-731).
"""

from __future__ import annotations

from typing import Callable

from ..core.types import Message
from .midgen import default_msg_id_fn


class MessageCache:
    def __init__(self, gossip: int, history: int, msg_id: Callable[[Message], str] | None = None):
        if gossip > history:
            raise ValueError(
                f"invalid parameters for message cache; gossip slots ({gossip}) "
                f"cannot be larger than history slots ({history})")
        self._msgs: dict[str, Message] = {}
        self._peertx: dict[str, dict[str, int]] = {}
        self._history: list[list[tuple[str, str]]] = [[] for _ in range(history)]
        self._gossip = gossip
        self._msg_id = msg_id or default_msg_id_fn

    def set_msg_id_fn(self, fn: Callable[[Message], str]) -> None:
        self._msg_id = fn

    def put(self, msg: Message) -> None:
        mid = self._msg_id(msg)
        self._msgs[mid] = msg
        self._history[0].append((mid, msg.topic))

    def get(self, mid: str) -> Message | None:
        return self._msgs.get(mid)

    def get_for_peer(self, mid: str, peer: str) -> tuple[Message | None, int]:
        """Return (message, transmission count incl. this request)."""
        m = self._msgs.get(mid)
        if m is None:
            return None, 0
        tx = self._peertx.setdefault(mid, {})
        tx[peer] = tx.get(peer, 0) + 1
        return m, tx[peer]

    def get_gossip_ids(self, topic: str) -> list[str]:
        return [mid for entries in self._history[: self._gossip]
                for (mid, t) in entries if t == topic]

    def shift(self) -> None:
        for mid, _ in self._history[-1]:
            self._msgs.pop(mid, None)
            self._peertx.pop(mid, None)
        self._history[1:] = self._history[:-1]
        self._history[0] = []
