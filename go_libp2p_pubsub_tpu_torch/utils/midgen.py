"""Message-ID generation with per-topic overrides (midgen.go:11-52).

The default ID is author + seqno (pubsub.go:1107-1110). IDs are Python
strings in the functional core; the batched engine hashes them to fixed-width
uint64 (ops/hashing) — SURVEY.md §7 "String message-IDs".
"""

from __future__ import annotations

from typing import Callable

from ..core.types import Message

MsgIdFunction = Callable[[Message], str]


def default_msg_id_fn(msg: Message) -> str:
    """Concatenate author and sequence number (pubsub.go:1107-1110)."""
    return (msg.from_peer or "") + (msg.seqno or b"").decode("latin-1")


class MsgIdGenerator:
    def __init__(self):
        self.default: MsgIdFunction = default_msg_id_fn
        self._topic_gens: dict[str, MsgIdFunction] = {}

    def set(self, topic: str, gen: MsgIdFunction) -> None:
        self._topic_gens[topic] = gen

    def id(self, msg: Message) -> str:
        """Compute and cache the id on the message (midgen.go:33-40)."""
        if msg._id is None:
            msg._id = self.raw_id(msg)
        return msg._id

    def raw_id(self, msg: Message) -> str:
        gen = self._topic_gens.get(msg.topic, self.default)
        return gen(msg)
