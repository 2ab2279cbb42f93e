"""Subscription: buffered delivery handle (subscription.go:10-51)."""

from __future__ import annotations

from collections import deque
from typing import TYPE_CHECKING, Callable

from ..core.types import Message

if TYPE_CHECKING:
    from .topic import Topic


class Subscription:
    """Bounded message buffer (default 32, topic.go:162-165); messages beyond
    capacity are dropped and traced as undeliverable (pubsub.go:973-984)."""

    def __init__(self, topic: "Topic", buffer_size: int = 32):
        self.topic_handle = topic
        self.topic = topic.name
        self._buf: deque[Message] = deque()
        self._buffer_size = buffer_size
        self._cancelled = False
        # optional push callback for event-driven consumers
        self.on_message: Callable[[Message], None] | None = None

    def _deliver(self, msg: Message) -> None:
        if self._cancelled:
            return
        if self.on_message is not None:
            self.on_message(msg)
            return
        if len(self._buf) >= self._buffer_size:
            self.topic_handle.p.tracer.undeliverable_message(msg)
            return
        self._buf.append(msg)

    def next(self) -> Message | None:
        """Non-blocking Next (subscription.go:25-41): the deterministic
        runtime has no blocking reads; None means no message buffered."""
        if self._buf:
            return self._buf.popleft()
        return None

    def pending(self) -> int:
        return len(self._buf)

    def cancel(self) -> None:
        """subscription.go:44-48."""
        if not self._cancelled:
            self._cancelled = True
            self.topic_handle._remove_subscription(self)
