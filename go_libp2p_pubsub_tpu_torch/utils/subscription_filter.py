"""Subscription filters (subscription_filter.go:24-149).

Gate local joins and incoming subscription announcements. Unlike the Go
version's map-iteration order, ``filter_subscriptions`` returns results in
first-seen order — deterministic by construction.
"""

from __future__ import annotations

import re
from typing import Callable, Protocol

from ..core.types import SubOpts


class TooManySubscriptionsError(ValueError):
    pass


class SubscriptionFilter(Protocol):
    def can_subscribe(self, topic: str) -> bool: ...
    def filter_incoming_subscriptions(
        self, from_peer: str, subs: list[SubOpts]) -> list[SubOpts]: ...


def filter_subscriptions(subs: list[SubOpts], allow: Callable[[str], bool]) -> list[SubOpts]:
    """Filter + dedup; contradictory sub/unsub pairs for one topic cancel out
    (subscription_filter.go:101-131)."""
    accept: dict[str, SubOpts] = {}
    for sub in subs:
        topic = sub.topicid
        if not allow(topic):
            continue
        other = accept.get(topic)
        if other is not None:
            if sub.subscribe != other.subscribe:
                # contradictory pair cancels out; a later announcement for the
                # same topic may re-enter
                del accept[topic]
        else:
            accept[topic] = sub
    return list(accept.values())


class AllowlistSubscriptionFilter:
    def __init__(self, *topics: str):
        self._allow = set(topics)

    def can_subscribe(self, topic: str) -> bool:
        return topic in self._allow

    def filter_incoming_subscriptions(self, from_peer: str, subs: list[SubOpts]) -> list[SubOpts]:
        return filter_subscriptions(subs, self.can_subscribe)


class RegexpSubscriptionFilter:
    def __init__(self, pattern: str | re.Pattern):
        self._rx = re.compile(pattern) if isinstance(pattern, str) else pattern

    def can_subscribe(self, topic: str) -> bool:
        return self._rx.search(topic) is not None

    def filter_incoming_subscriptions(self, from_peer: str, subs: list[SubOpts]) -> list[SubOpts]:
        return filter_subscriptions(subs, self.can_subscribe)


class LimitSubscriptionFilter:
    """Hard cap on subscriptions per RPC (subscription_filter.go:133-149)."""

    def __init__(self, inner: SubscriptionFilter, limit: int):
        self._inner = inner
        self._limit = limit

    def can_subscribe(self, topic: str) -> bool:
        return self._inner.can_subscribe(topic)

    def filter_incoming_subscriptions(self, from_peer: str, subs: list[SubOpts]) -> list[SubOpts]:
        if len(subs) > self._limit:
            raise TooManySubscriptionsError("too many subscriptions")
        return self._inner.filter_incoming_subscriptions(from_peer, subs)
