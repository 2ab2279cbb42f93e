"""Peer gater: Random-Early-Drop before the validation queue (peer_gater.go).

Turns on when throttled/validated exceeds ``threshold``; while on, a peer's
RPCs are admitted with probability (1 + deliveries) / (1 + weighted total) of
its source-IP stats, else stripped to control-only (AcceptControl). Auto-off
after a quiet period without throttle events (peer_gater.go:320-363).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable

from ..core.clock import HOUR, MINUTE, SECOND
from ..core.params import (
    DEFAULT_DECAY_INTERVAL,
    DEFAULT_DECAY_TO_ZERO,
    score_parameter_decay,
)
from ..core.types import AcceptStatus, Message, PeerID
from ..trace import events as ev
from ..trace.events import RawTracerBase

if TYPE_CHECKING:
    from ..api.pubsub import PubSub

DEFAULT_PEER_GATER_RETAIN_STATS = 6 * HOUR
DEFAULT_PEER_GATER_QUIET = MINUTE
DEFAULT_PEER_GATER_DUPLICATE_WEIGHT = 0.125
DEFAULT_PEER_GATER_IGNORE_WEIGHT = 1.0
DEFAULT_PEER_GATER_REJECT_WEIGHT = 16.0
DEFAULT_PEER_GATER_THRESHOLD = 0.33
DEFAULT_PEER_GATER_GLOBAL_DECAY = score_parameter_decay(2 * MINUTE)
DEFAULT_PEER_GATER_SOURCE_DECAY = score_parameter_decay(HOUR)


@dataclass
class PeerGaterParams:
    """peer_gater.go:31-116."""

    threshold: float = DEFAULT_PEER_GATER_THRESHOLD
    global_decay: float = DEFAULT_PEER_GATER_GLOBAL_DECAY
    source_decay: float = DEFAULT_PEER_GATER_SOURCE_DECAY
    decay_interval: float = DEFAULT_DECAY_INTERVAL
    decay_to_zero: float = DEFAULT_DECAY_TO_ZERO
    retain_stats: float = DEFAULT_PEER_GATER_RETAIN_STATS
    quiet: float = DEFAULT_PEER_GATER_QUIET
    duplicate_weight: float = DEFAULT_PEER_GATER_DUPLICATE_WEIGHT
    ignore_weight: float = DEFAULT_PEER_GATER_IGNORE_WEIGHT
    reject_weight: float = DEFAULT_PEER_GATER_REJECT_WEIGHT
    topic_delivery_weights: dict[str, float] = field(default_factory=dict)

    def validate(self) -> None:
        """peer_gater.go:57-88."""
        if self.threshold <= 0:
            raise ValueError("invalid Threshold; must be > 0")
        if not 0 < self.global_decay < 1:
            raise ValueError("invalid GlobalDecay; must be between 0 and 1")
        if not 0 < self.source_decay < 1:
            raise ValueError("invalid SourceDecay; must be between 0 and 1")
        if self.decay_interval < 1 * SECOND:
            raise ValueError("invalid DecayInterval; must be at least 1s")
        if not 0 < self.decay_to_zero < 1:
            raise ValueError("invalid DecayToZero; must be between 0 and 1")
        if self.quiet < 1 * SECOND:
            raise ValueError("invalid Quiet interval; must be at least 1s")
        if self.duplicate_weight <= 0:
            raise ValueError("invalid DuplicateWeight; must be > 0")
        if self.ignore_weight < 1:
            raise ValueError("invalid IgnoreWeight; must be >= 1")
        if self.reject_weight < 1:
            raise ValueError("invalid RejectWeight; must be >= 1")


class _Stats:
    __slots__ = ("connected", "expire", "deliver", "duplicate", "ignore", "reject")

    def __init__(self):
        self.connected = 0
        self.expire = 0.0
        self.deliver = 0.0
        self.duplicate = 0.0
        self.ignore = 0.0
        self.reject = 0.0


class PeerGater(RawTracerBase):
    """peer_gater.go:119-151; peers sharing an IP share one stats object."""

    def __init__(self, params: PeerGaterParams | None = None,
                 get_ip: Callable[[PeerID], str] | None = None,
                 rng: random.Random | None = None):
        self.params = params or PeerGaterParams()
        self.params.validate()
        self.peer_stats: dict[PeerID, _Stats] = {}
        self.ip_stats: dict[str, _Stats] = {}
        self.validate = 0.0
        self.throttle = 0.0
        self.last_throttle = -float("inf")
        self._get_ip = get_ip
        self.rng = rng or random.Random(0)
        self._now: Callable[[], float] = lambda: 0.0

    def attach(self, p: "PubSub") -> None:
        self._now = p.scheduler.now
        self.rng = p.rng
        if self._get_ip is None:
            def host_ip(peer: PeerID) -> str:
                addrs = p.host.conns_to_peer(peer)
                return addrs[0] if addrs else "<unknown>"
            self._get_ip = host_ip
        p.scheduler.call_every(self.params.decay_interval, self.decay_stats)

    def _stats_for(self, peer: PeerID) -> _Stats:
        st = self.peer_stats.get(peer)
        if st is None:
            ip = self._get_ip(peer) if self._get_ip else "<unknown>"
            st = self.ip_stats.get(ip)
            if st is None:
                st = _Stats()
                self.ip_stats[ip] = st
            self.peer_stats[peer] = st
        return st

    def decay_stats(self) -> None:
        """peer_gater.go:219-259."""
        z = self.params.decay_to_zero

        def dec(v, factor):
            v *= factor
            return 0.0 if v < z else v

        self.validate = dec(self.validate, self.params.global_decay)
        self.throttle = dec(self.throttle, self.params.global_decay)
        now = self._now()
        for ip in list(self.ip_stats):
            st = self.ip_stats[ip]
            if st.connected > 0:
                st.deliver = dec(st.deliver, self.params.source_decay)
                st.duplicate = dec(st.duplicate, self.params.source_decay)
                st.ignore = dec(st.ignore, self.params.source_decay)
                st.reject = dec(st.reject, self.params.source_decay)
            elif st.expire < now:
                del self.ip_stats[ip]

    def accept_from(self, peer: PeerID) -> AcceptStatus:
        """peer_gater.go:320-363."""
        if self._now() - self.last_throttle > self.params.quiet:
            return AcceptStatus.ACCEPT_ALL
        if self.throttle == 0:
            return AcceptStatus.ACCEPT_ALL
        if self.validate != 0 and self.throttle / self.validate < self.params.threshold:
            return AcceptStatus.ACCEPT_ALL
        st = self._stats_for(peer)
        total = (st.deliver + self.params.duplicate_weight * st.duplicate
                 + self.params.ignore_weight * st.ignore
                 + self.params.reject_weight * st.reject)
        if total == 0:
            return AcceptStatus.ACCEPT_ALL
        threshold = (1 + st.deliver) / (1 + total)
        if self.rng.random() < threshold:
            return AcceptStatus.ACCEPT_ALL
        return AcceptStatus.ACCEPT_CONTROL

    # -- RawTracer hooks (peer_gater.go:366-453) --

    def add_peer(self, peer: PeerID, proto: str) -> None:
        self._stats_for(peer).connected += 1

    def remove_peer(self, peer: PeerID) -> None:
        st = self._stats_for(peer)
        st.connected -= 1
        st.expire = self._now() + self.params.retain_stats
        self.peer_stats.pop(peer, None)

    def validate_message(self, msg: Message) -> None:
        self.validate += 1

    def deliver_message(self, msg: Message) -> None:
        st = self._stats_for(msg.received_from)  # type: ignore[arg-type]
        weight = self.params.topic_delivery_weights.get(msg.topic, 1.0)
        st.deliver += weight

    def reject_message(self, msg: Message, reason: str) -> None:
        if reason in (ev.REJECT_VALIDATION_QUEUE_FULL, ev.REJECT_VALIDATION_THROTTLED):
            self.last_throttle = self._now()
            self.throttle += 1
        elif reason == ev.REJECT_VALIDATION_IGNORED:
            self._stats_for(msg.received_from).ignore += 1  # type: ignore[arg-type]
        else:
            self._stats_for(msg.received_from).reject += 1  # type: ignore[arg-type]

    def duplicate_message(self, msg: Message) -> None:
        self._stats_for(msg.received_from).duplicate += 1  # type: ignore[arg-type]
