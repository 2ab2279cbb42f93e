"""Connection manager with protection tags and decaying tags.

The substrate analogue of go-libp2p's connmgr consumed by the tag tracer
(tag_tracer.go): ``protect``/``unprotect`` pin connections; decaying tags
accumulate bounded per-peer values that decay on a timer. Eviction itself is
out of scope for the simulation — the value of the tags is observability and
test parity (gossipsub_connmgr_test.go asserts protection/tag state).
"""

from __future__ import annotations


from ..core.types import PeerID


class DecayingTag:
    def __init__(self, name: str, interval: float, decay_amount: int,
                 bump_cap: int, scheduler) -> None:
        self.name = name
        self.values: dict[PeerID, int] = {}
        self._decay_amount = decay_amount
        self._cap = bump_cap
        self._closed = False
        self._cancel = scheduler.call_every(interval, self._decay)

    def bump(self, peer: PeerID, amount: int) -> None:
        if self._closed:
            raise RuntimeError(f"decaying tag {self.name} is closed")
        self.values[peer] = min(self.values.get(peer, 0) + amount, self._cap)

    def _decay(self) -> None:
        for peer in list(self.values):
            v = self.values[peer] - self._decay_amount
            if v <= 0:
                del self.values[peer]
            else:
                self.values[peer] = v

    def close(self) -> None:
        self._closed = True
        self._cancel()


class ConnManager:
    def __init__(self, scheduler):
        self._scheduler = scheduler
        self.protections: dict[PeerID, set[str]] = {}
        self.tags: dict[str, DecayingTag] = {}

    def protect(self, peer: PeerID, tag: str) -> None:
        self.protections.setdefault(peer, set()).add(tag)

    def unprotect(self, peer: PeerID, tag: str) -> bool:
        tags = self.protections.get(peer)
        if tags is None:
            return False
        tags.discard(tag)
        if not tags:
            del self.protections[peer]
        return bool(tags)

    def is_protected(self, peer: PeerID, tag: str = "") -> bool:
        tags = self.protections.get(peer, set())
        return bool(tags) if not tag else tag in tags

    def register_decaying_tag(self, name: str, interval: float,
                              decay_amount: int, bump_cap: int) -> DecayingTag:
        tag = DecayingTag(name, interval, decay_amount, bump_cap, self._scheduler)
        self.tags[name] = tag
        return tag
