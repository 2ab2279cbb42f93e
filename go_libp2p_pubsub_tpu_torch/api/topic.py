"""Topic handle: subscribe/publish/relay/events (topic.go).

Join/subscribe lifecycle per SURVEY.md §3.5: the first subscription (or
relay) announces to all peers and calls router.join; the last cancel
announces unsubscription and calls router.leave (pubsub.go:800-848).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable

from ..core.types import Message, PeerID
from .subscription import Subscription
from .validation import ValidationError

if TYPE_CHECKING:
    from .pubsub import PubSub


class PeerEvent:
    __slots__ = ("type", "peer")

    def __init__(self, type_: str, peer: PeerID):
        self.type = type_    # "join" | "leave"
        self.peer = peer


class TopicEventHandler:
    """Coalescing join/leave event log (topic.go:392-477): rapid join+leave
    pairs for the same peer cancel out, mirroring the reference's
    peer-event coalescing."""

    def __init__(self, topic: "Topic | None" = None):
        self._topic = topic
        self._pending: dict[PeerID, str] = {}
        self._order: list[PeerID] = []

    def cancel(self) -> None:
        """Stop receiving events (topic.go:432-436 TopicEventHandler.Cancel);
        drops anything buffered; idempotent."""
        if self._topic is not None:
            try:
                self._topic._event_handlers.remove(self)
            except ValueError:
                pass
            self._topic = None
        self._pending.clear()
        self._order.clear()

    def _push(self, ev: PeerEvent) -> None:
        cur = self._pending.get(ev.peer)
        if cur is None:
            self._pending[ev.peer] = ev.type
            self._order.append(ev.peer)
        elif cur != ev.type:
            del self._pending[ev.peer]
            self._order.remove(ev.peer)

    def next_peer_event(self) -> PeerEvent | None:
        while self._order:
            peer = self._order.pop(0)
            typ = self._pending.pop(peer, None)
            if typ is not None:
                return PeerEvent(typ, peer)
        return None


class Topic:
    """topic.go:26-35."""

    def __init__(self, p: "PubSub", name: str):
        self.p = p
        self.name = name
        self._subs: list[Subscription] = []
        self._event_handlers: list[TopicEventHandler] = []
        self._relay_count = 0
        self._closed = False
        self._pending_pubs: list = []      # (Message, gate|None), FIFO
        self._drain_scheduled = False      # one poll chain at a time

    # -- lifecycle --

    def _check_closed(self) -> None:
        if self._closed:
            raise RuntimeError("this Topic handle was closed")

    def subscribe(self, buffer_size: int = 32,
                  on_message: Callable[[Message], None] | None = None) -> Subscription:
        """topic.go:143-182."""
        self._check_closed()
        sub = Subscription(self, buffer_size)
        sub.on_message = on_message
        first = not self._subs and self._relay_count == 0
        self._subs.append(sub)
        if first:
            self._announce_and_join()
        return sub

    def relay(self) -> Callable[[], None]:
        """Relay refcounting (topic.go:186-207): pump messages without a
        subscription; returns a cancel function."""
        self._check_closed()
        first = not self._subs and self._relay_count == 0
        self._relay_count += 1
        self.p.my_relays[self.name] = self._relay_count
        if first:
            self._announce_and_join()
        cancelled = False

        def cancel():
            nonlocal cancelled
            if cancelled:
                return
            cancelled = True
            self._relay_count -= 1
            self.p.my_relays[self.name] = self._relay_count
            if self._relay_count == 0:
                del self.p.my_relays[self.name]
            self._maybe_leave()
        return cancel

    def _announce_and_join(self) -> None:
        """First sub/relay (handleAddSubscription, pubsub.go:827-848)."""
        self.p.disc.advertise(self.name)
        self.p.disc.discover(self.name)
        self.p.announce(self.name, True)
        self.p.rt.join(self.name)  # routers trace Join themselves

    def _remove_subscription(self, sub: Subscription) -> None:
        """handleRemoveSubscription (pubsub.go:800-821)."""
        self._subs.remove(sub)
        self._maybe_leave()

    def _maybe_leave(self) -> None:
        if not self._subs and self._relay_count == 0:
            self.p.disc.stop_advertise(self.name)
            self.p.announce(self.name, False)
            self.p.rt.leave(self.name)

    def close(self) -> None:
        """topic.go:480-494: only an idle handle can be closed."""
        if self._subs or self._relay_count:
            raise RuntimeError("cannot close topic with active subscriptions or relays")
        if self._pending_pubs:
            raise RuntimeError("cannot close topic with pending gated publishes")
        self._closed = True
        self.p.my_topics.pop(self.name, None)
        # drop any per-topic msg-id fn so a later join(topic) starts from
        # the default instead of silently inheriting the closed handle's
        # custom fn (the reference never deletes, midgen.go — an explicit
        # divergence: join() insists the fn be set on first join, so
        # surviving close would contradict that contract)
        self.p.id_gen._topic_gens.pop(self.name, None)

    # -- events --

    def event_handler(self) -> TopicEventHandler:
        """topic.go:392-430; pre-seeds with currently known topic peers."""
        self._check_closed()
        h = TopicEventHandler(self)
        for peer in sorted(self.p.topics.get(self.name, ())):
            h._push(PeerEvent("join", peer))
        self._event_handlers.append(h)
        return h

    def _notify_peer_event(self, typ: str, peer: PeerID) -> None:
        for h in self._event_handlers:
            h._push(PeerEvent(typ, peer))

    def list_peers(self) -> list[PeerID]:
        return self.p.list_peers(self.name)

    # -- publish (topic.go:224-312) --

    def publish(self, data: bytes, *, custom_key=None, local_only: bool = False,
                ready=None, ready_poll: float = 0.2) -> None:
        """Build, sign, validate and route a message. Raises ValidationError
        if local validation rejects it. ``local_only`` notifies in-process
        subscribers without routing (WithLocalPublication, topic.go:323-331).

        ``ready`` is the WithReadiness gate (topic.go:270-309): a callable
        polled on the scheduler; routing is deferred until it returns True
        (the deterministic analogue of the reference blocking the caller
        until RouterReady). Later routed publishes on the topic queue
        behind a pending gated one so seqno order is preserved on the
        wire; ``local_only`` messages never touch the wire and therefore
        bypass the queue and deliver immediately. A deferred message a
        validator later rejects is dropped (the rejection is traced by
        the validation pipeline — with no caller left to raise into, the
        trace is the error surface). While a drain chain is pending, the
        chain polls at the ``ready_poll`` of the publish that started it;
        a later publish's ``ready_poll`` takes effect only once the queue
        empties. A gate that never opens can be abandoned with
        :meth:`cancel_pending_publishes`. See :meth:`ready_min_peers`."""
        self._check_closed()
        if ready is not None and ready_poll <= 0:
            raise ValueError("ready_poll must be positive")
        msg = Message(data=data, topic=self.name, received_from=self.p.pid,
                      local=local_only)
        if custom_key is not None:
            pid, key = custom_key
            msg.from_peer = pid
            msg.seqno = self.p.next_seqno()
            from .sign import sign_message
            if self.p.sign_policy.must_sign:
                sign_message(pid, key, msg)
        else:
            self.p.sign_and_finalize(msg)
        if not local_only and \
                (self._pending_pubs or (ready is not None and not ready())):
            self._pending_pubs.append((msg, ready))
            if not self._drain_scheduled:
                self._drain_scheduled = True
                self.p.scheduler.call_later(ready_poll,
                                            lambda: self._drain_pubs(ready_poll))
            return
        self.p.val.push_local(msg)

    def _drain_pubs(self, poll: float) -> None:
        from .validation import ValidationError
        # _drain_scheduled stays True for the whole drain so a reentrant
        # publish (from a subscriber's handler) can't start a second chain.
        try:
            while self._pending_pubs:
                msg, gate = self._pending_pubs[0]
                if gate is not None and not gate():
                    self.p.scheduler.call_later(poll,
                                                lambda: self._drain_pubs(poll))
                    return
                self._pending_pubs.pop(0)
                try:
                    self.p.val.push_local(msg)
                except ValidationError:
                    pass    # traced by the pipeline; nothing left to raise into
        except BaseException:
            # A raising gate callable or subscriber handler must not wedge
            # the chain: keep draining what remains, or release the flag.
            if self._pending_pubs:
                self.p.scheduler.call_later(poll,
                                            lambda: self._drain_pubs(poll))
            else:
                self._drain_scheduled = False
            raise
        self._drain_scheduled = False

    def cancel_pending_publishes(self) -> int:
        """Drop deferred gated publishes without routing them — the
        deterministic analogue of cancelling the ctx that blocks the
        reference's Topic.Publish readiness wait (topic.go:270-309).
        Returns the number of messages dropped; after this, :meth:`close`
        is no longer blocked by a gate that never opens."""
        n = len(self._pending_pubs)
        self._pending_pubs.clear()
        return n

    def ready_min_peers(self, count: int = 1):
        """Readiness predicate: the router reports enough topic peers
        (MinTopicSize, discovery.go:79-83 + RouterReady, topic.go:316-321)."""
        return lambda: self.p.rt.enough_peers(self.name, count)

    def set_score_params(self, params) -> None:
        """Per-topic score reconfiguration (topic.go:44-82)."""
        rt = self.p.rt
        score = getattr(rt, "score", None)
        if score is None:
            raise RuntimeError("peer scoring is not enabled")
        params.validate()
        score.set_topic_score_params(self.name, params)
