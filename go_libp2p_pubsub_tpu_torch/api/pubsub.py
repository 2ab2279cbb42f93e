"""PubSub core: the L3 runtime (pubsub.go).

Owns all topic/peer/subscription state for one node. The reference serializes
everything through one processLoop goroutine (pubsub.go:561-675); here the
deterministic scheduler provides that serialization globally, so handlers
mutate state directly.

State fields mirror pubsub.go:48-183: ``topics`` (topic -> peers who
announced it), ``my_topics`` (joined Topic handles), ``peers`` (connected +
hello'd peers), seen-cache, blacklist, validation, tracer, router.
"""

from __future__ import annotations

import random
from typing import Callable

from ..core.params import TIME_CACHE_DURATION
from ..core.types import RPC, AcceptStatus, Message, PeerID, SubOpts, trim_rpc
from ..net.network import Host, Scheduler
from ..routers.base import Router
from ..trace import events as ev
from ..trace.bus import EventTracer, PubsubTracer
from ..utils.blacklist import Blacklist, MapBlacklist
from ..utils.midgen import MsgIdGenerator
from ..utils.subscription_filter import SubscriptionFilter
from ..utils.timecache import SWEEP_INTERVAL, Strategy, TimeCache
from .sign import STRICT_SIGN, SignError, SignPolicy, sign_message
from .validation import Validation, ValidationError


class PubSub:
    """One pubsub node (NewPubSub, pubsub.go:251-339)."""

    def __init__(self, host: Host, router: Router, *,
                 sign_policy: SignPolicy = STRICT_SIGN,
                 sign_key=None,
                 validation: Validation | None = None,
                 event_tracer: EventTracer | None = None,
                 raw_tracers: list[ev.RawTracer] | None = None,
                 blacklist: Blacklist | None = None,
                 subscription_filter: SubscriptionFilter | None = None,
                 seen_ttl: float = TIME_CACHE_DURATION,
                 seen_strategy: Strategy = Strategy.FIRST_SEEN,
                 msg_id_fn: Callable[[Message], str] | None = None,
                 rpc_inspector: Callable[[PeerID, RPC], bool] | None = None,
                 peer_filter: Callable[[PeerID, str], bool] | None = None,
                 protocol_match_fn: Callable[
                     [str], Callable[[str], bool]] | None = None,
                 max_message_size: int = 1 << 20,
                 author: PeerID | None = None,
                 no_author: bool = False,
                 discovery=None,
                 rng: random.Random | None = None):
        self.host = host
        self.rt = router
        self.scheduler: Scheduler = host.network.scheduler
        self.pid = host.peer_id
        self.rng = rng or random.Random(hash(self.pid) & 0xFFFFFFFF)

        self.sign_policy = sign_policy
        self.sign_key = sign_key
        # author id for outbound messages; defaults to the host id and is only
        # cleared by WithNoAuthor (pubsub.go:261, 413-427)
        self.sign_id: PeerID | None = None if no_author else (author or self.pid)
        if no_author:
            self.sign_policy &= ~SignPolicy.MSG_SIGNING
        if self.sign_policy.must_sign and sign_key is None:
            raise ValueError(f"can't sign for peer {self.pid}: no private key")
        if sign_key is not None and host.local_record is None:
            # publish a sealed self-record so peers can vouch for us over PX
            # (the identify/peerstore flow feeding cab.GetPeerRecord,
            # gossipsub.go:1885-1893); only a self-certifying id can seal a
            # record that validates, so skip when signing as someone else
            from .peer_record import PeerRecord, seal_record
            from .sign import peer_id_from_key
            if peer_id_from_key(sign_key.public_key()) == self.pid:
                host.local_record = seal_record(
                    PeerRecord(peer_id=self.pid, seq=1, addrs=(host.addr,)),
                    sign_key)

        self.id_gen = MsgIdGenerator()
        if msg_id_fn is not None:
            self.id_gen.default = msg_id_fn

        self.seen = TimeCache(seen_ttl, self.scheduler.now, seen_strategy)
        self.blacklist = blacklist or MapBlacklist()
        self.sub_filter = subscription_filter
        self.rpc_inspector = rpc_inspector
        self.peer_filter = peer_filter or (lambda pid, topic: True)
        self.max_message_size = max_message_size

        self.val = validation or Validation()
        self.tracer = PubsubTracer(self.scheduler.now, self.pid,
                                   self.id_gen.id, event_tracer, raw_tracers)

        # state registries (pubsub.go:123-150)
        self.topics: dict[str, set[PeerID]] = {}       # topic -> announced peers
        self.my_topics: dict[str, "Topic"] = {}        # joined Topic handles
        self.my_relays: dict[str, int] = {}            # relay refcounts
        self.peers: set[PeerID] = set()                # hello'd peers
        self.counter = 0                               # seqno (pubsub.go:1341)

        # discovery bridge (pubsub.go:317, discovery.go:86)
        from .discovery import Discover
        self.disc = discovery if isinstance(discovery, Discover) \
            else Discover(discovery)
        self.disc.start(self)

        # wire up the substrate (pubsub.go:321-336); protocol_match_fn is
        # WithProtocolMatchFn (pubsub.go:520-531): custom multistream
        # acceptance, combined with the router's feature test / protocol list
        host.set_protocols(router.protocols(), self._handle_new_stream,
                           self._handle_incoming_rpc_wire,
                           match_fn=protocol_match_fn)
        host.notify(_Notifiee(self))
        router.attach(self)
        self.val.start(self)
        self.scheduler.call_every(SWEEP_INTERVAL, self.seen.sweep)
        # sweep pre-existing connections (pubsub.go:336)
        for peer in list(host.conns):
            self._peer_connected(peer)

    # ---- wire events ----

    def _handle_new_stream(self, peer: PeerID, proto: str) -> None:
        pass  # inbound streams are implicit in the substrate

    def _peer_connected(self, peer: PeerID) -> None:
        """New peer: hello packet + router add (handleNewPeer, comm.go:114-133,
        handlePendingPeers pubsub.go:683-709)."""
        if peer in self.peers or self.blacklist.contains(peer):
            return
        proto = self.host.protocols.get(peer)
        if proto is None:
            return  # no mutually supported pubsub protocol
        self.peers.add(peer)
        hello = self._get_hello_packet()
        if hello is not None:
            self.host.send(peer, hello)
        self.tracer.add_peer(peer, proto)
        self.rt.add_peer(peer, proto)

    def _peer_disconnected(self, peer: PeerID) -> None:
        """handleDeadPeers (pubsub.go:711-757)."""
        if peer not in self.peers:
            return
        self.peers.discard(peer)
        for topic, tmap in self.topics.items():
            if peer in tmap:
                tmap.discard(peer)
                self._notify_leave(topic, peer)
        self.rt.remove_peer(peer)
        self.tracer.remove_peer(peer)

    def _get_hello_packet(self) -> RPC | None:
        """Announce all current subscriptions (getHelloPacket, pubsub.go:759-775)."""
        topics = set(self.my_topics) | set(self.my_relays)
        if not topics:
            return None
        return RPC(subscriptions=[SubOpts(True, t) for t in sorted(topics)])

    # ---- inbound RPC (pubsub.go:1029-1105) ----

    def _handle_incoming_rpc_wire(self, src: PeerID, rpc: RPC) -> None:
        if src not in self.peers:
            return  # not hello'd / dead
        if rpc.size() > self.max_message_size:
            return
        self.handle_incoming_rpc(src, rpc)

    def handle_incoming_rpc(self, src: PeerID, rpc: RPC) -> None:
        rpc.from_peer = src
        if self.rpc_inspector is not None and not self.rpc_inspector(src, rpc):
            return
        self.tracer.recv_rpc(rpc)

        subs = rpc.subscriptions
        if subs and self.sub_filter is not None:
            try:
                subs = self.sub_filter.filter_incoming_subscriptions(src, subs)
            except ValueError:
                return
        for sub in subs:
            t = sub.topicid
            if sub.subscribe:
                tmap = self.topics.setdefault(t, set())
                if src not in tmap:
                    tmap.add(src)
                    topic = self.my_topics.get(t)
                    if topic is not None:
                        topic._notify_peer_event("join", src)
            else:
                tmap = self.topics.get(t)
                if tmap is not None and src in tmap:
                    tmap.discard(src)
                    self._notify_leave(t, src)

        accept = self.rt.accept_from(src)
        if accept == AcceptStatus.ACCEPT_NONE:
            return
        if accept == AcceptStatus.ACCEPT_CONTROL:
            if rpc.publish:
                self.tracer.throttle_peer(src)
        else:
            for pmsg in rpc.publish:
                if not (self._subscribed_to_msg(pmsg) or self._can_relay_msg(pmsg)):
                    continue
                msg = Message(from_peer=pmsg.from_peer, data=pmsg.data,
                              seqno=pmsg.seqno, topic=pmsg.topic,
                              signature=pmsg.signature, key=pmsg.key,
                              received_from=src)
                self.push_msg(msg)
        self.rt.handle_rpc(rpc)

    def _subscribed_to_msg(self, msg: Message) -> bool:
        return msg.topic in self.my_topics

    def _can_relay_msg(self, msg: Message) -> bool:
        return self.my_relays.get(msg.topic, 0) > 0

    def _notify_leave(self, topic: str, peer: PeerID) -> None:
        t = self.my_topics.get(topic)
        if t is not None:
            t._notify_peer_event("leave", peer)

    # ---- message push (pubsub.go:1118-1162) ----

    def push_msg(self, msg: Message) -> None:
        src = msg.received_from
        if src is not None and self.blacklist.contains(src):
            self.tracer.reject_message(msg, ev.REJECT_BLACKLISTED_PEER)
            return
        if msg.from_peer is not None and self.blacklist.contains(msg.from_peer):
            self.tracer.reject_message(msg, ev.REJECT_BLACKLISTED_SOURCE)
            return
        try:
            self.check_signing_policy(msg)
        except ValidationError:
            return
        # reject messages claiming to be from ourselves but not locally published
        if msg.from_peer == self.pid and src != self.pid:
            self.tracer.reject_message(msg, ev.REJECT_SELF_ORIGIN)
            return
        mid = self.id_gen.id(msg)
        if self.seen.has(mid):
            self.tracer.duplicate_message(msg)
            return
        if not self.val.push(src, msg):
            return
        # no validators apply: mark seen and publish directly
        if self.mark_seen(mid):
            self.publish_message(msg)

    def check_signing_policy(self, msg: Message) -> None:
        """pubsub.go:1164-1194; raises ValidationError and traces on violation."""
        if self.sign_policy.must_verify:
            if self.sign_policy.must_sign:
                if msg.signature is None:
                    self.tracer.reject_message(msg, ev.REJECT_MISSING_SIGNATURE)
                    raise ValidationError(ev.REJECT_MISSING_SIGNATURE)
            else:
                if msg.signature is not None:
                    self.tracer.reject_message(msg, ev.REJECT_UNEXPECTED_SIGNATURE)
                    raise ValidationError(ev.REJECT_UNEXPECTED_SIGNATURE)
                if self.sign_id is None and (
                        msg.seqno is not None or msg.from_peer is not None
                        or msg.key is not None):
                    self.tracer.reject_message(msg, ev.REJECT_UNEXPECTED_AUTH_INFO)
                    raise ValidationError(ev.REJECT_UNEXPECTED_AUTH_INFO)

    def mark_seen(self, mid: str) -> bool:
        return self.seen.add(mid)

    def deliver_validated(self, msg: Message) -> None:
        """Validation pipeline completion -> deliver (processLoop sendMsg case,
        pubsub.go:641-642)."""
        self.publish_message(msg)

    def publish_message(self, msg: Message) -> None:
        """pubsub.go:1196-1202."""
        self.tracer.deliver_message(msg)
        self._notify_subs(msg)
        if not msg.local:
            self.rt.publish(msg)

    def _notify_subs(self, msg: Message) -> None:
        """Deliver to local subscriptions, drop-if-slow (pubsub.go:973-984)."""
        topic = self.my_topics.get(msg.topic)
        if topic is not None:
            for sub in topic._subs:
                sub._deliver(msg)

    # ---- public API (L6) ----

    def join(self, topic_name: str, *, msg_id_fn=None) -> "Topic":
        """pubsub.go:1228-1279 (tryJoin). ``msg_id_fn`` is the
        WithTopicMessageIdFn TopicOpt (pubsub.go:1219-1224): a per-topic
        message-id override consulted by dedup, mcache, and tracing."""
        if self.sub_filter is not None and not self.sub_filter.can_subscribe(topic_name):
            raise ValueError(f"topic is not allowed by the subscription filter: {topic_name}")
        t = self.my_topics.get(topic_name)
        if t is not None:
            if msg_id_fn is not None:
                # the reference refuses Join on an existing topic outright
                # (pubsub.go:1229-1232); we allow handle reuse but never
                # silently drop a requested option
                raise ValueError(
                    f"topic already joined: {topic_name}; per-topic "
                    "msg_id_fn must be set on the first join")
            return t
        if msg_id_fn is not None:
            self.id_gen.set(topic_name, msg_id_fn)
        from .topic import Topic
        t = Topic(self, topic_name)
        self.my_topics[topic_name] = t
        return t

    def get_topics(self) -> list[str]:
        """Joined+subscribed topics (pubsub.go:1290)."""
        return sorted(t for t, topic in self.my_topics.items() if topic._subs)

    def list_peers(self, topic: str) -> list[PeerID]:
        return sorted(self.topics.get(topic, ()))

    def blacklist_peer(self, peer: PeerID) -> None:
        """pubsub.go:1311-1339: blacklist + hard-disconnect state."""
        self.blacklist.add(peer)
        if peer in self.peers:
            self._peer_disconnected(peer)

    def register_topic_validator(self, topic: str, validate, *, throttle: int = 0,
                                 inline: bool = False,
                                 timeout: float = 0.0) -> None:
        """RegisterTopicValidator (pubsub.go:1379) with the ValidatorOpt
        knobs: WithValidatorConcurrency, WithValidatorInline, and
        WithValidatorTimeout (validation.go:540-570)."""
        self.val.add_validator(topic, validate, throttle=throttle,
                               inline=inline, timeout=timeout)

    def unregister_topic_validator(self, topic: str) -> None:
        self.val.remove_validator(topic)

    def next_seqno(self) -> bytes:
        self.counter += 1
        return self.counter.to_bytes(8, "big")

    # ---- outbound ----

    def send_rpc(self, peer: PeerID, rpc: RPC) -> bool:
        """Send with drop-trace on queue overflow (pubsub.go:917-925 announce
        path and gossipsub.go:1195-1202 both land here). Returns whether the
        RPC entered the peer's queue (empty-after-trim counts as sent)."""
        out = trim_rpc(rpc)
        if out is None:
            return True
        if self.host.send(peer, out):
            self.tracer.send_rpc(out, peer)
            return True
        self.tracer.drop_rpc(out, peer)
        return False

    def announce(self, topic: str, subscribe: bool) -> None:
        """Announce (un)subscription to every peer (pubsub.go:910-927)."""
        for peer in sorted(self.peers):
            self._announce_to_peer(peer, topic, subscribe)

    def _announce_to_peer(self, peer: PeerID, topic: str,
                          subscribe: bool) -> None:
        """One peer's announcement; a queue-overflow drop schedules a
        jittered retry (1..1000ms) that re-checks the (un)subscription
        still holds before resending (pubsub.go:917-925 + announceRetry
        pubsub.go:929-969)."""
        if self.send_rpc(peer, RPC(subscriptions=[SubOpts(subscribe, topic)])):
            return
        delay = 0.001 * (1 + self.rng.randrange(1000))

        def retry():
            if peer not in self.peers:
                return
            t = self.my_topics.get(topic)
            wanted = t is not None and (bool(t._subs) or t._relay_count > 0)
            if wanted == subscribe:
                self._announce_to_peer(peer, topic, subscribe)

        self.scheduler.call_later(delay, retry)

    def sign_and_finalize(self, msg: Message) -> None:
        """Attach author/seqno/signature per policy (topic.go:252-264)."""
        if self.sign_id is not None:
            msg.from_peer = self.sign_id
            msg.seqno = self.next_seqno()
        if self.sign_policy.must_sign:
            assert self.sign_key is not None
            try:
                sign_message(self.pid, self.sign_key, msg)
            except Exception as e:  # pragma: no cover
                raise SignError(str(e)) from e


class _Notifiee:
    """Bridges substrate connect events into the runtime (notify.go:11-75)."""

    def __init__(self, p: PubSub):
        self.p = p

    def connected(self, peer: PeerID) -> None:
        self.p._peer_connected(peer)

    def disconnected(self, peer: PeerID) -> None:
        self.p._peer_disconnected(peer)
