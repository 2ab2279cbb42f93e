"""Peer-score engine (host-side, per-node): gossipsub v1.1 P1-P7.

Faithful functional re-implementation of score.go on the virtual clock:
- score() P1-P7 composition (score.go:265-342), including the duration
  integer-division truncation in P1 (score.go:286)
- refreshScores decay + retention purge (score.go:504-565)
- delivery-record state machine (score.go:90-120, 840-877) driving
  first/duplicate/invalid delivery marking (score.go:899-981)
- IP colocation tracking (score.go:984-1081) against the simulated
  substrate's peer addresses
- RemovePeer score retention for non-positive scores (score.go:611-644)

A copy of the JAX package's routers/score.py, float for float. The batched
twin of this engine lives in ops/score_ops.py.
"""

from __future__ import annotations

import ipaddress
from typing import Callable

from ..core.params import TIME_CACHE_DURATION, PeerScoreParams, TopicScoreParams
from ..core.types import Message
from ..trace import events as ev
from ..utils.midgen import MsgIdGenerator

# delivery record status (score.go:110-117)
DELIVERY_UNKNOWN = 0
DELIVERY_VALID = 1
DELIVERY_INVALID = 2
DELIVERY_IGNORED = 3
DELIVERY_THROTTLED = 4


class TopicScoreSnapshot:
    """Per-topic counter dump for extended score inspection
    (score.go:136-141 TopicScoreSnapshot)."""
    __slots__ = ("time_in_mesh", "first_message_deliveries",
                 "mesh_message_deliveries", "invalid_message_deliveries")

    def __init__(self, time_in_mesh=0.0, first_message_deliveries=0.0,
                 mesh_message_deliveries=0.0, invalid_message_deliveries=0.0):
        self.time_in_mesh = time_in_mesh
        self.first_message_deliveries = first_message_deliveries
        self.mesh_message_deliveries = mesh_message_deliveries
        self.invalid_message_deliveries = invalid_message_deliveries


class PeerScoreSnapshot:
    """Full per-peer score decomposition for extended inspection
    (score.go:127-134 PeerScoreSnapshot)."""
    __slots__ = ("score", "topics", "app_specific_score",
                 "ip_colocation_factor", "behaviour_penalty")

    def __init__(self, score=0.0, topics=None, app_specific_score=0.0,
                 ip_colocation_factor=0.0, behaviour_penalty=0.0):
        self.score = score
        self.topics: dict[str, TopicScoreSnapshot] = topics or {}
        self.app_specific_score = app_specific_score
        self.ip_colocation_factor = ip_colocation_factor
        self.behaviour_penalty = behaviour_penalty


class _TopicStats:
    __slots__ = ("in_mesh", "graft_time", "mesh_time", "first_message_deliveries",
                 "mesh_message_deliveries", "mesh_message_deliveries_active",
                 "mesh_failure_penalty", "invalid_message_deliveries")

    def __init__(self):
        self.in_mesh = False
        self.graft_time = 0.0
        self.mesh_time = 0.0
        self.first_message_deliveries = 0.0
        self.mesh_message_deliveries = 0.0
        self.mesh_message_deliveries_active = False
        self.mesh_failure_penalty = 0.0
        self.invalid_message_deliveries = 0.0


class _PeerStats:
    __slots__ = ("connected", "expire", "topics", "ips", "ip_whitelist", "behaviour_penalty")

    def __init__(self):
        self.connected = False
        self.expire = 0.0
        self.topics: dict[str, _TopicStats] = {}
        self.ips: list[str] = []
        self.ip_whitelist: dict[str, bool] = {}
        self.behaviour_penalty = 0.0

    def get_topic_stats(self, topic: str, params: PeerScoreParams) -> _TopicStats | None:
        """Lazily create stats iff the topic is scored (score.go:879-897)."""
        ts = self.topics.get(topic)
        if ts is not None:
            return ts
        if topic not in params.topics:
            return None
        ts = _TopicStats()
        self.topics[topic] = ts
        return ts


class _DeliveryRecord:
    __slots__ = ("status", "first_seen", "validated", "peers")

    def __init__(self, first_seen: float):
        self.status = DELIVERY_UNKNOWN
        self.first_seen = first_seen
        self.validated = 0.0
        self.peers: set[str] | None = set()


class _MessageDeliveries:
    """Record table + FIFO expiry queue (score.go:90-108, 840-877)."""

    def __init__(self, seen_msg_ttl: float, now: Callable[[], float]):
        self._ttl = seen_msg_ttl
        self._now = now
        self.records: dict[str, _DeliveryRecord] = {}
        self._queue: list[tuple[str, float]] = []
        self._head = 0

    def get_record(self, mid: str) -> _DeliveryRecord:
        rec = self.records.get(mid)
        if rec is None:
            now = self._now()
            rec = _DeliveryRecord(now)
            self.records[mid] = rec
            self._queue.append((mid, now + self._ttl))
        return rec

    def gc(self) -> None:
        now = self._now()
        q, h = self._queue, self._head
        while h < len(q) and now > q[h][1]:
            self.records.pop(q[h][0], None)
            h += 1
        if h > 64 and h * 2 > len(q):
            q[:h] = []
            h = 0
        self._head = h


class PeerScore(ev.RawTracerBase):
    """Per-node peer scorer; wired into the router as a RawTracer (score.go:88)."""

    def __init__(self, params: PeerScoreParams, now: Callable[[], float],
                 get_ips: Callable[[str], list[str]] | None = None,
                 id_gen: MsgIdGenerator | None = None):
        self.params = params
        self._now = now
        self._get_ips = get_ips or (lambda p: [])
        self.id_gen = id_gen or MsgIdGenerator()
        self.peer_stats: dict[str, _PeerStats] = {}
        self.peer_ips: dict[str, set[str]] = {}
        seen_ttl = params.seen_msg_ttl or TIME_CACHE_DURATION
        self.deliveries = _MessageDeliveries(seen_ttl, now)
        self._whitelist_nets = [ipaddress.ip_network(c, strict=False)
                                for c in params.ip_colocation_factor_whitelist]
        # debugging inspection (score.go:127-180); called by the node's
        # scheduler. `inspect` receives {peer: score}; `inspect_ex` receives
        # {peer: PeerScoreSnapshot} (ExtendedPeerScoreInspectFn)
        self.inspect: Callable[[dict[str, float]], None] | None = None
        self.inspect_ex: Callable[[dict[str, PeerScoreSnapshot]], None] | None = None
        self.inspect_period: float = 0.0

    # -- scoring (score.go:265-342) --

    def score(self, peer: str) -> float:
        pstats = self.peer_stats.get(peer)
        if pstats is None:
            return 0.0
        score = 0.0
        for topic, ts in pstats.topics.items():
            tp = self.params.topics.get(topic)
            if tp is None:
                continue
            topic_score = 0.0
            # P1: time in mesh, quantized by integer division (score.go:285-291)
            if ts.in_mesh:
                # epsilon guards decimal float quanta (0.3/0.1 -> 2.999...)
                # so truncation matches Go's integer-nanosecond division
                p1 = float(int(ts.mesh_time / tp.time_in_mesh_quantum + 1e-9))
                p1 = min(p1, tp.time_in_mesh_cap)
                topic_score += p1 * tp.time_in_mesh_weight
            # P2: first message deliveries
            topic_score += ts.first_message_deliveries * tp.first_message_deliveries_weight
            # P3: mesh message delivery deficit (squared), only once activated
            if ts.mesh_message_deliveries_active and \
                    ts.mesh_message_deliveries < tp.mesh_message_deliveries_threshold:
                deficit = tp.mesh_message_deliveries_threshold - ts.mesh_message_deliveries
                topic_score += deficit * deficit * tp.mesh_message_deliveries_weight
            # P3b: sticky mesh failure penalty
            topic_score += ts.mesh_failure_penalty * tp.mesh_failure_penalty_weight
            # P4: invalid messages (squared)
            topic_score += (ts.invalid_message_deliveries ** 2) * tp.invalid_message_deliveries_weight
            score += topic_score * tp.topic_weight

        if self.params.topic_score_cap > 0 and score > self.params.topic_score_cap:
            score = self.params.topic_score_cap

        # P5: application-specific
        score += self.params.app_specific_score(peer) * self.params.app_specific_weight
        # P6: IP colocation (squared surplus above threshold)
        score += self.ip_colocation_factor(peer) * self.params.ip_colocation_factor_weight
        # P7: behavioural penalty excess (squared)
        if pstats.behaviour_penalty > self.params.behaviour_penalty_threshold:
            excess = pstats.behaviour_penalty - self.params.behaviour_penalty_threshold
            score += excess * excess * self.params.behaviour_penalty_weight
        return score

    def ip_colocation_factor(self, peer: str) -> float:
        pstats = self.peer_stats.get(peer)
        if pstats is None:
            return 0.0
        result = 0.0
        for ip in pstats.ips:
            if self._whitelist_nets:
                whitelisted = pstats.ip_whitelist.get(ip)
                if whitelisted is None:
                    try:
                        addr = ipaddress.ip_address(ip)
                        whitelisted = any(addr in net for net in self._whitelist_nets)
                    except ValueError:
                        whitelisted = False
                    pstats.ip_whitelist[ip] = whitelisted
                if whitelisted:
                    continue
            peers_in_ip = len(self.peer_ips.get(ip, ()))
            if peers_in_ip > self.params.ip_colocation_factor_threshold:
                surplus = float(peers_in_ip - self.params.ip_colocation_factor_threshold)
                result += surplus * surplus
        return result

    def add_penalty(self, peer: str, count: int) -> None:
        """P7 behavioural penalty, applied by the router (score.go:389-403)."""
        pstats = self.peer_stats.get(peer)
        if pstats is not None:
            pstats.behaviour_penalty += float(count)

    # -- periodic maintenance (score.go:408-445); the node scheduler calls
    # refresh_scores every DecayInterval and refresh_ips/gc every minute --

    def refresh_scores(self) -> None:
        """Decay + retention purge (score.go:504-565)."""
        now = self._now()
        to_delete = []
        for peer, pstats in self.peer_stats.items():
            if not pstats.connected:
                if now > pstats.expire:
                    to_delete.append(peer)
                continue  # retained scores don't decay
            for topic, ts in pstats.topics.items():
                tp = self.params.topics.get(topic)
                if tp is None:
                    continue
                ts.first_message_deliveries *= tp.first_message_deliveries_decay
                if ts.first_message_deliveries < self.params.decay_to_zero:
                    ts.first_message_deliveries = 0.0
                ts.mesh_message_deliveries *= tp.mesh_message_deliveries_decay
                if ts.mesh_message_deliveries < self.params.decay_to_zero:
                    ts.mesh_message_deliveries = 0.0
                ts.mesh_failure_penalty *= tp.mesh_failure_penalty_decay
                if ts.mesh_failure_penalty < self.params.decay_to_zero:
                    ts.mesh_failure_penalty = 0.0
                ts.invalid_message_deliveries *= tp.invalid_message_deliveries_decay
                if ts.invalid_message_deliveries < self.params.decay_to_zero:
                    ts.invalid_message_deliveries = 0.0
                if ts.in_mesh:
                    ts.mesh_time = now - ts.graft_time
                    if ts.mesh_time > tp.mesh_message_deliveries_activation:
                        ts.mesh_message_deliveries_active = True
            pstats.behaviour_penalty *= self.params.behaviour_penalty_decay
            if pstats.behaviour_penalty < self.params.decay_to_zero:
                pstats.behaviour_penalty = 0.0
        for peer in to_delete:
            pstats = self.peer_stats.pop(peer)
            self._remove_ips(peer, pstats.ips)

    def refresh_ips(self) -> None:
        """Re-resolve IPs of connected peers (score.go:567-585)."""
        for peer, pstats in self.peer_stats.items():
            if pstats.connected:
                ips = list(self._get_ips(peer))
                self._set_ips(peer, ips, pstats.ips)
                pstats.ips = ips

    def gc_delivery_records(self) -> None:
        self.deliveries.gc()

    def inspect_scores(self) -> None:
        """Dump tracked scores into the inspector(s) (score.go:446-460)."""
        if self.inspect is not None:
            self.inspect({p: self.score(p) for p in self.peer_stats})
        if self.inspect_ex is not None:
            self.inspect_ex(self.dump_snapshots())

    def dump_snapshots(self) -> dict[str, PeerScoreSnapshot]:
        """Extended per-peer decomposition (score.go:462-500
        inspectScoresExtended): raw per-topic counters, raw app-specific
        score and IP-colocation factor (unweighted, as the reference dumps
        them), and the behaviour-penalty counter. TimeInMesh reports the
        stored mesh_time, refreshed each decay pass, and only for peers
        currently in the mesh — exactly the reference's `if ts.inMesh`."""
        out: dict[str, PeerScoreSnapshot] = {}
        for p, pstats in self.peer_stats.items():
            topics: dict[str, TopicScoreSnapshot] = {}
            for topic, ts in pstats.topics.items():
                tss = TopicScoreSnapshot(
                    first_message_deliveries=ts.first_message_deliveries,
                    mesh_message_deliveries=ts.mesh_message_deliveries,
                    invalid_message_deliveries=ts.invalid_message_deliveries)
                if ts.in_mesh:
                    tss.time_in_mesh = ts.mesh_time
                topics[topic] = tss
            out[p] = PeerScoreSnapshot(
                score=self.score(p),
                topics=topics,
                app_specific_score=self.params.app_specific_score(p),
                ip_colocation_factor=self.ip_colocation_factor(p),
                behaviour_penalty=pstats.behaviour_penalty)
        return out

    # -- RawTracer hooks (score.go:594-838) --

    def add_peer(self, peer: str, proto: str) -> None:
        pstats = self.peer_stats.setdefault(peer, _PeerStats())
        pstats.connected = True
        ips = list(self._get_ips(peer))
        self._set_ips(peer, ips, pstats.ips)
        pstats.ips = ips

    def remove_peer(self, peer: str) -> None:
        pstats = self.peer_stats.get(peer)
        if pstats is None:
            return
        # only retain non-positive scores, to dissuade score-reset attacks
        if self.score(peer) > 0:
            self._remove_ips(peer, pstats.ips)
            del self.peer_stats[peer]
            return
        for topic, ts in pstats.topics.items():
            ts.first_message_deliveries = 0.0
            threshold = self.params.topics[topic].mesh_message_deliveries_threshold
            if ts.in_mesh and ts.mesh_message_deliveries_active \
                    and ts.mesh_message_deliveries < threshold:
                deficit = threshold - ts.mesh_message_deliveries
                ts.mesh_failure_penalty += deficit * deficit
            ts.in_mesh = False
        pstats.connected = False
        pstats.expire = self._now() + self.params.retain_score

    def graft(self, peer: str, topic: str) -> None:
        pstats = self.peer_stats.get(peer)
        if pstats is None:
            return
        ts = pstats.get_topic_stats(topic, self.params)
        if ts is None:
            return
        ts.in_mesh = True
        ts.graft_time = self._now()
        ts.mesh_time = 0.0
        ts.mesh_message_deliveries_active = False

    def prune(self, peer: str, topic: str) -> None:
        pstats = self.peer_stats.get(peer)
        if pstats is None:
            return
        ts = pstats.get_topic_stats(topic, self.params)
        if ts is None:
            return
        threshold = self.params.topics[topic].mesh_message_deliveries_threshold
        if ts.mesh_message_deliveries_active and ts.mesh_message_deliveries < threshold:
            deficit = threshold - ts.mesh_message_deliveries
            ts.mesh_failure_penalty += deficit * deficit
        ts.in_mesh = False

    def validate_message(self, msg: Message) -> None:
        # create the record early for an accurate first-seen time (score.go:693-700)
        self.deliveries.get_record(self.id_gen.id(msg))

    def deliver_message(self, msg: Message) -> None:
        self._mark_first_message_delivery(msg.received_from, msg)
        drec = self.deliveries.get_record(self.id_gen.id(msg))
        if drec.status != DELIVERY_UNKNOWN:
            return
        drec.status = DELIVERY_VALID
        drec.validated = self._now()
        for p in drec.peers or ():
            if p != msg.received_from:
                self._mark_duplicate_message_delivery(p, msg, None)

    def reject_message(self, msg: Message, reason: str) -> None:
        if reason in (ev.REJECT_MISSING_SIGNATURE, ev.REJECT_INVALID_SIGNATURE,
                      ev.REJECT_UNEXPECTED_SIGNATURE, ev.REJECT_UNEXPECTED_AUTH_INFO,
                      ev.REJECT_SELF_ORIGIN):
            # no delivery tracking, but the forwarder is clearly misbehaving
            self._mark_invalid_message_delivery(msg.received_from, msg)
            return
        if reason in (ev.REJECT_BLACKLISTED_PEER, ev.REJECT_BLACKLISTED_SOURCE,
                      ev.REJECT_VALIDATION_QUEUE_FULL):
            return
        drec = self.deliveries.get_record(self.id_gen.id(msg))
        if drec.status != DELIVERY_UNKNOWN:
            return
        if reason == ev.REJECT_VALIDATION_THROTTLED:
            drec.status = DELIVERY_THROTTLED
            drec.peers = None
            return
        if reason == ev.REJECT_VALIDATION_IGNORED:
            drec.status = DELIVERY_IGNORED
            drec.peers = None
            return
        drec.status = DELIVERY_INVALID
        self._mark_invalid_message_delivery(msg.received_from, msg)
        for p in drec.peers or ():
            self._mark_invalid_message_delivery(p, msg)
        drec.peers = None

    def duplicate_message(self, msg: Message) -> None:
        drec = self.deliveries.get_record(self.id_gen.id(msg))
        if drec.peers is not None and msg.received_from in drec.peers:
            return  # already seen this duplicate
        if drec.status == DELIVERY_UNKNOWN:
            assert drec.peers is not None
            drec.peers.add(msg.received_from)
        elif drec.status == DELIVERY_VALID:
            assert drec.peers is not None
            drec.peers.add(msg.received_from)
            self._mark_duplicate_message_delivery(msg.received_from, msg, drec.validated)
        elif drec.status == DELIVERY_INVALID:
            self._mark_invalid_message_delivery(msg.received_from, msg)
        # throttled/ignored: do nothing

    # -- delivery marking (score.go:899-981) --

    def _mark_invalid_message_delivery(self, peer: str | None, msg: Message) -> None:
        pstats = self.peer_stats.get(peer)  # type: ignore[arg-type]
        if pstats is None:
            return
        ts = pstats.get_topic_stats(msg.topic, self.params)
        if ts is None:
            return
        ts.invalid_message_deliveries += 1.0

    def _mark_first_message_delivery(self, peer: str | None, msg: Message) -> None:
        pstats = self.peer_stats.get(peer)  # type: ignore[arg-type]
        if pstats is None:
            return
        ts = pstats.get_topic_stats(msg.topic, self.params)
        if ts is None:
            return
        tp = self.params.topics[msg.topic]
        ts.first_message_deliveries = min(
            ts.first_message_deliveries + 1.0, tp.first_message_deliveries_cap)
        if ts.in_mesh:
            ts.mesh_message_deliveries = min(
                ts.mesh_message_deliveries + 1.0, tp.mesh_message_deliveries_cap)

    def _mark_duplicate_message_delivery(self, peer: str | None, msg: Message,
                                         validated: float | None) -> None:
        pstats = self.peer_stats.get(peer)  # type: ignore[arg-type]
        if pstats is None:
            return
        ts = pstats.get_topic_stats(msg.topic, self.params)
        if ts is None or not ts.in_mesh:
            return
        tp = self.params.topics[msg.topic]
        # validated=None means delivery during validation: always in-window
        if validated is not None and \
                self._now() - validated > tp.mesh_message_deliveries_window:
            return
        ts.mesh_message_deliveries = min(
            ts.mesh_message_deliveries + 1.0, tp.mesh_message_deliveries_cap)

    # -- topic param swap with counter recapping (score.go:196-241) --

    def set_topic_score_params(self, topic: str, p: TopicScoreParams) -> None:
        old = self.params.topics.get(topic)
        self.params.topics[topic] = p
        if old is None:
            return
        recap = (p.first_message_deliveries_cap < old.first_message_deliveries_cap
                 or p.mesh_message_deliveries_cap < old.mesh_message_deliveries_cap)
        if not recap:
            return
        for pstats in self.peer_stats.values():
            ts = pstats.topics.get(topic)
            if ts is None:
                continue
            ts.first_message_deliveries = min(
                ts.first_message_deliveries, p.first_message_deliveries_cap)
            ts.mesh_message_deliveries = min(
                ts.mesh_message_deliveries, p.mesh_message_deliveries_cap)

    # -- IP tracking (score.go:1031-1081) --

    def _set_ips(self, peer: str, newips: list[str], oldips: list[str]) -> None:
        for ip in newips:
            if ip not in oldips:
                self.peer_ips.setdefault(ip, set()).add(peer)
        for ip in oldips:
            if ip not in newips:
                peers = self.peer_ips.get(ip)
                if peers is not None:
                    peers.discard(peer)
                    if not peers:
                        del self.peer_ips[ip]

    def _remove_ips(self, peer: str, ips: list[str]) -> None:
        for ip in ips:
            peers = self.peer_ips.get(ip)
            if peers is not None:
                peers.discard(peer)
                if not peers:
                    del self.peer_ips[ip]
