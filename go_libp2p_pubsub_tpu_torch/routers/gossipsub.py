"""GossipSubRouter (host-side functional core): gossipsub v1.1 (gossipsub.go).

Mesh overlay (GRAFT/PRUNE) + lazy gossip (IHAVE/IWANT), fanout, heartbeat
maintenance, PX, direct peers, flood publish, opportunistic grafting, RPC
fragmentation, scoring + gater + promise-tracker integration. Runs on the
deterministic scheduler (heartbeat timer -> scheduler event, PX connector ->
scheduled connect) with node-seeded RNG instead of Go's global shuffles.
"""

from __future__ import annotations

import logging
import random
import time
from typing import TYPE_CHECKING

from ..core.params import GossipSubParams, PeerScoreParams, PeerScoreThresholds
from ..core.types import (
    RPC,
    AcceptStatus,
    ControlGraft,
    ControlIHave,
    ControlIWant,
    ControlMessage,
    ControlPrune,
    Message,
    PeerID,
    PeerInfo,
)
from ..utils.mcache import MessageCache
from .feat import (
    GOSSIPSUB_ID_V10,
    GOSSIPSUB_ID_V11,
    GossipSubFeature,
    GossipSubFeatureTest,
    default_features,
)
from .floodsub import FLOODSUB_ID
from .gossip_tracer import GossipPromiseTracker
from .score import PeerScore

if TYPE_CHECKING:
    from ..api.pubsub import PubSub


class GossipSubRouter:
    """gossipsub.go:420-477."""

    def __init__(self, params: GossipSubParams | None = None, *,
                 score_params: PeerScoreParams | None = None,
                 thresholds: PeerScoreThresholds | None = None,
                 direct_peers: list[PeerID] | None = None,
                 do_px: bool = False,
                 flood_publish: bool = False,
                 gater=None,
                 feature_test: GossipSubFeatureTest = default_features,
                 protocols: list[str] | None = None):
        self.p: "PubSub | None" = None
        self.params = params or GossipSubParams()
        self.peers: dict[PeerID, str] = {}
        self.direct: set[PeerID] = set(direct_peers or ())
        self.mesh: dict[str, set[PeerID]] = {}
        self.fanout: dict[str, set[PeerID]] = {}
        self.lastpub: dict[str, float] = {}
        self.gossip: dict[PeerID, list[ControlIHave]] = {}
        self.control: dict[PeerID, ControlMessage] = {}
        self.peerhave: dict[PeerID, int] = {}
        self.iasked: dict[PeerID, int] = {}
        self.outbound: dict[PeerID, bool] = {}
        self.backoff: dict[str, dict[PeerID, float]] = {}
        self.protos = list(protocols or [GOSSIPSUB_ID_V11, GOSSIPSUB_ID_V10,
                                         FLOODSUB_ID])
        self.feature = feature_test

        self.do_px = do_px
        self.flood_publish = flood_publish
        self.heartbeat_ticks = 0
        th = thresholds or PeerScoreThresholds()
        self.accept_px_threshold = th.accept_px_threshold
        self.gossip_threshold = th.gossip_threshold
        self.publish_threshold = th.publish_threshold
        self.graylist_threshold = th.graylist_threshold
        self.opportunistic_graft_threshold = th.opportunistic_graft_threshold

        self._score_params = score_params
        self._inspect_fn = None
        self._inspect_ex_fn = None
        self._inspect_period = 0.0
        self.score: PeerScore | None = None
        self.gossip_tracer: GossipPromiseTracker | None = None
        self.gate = gater
        self.tag_tracer = None  # wired in attach (connmgr decaying tags)
        self.mcache = MessageCache(self.params.history_gossip,
                                   self.params.history_length)
        self.rng = random.Random(0)
        self._pending_connects: list[PeerInfo] = []

    # -- scoring accessor: 0 when scoring disabled (score.go nil receiver) --

    def _score_of(self, peer: PeerID) -> float:
        return self.score.score(peer) if self.score is not None else 0.0

    def with_peer_score_inspect(self, inspect, period: float, *,
                                extended: bool = False) -> None:
        """WithPeerScoreInspect (score.go:143-180): register a periodic
        score-debugging callback — ``{peer: score}`` by default, or
        ``{peer: PeerScoreSnapshot}`` with ``extended=True`` (the
        ExtendedPeerScoreInspectFn variant). Must be configured with
        scoring enabled and at most once, as the reference enforces."""
        if self._score_params is None:
            raise ValueError("peer scoring is not enabled")
        if self._inspect_fn is not None or self._inspect_ex_fn is not None:
            raise ValueError("duplicate peer score inspector")
        if period <= 0:
            # a zero-period ticker would wedge the virtual clock (Go's
            # time.NewTicker panics on non-positive periods)
            raise ValueError("inspect period must be positive")
        if extended:
            self._inspect_ex_fn = inspect
        else:
            self._inspect_fn = inspect
        self._inspect_period = period
        if self.score is not None:          # post-attach registration
            self._wire_inspect(self.p.scheduler)

    def _wire_inspect(self, sched) -> None:
        self.score.inspect = self._inspect_fn
        self.score.inspect_ex = self._inspect_ex_fn
        self.score.inspect_period = self._inspect_period
        sched.call_every(self._inspect_period, self.score.inspect_scores)

    # -- Router interface --

    def protocols(self) -> list[str]:
        return list(self.protos)

    def attach(self, p: "PubSub") -> None:
        """gossipsub.go:488-523."""
        self.p = p
        self.rng = p.rng
        sched = p.scheduler
        if self._score_params is not None:
            self.score = PeerScore(self._score_params, sched.now,
                                   get_ips=p.host.conns_to_peer, id_gen=p.id_gen)
            p.tracer.add_raw(self.score)
            self.gossip_tracer = GossipPromiseTracker(
                sched.now, self.params.iwant_followup_time, rng=self.rng,
                id_gen=p.id_gen)
            p.tracer.add_raw(self.gossip_tracer)
            # score background tickers (score.go:408-445)
            decay = self._score_params.decay_interval or 1.0
            sched.call_every(decay, self.score.refresh_scores)
            sched.call_every(60.0, self.score.refresh_ips)
            sched.call_every(60.0, self.score.gc_delivery_records)
            if self._inspect_fn is not None or self._inspect_ex_fn is not None:
                self._wire_inspect(sched)
        if self.gate is not None:
            self.gate.attach(p)
            p.tracer.add_raw(self.gate)
        # connmgr tag tracer (NewGossipSub wires rt.tagTracer, gossipsub.go:208-212)
        from .tag_tracer import TagTracer
        self.tag_tracer = TagTracer(p.host.conn_manager, id_gen=p.id_gen,
                                    direct=self.direct)
        p.tracer.add_raw(self.tag_tracer)
        self.mcache.set_msg_id_fn(p.id_gen.id)
        sched.call_every(self.params.heartbeat_interval, self.heartbeat,
                         initial_delay=self.params.heartbeat_initial_delay)
        if self.direct:
            sched.call_later(self.params.direct_connect_initial_delay,
                             self._connect_direct)

    def add_peer(self, peer: PeerID, proto: str) -> None:
        """gossipsub.go:525-556; connection direction from the substrate."""
        self.peers[peer] = proto
        assert self.p is not None
        self.outbound[peer] = self.p.host.conns.get(peer) == "outbound"

    def remove_peer(self, peer: PeerID) -> None:
        """gossipsub.go:558-567."""
        self.peers.pop(peer, None)
        for peers in self.mesh.values():
            peers.discard(peer)
        for peers in self.fanout.values():
            peers.discard(peer)
        self.gossip.pop(peer, None)
        self.control.pop(peer, None)
        self.outbound.pop(peer, None)

    def enough_peers(self, topic: str, suggested: int) -> bool:
        """gossipsub.go:569-595."""
        assert self.p is not None
        tmap = self.p.topics.get(topic)
        if tmap is None:
            return False
        fs_peers = sum(1 for p in tmap
                       if not self.feature(GossipSubFeature.MESH, self.peers.get(p, "")))
        gs_peers = len(self.mesh.get(topic, ()))
        if suggested == 0:
            suggested = self.params.dlo
        return fs_peers + gs_peers >= suggested or gs_peers >= self.params.dhi

    def accept_from(self, peer: PeerID) -> AcceptStatus:
        """gossipsub.go:597-609."""
        if peer in self.direct:
            return AcceptStatus.ACCEPT_ALL
        if self._score_of(peer) < self.graylist_threshold:
            return AcceptStatus.ACCEPT_NONE
        if self.gate is not None:
            return self.gate.accept_from(peer)
        return AcceptStatus.ACCEPT_ALL

    def handle_rpc(self, rpc: RPC) -> None:
        """gossipsub.go:611-628."""
        ctl = rpc.control
        if ctl is None or ctl.is_empty():
            return
        src = rpc.from_peer
        assert src is not None
        iwant = self.handle_ihave(src, ctl)
        ihave = self.handle_iwant(src, ctl)
        prune = self.handle_graft(src, ctl)
        self.handle_prune(src, ctl)
        if not iwant and not ihave and not prune:
            return
        out = RPC(publish=ihave,
                  control=ControlMessage(iwant=iwant, prune=prune))
        self.send_rpc(src, out)

    # -- control handlers --

    def handle_ihave(self, peer: PeerID, ctl: ControlMessage) -> list[ControlIWant]:
        """gossipsub.go:630-696."""
        assert self.p is not None
        if self._score_of(peer) < self.gossip_threshold:
            return []
        self.peerhave[peer] = self.peerhave.get(peer, 0) + 1
        if self.peerhave[peer] > self.params.max_ihave_messages:
            return []
        if self.iasked.get(peer, 0) >= self.params.max_ihave_length:
            return []
        iwant: dict[str, None] = {}
        for ihave in ctl.ihave:
            topic = ihave.topic
            if topic not in self.mesh:
                continue
            if not self.p.peer_filter(peer, topic):
                continue
            for mid in ihave.message_ids:
                if self.p.seen.has(mid):
                    continue
                iwant[mid] = None
        if not iwant:
            return []
        iask = min(len(iwant), self.params.max_ihave_length - self.iasked.get(peer, 0))
        lst = list(iwant)
        self.rng.shuffle(lst)
        lst = lst[:iask]
        self.iasked[peer] = self.iasked.get(peer, 0) + iask
        if self.gossip_tracer is not None:
            self.gossip_tracer.add_promise(peer, lst)
        return [ControlIWant(message_ids=lst)]

    def handle_iwant(self, peer: PeerID, ctl: ControlMessage) -> list[Message]:
        """gossipsub.go:698-739."""
        assert self.p is not None
        if self._score_of(peer) < self.gossip_threshold:
            return []
        ihave: dict[str, Message] = {}
        for iwant in ctl.iwant:
            for mid in iwant.message_ids:
                msg, count = self.mcache.get_for_peer(mid, peer)
                if msg is None:
                    continue
                if not self.p.peer_filter(peer, msg.topic):
                    continue
                if count > self.params.gossip_retransmission:
                    continue
                ihave[mid] = msg
        return list(ihave.values())

    def handle_graft(self, peer: PeerID, ctl: ControlMessage) -> list[ControlPrune]:
        """gossipsub.go:741-837."""
        assert self.p is not None
        prune: list[str] = []
        do_px = self.do_px
        score = self._score_of(peer)
        now = self.p.scheduler.now()
        for graft in ctl.graft:
            topic = graft.topic
            if not self.p.peer_filter(peer, topic):
                continue
            peers = self.mesh.get(topic)
            if peers is None:
                # unknown topic: no PX (don't leak peers), spam hardening
                do_px = False
                continue
            if peer in peers:
                continue
            if peer in self.direct:
                prune.append(topic)
                do_px = False
                continue
            expire = self.backoff.get(topic, {}).get(peer)
            if expire is not None and now < expire:
                # graft during backoff: behaviour penalty (+flood extra)
                if self.score is not None:
                    self.score.add_penalty(peer, 1)
                do_px = False
                flood_cutoff = expire + self.params.graft_flood_threshold \
                    - self.params.prune_backoff
                if now < flood_cutoff and self.score is not None:
                    self.score.add_penalty(peer, 1)
                self.add_backoff(peer, topic, is_unsubscribe=False)
                prune.append(topic)
                continue
            if score < 0:
                prune.append(topic)
                do_px = False
                self.add_backoff(peer, topic, is_unsubscribe=False)
                continue
            if len(peers) >= self.params.dhi and not self.outbound.get(peer, False):
                prune.append(topic)
                self.add_backoff(peer, topic, is_unsubscribe=False)
                continue
            self.p.tracer.graft(peer, topic)
            peers.add(peer)
        return [self.make_prune(peer, t, do_px, False) for t in prune]

    def handle_prune(self, peer: PeerID, ctl: ControlMessage) -> None:
        """gossipsub.go:839-871."""
        assert self.p is not None
        score = self._score_of(peer)
        for pr in ctl.prune:
            topic = pr.topic
            peers = self.mesh.get(topic)
            if peers is None:
                continue
            self.p.tracer.prune(peer, topic)
            peers.discard(peer)
            if pr.backoff > 0:
                self.do_add_backoff(peer, topic, pr.backoff)
            else:
                self.add_backoff(peer, topic, is_unsubscribe=False)
            if pr.peers:
                if score < self.accept_px_threshold:
                    continue
                self.px_connect(pr.peers)

    def add_backoff(self, peer: PeerID, topic: str, is_unsubscribe: bool) -> None:
        interval = self.params.unsubscribe_backoff if is_unsubscribe \
            else self.params.prune_backoff
        self.do_add_backoff(peer, topic, interval)

    def do_add_backoff(self, peer: PeerID, topic: str, interval: float) -> None:
        """gossipsub.go:880-891 (keeps the later expiry)."""
        assert self.p is not None
        backoff = self.backoff.setdefault(topic, {})
        expire = self.p.scheduler.now() + interval
        if backoff.get(peer, 0.0) < expire:
            backoff[peer] = expire

    def px_connect(self, peers: list[PeerInfo]) -> None:
        """gossipsub.go:893-943: dial up to PrunePeers learned peers, bounded
        pending queue, via the scheduler (the connector goroutines). A
        PeerInfo carrying a signed record must validate — envelope signature
        over the peer-record domain AND record id matching the announced id
        — or the peer is skipped entirely (gossipsub.go:909-926)."""
        assert self.p is not None
        from ..api.peer_record import RecordError, consume_peer_record

        if len(peers) > self.params.prune_peers:
            peers = list(peers)
            self.rng.shuffle(peers)
            peers = peers[:self.params.prune_peers]
        for pi in peers:
            if pi.peer_id in self.peers:
                continue
            if pi.signed_peer_record is not None:
                try:
                    rec = consume_peer_record(pi.signed_peer_record)
                except RecordError:
                    continue    # bogus envelope obtained through px
                if rec.peer_id != pi.peer_id:
                    continue    # record doesn't certify the announced peer
            if len(self._pending_connects) >= self.params.max_pending_connections:
                break
            self._pending_connects.append(pi)
        if self._pending_connects:
            self.p.scheduler.call_later(0.0, self._drain_connects)

    def _drain_connects(self) -> None:
        assert self.p is not None
        pending, self._pending_connects = self._pending_connects, []
        for pi in pending:
            other = self.p.host.network.hosts.get(pi.peer_id)
            if other is not None and pi.peer_id not in self.p.host.conns:
                if self.p.host.connect(other) \
                        and pi.signed_peer_record is not None:
                    # validated in px_connect; persist like ConsumePeerRecord
                    # only after the dial succeeds (gossipsub.go:954-958)
                    self.p.host.certified_records[pi.peer_id] = \
                        pi.signed_peer_record

    def _connect_direct(self) -> None:
        assert self.p is not None
        for peer in sorted(self.direct):
            if peer not in self.peers:
                other = self.p.host.network.hosts.get(peer)
                if other is not None:
                    self.p.host.connect(other)

    # -- publish (gossipsub.go:975-1045) --

    def publish(self, msg: Message) -> None:
        assert self.p is not None
        self.mcache.put(msg)
        src = msg.received_from
        topic = msg.topic
        tmap = self.p.topics.get(topic)
        if not tmap:
            return
        tosend: set[PeerID] = set()
        if self.flood_publish and src == self.p.pid:
            for pr in tmap:
                if pr in self.direct or self._score_of(pr) >= self.publish_threshold:
                    tosend.add(pr)
        else:
            for pr in self.direct:
                if pr in tmap:
                    tosend.add(pr)
            for pr in tmap:
                if not self.feature(GossipSubFeature.MESH, self.peers.get(pr, "")) \
                        and self._score_of(pr) >= self.publish_threshold:
                    tosend.add(pr)
            gmap = self.mesh.get(topic)
            if gmap is None:
                gmap = self.fanout.get(topic)
                if not gmap:
                    plst = self.get_peers(topic, self.params.d, lambda p: (
                        p not in self.direct
                        and self._score_of(p) >= self.publish_threshold))
                    if plst:
                        gmap = set(plst)
                        self.fanout[topic] = gmap
                    else:
                        gmap = set()
                self.lastpub[topic] = self.p.scheduler.now()
            tosend |= gmap
        for pid in sorted(tosend):
            if pid == src or pid == msg.from_peer:
                continue
            self.send_rpc(pid, RPC(publish=[msg]))

    # -- join/leave (gossipsub.go:1047-1124) --

    def join(self, topic: str) -> None:
        assert self.p is not None
        if topic in self.mesh:
            return
        self.p.tracer.join(topic)
        gmap = self.fanout.get(topic)
        if gmap is not None:
            backoff = self.backoff.get(topic, {})
            gmap = {p for p in gmap
                    if self._score_of(p) >= 0 and p not in backoff}
            if len(gmap) < self.params.d:
                more = self.get_peers(topic, self.params.d - len(gmap), lambda p: (
                    p not in gmap and p not in self.direct and p not in backoff
                    and self._score_of(p) >= 0))
                gmap |= set(more)
            self.mesh[topic] = gmap
            self.fanout.pop(topic, None)
            self.lastpub.pop(topic, None)
        else:
            backoff = self.backoff.get(topic, {})
            gmap = set(self.get_peers(topic, self.params.d, lambda p: (
                p not in self.direct and p not in backoff
                and self._score_of(p) >= 0)))
            self.mesh[topic] = gmap
        for p in sorted(gmap):
            self.p.tracer.graft(p, topic)
            self.send_rpc(p, RPC(control=ControlMessage(
                graft=[ControlGraft(topic=topic)])))

    def leave(self, topic: str) -> None:
        assert self.p is not None
        gmap = self.mesh.pop(topic, None)
        if gmap is None:
            return
        self.p.tracer.leave(topic)
        for p in sorted(gmap):
            self.p.tracer.prune(p, topic)
            self.send_rpc(p, RPC(control=ControlMessage(
                prune=[self.make_prune(p, topic, self.do_px, True)])))
            self.add_backoff(p, topic, is_unsubscribe=True)

    # -- RPC send path with piggybacking + fragmentation --

    def send_rpc(self, peer: PeerID, out: RPC) -> None:
        """gossipsub.go:1138-1202."""
        assert self.p is not None
        ctl = self.control.pop(peer, None)
        if ctl is not None:
            self.piggyback_control(peer, out, ctl)
        ihave = self.gossip.pop(peer, None)
        if ihave is not None:
            if out.control is None:
                out.control = ControlMessage()
            out.control.ihave.extend(ihave)
        if peer not in self.p.peers:
            return
        if out.size() < self.p.max_message_size:
            self._do_send(peer, out)
            return
        for frag in fragment_rpc(out, self.p.max_message_size):
            self._do_send(peer, frag)

    def _do_send(self, peer: PeerID, rpc: RPC) -> None:
        assert self.p is not None
        if self.p.host.send(peer, rpc):
            self.p.tracer.send_rpc(rpc, peer)
        else:
            self.p.tracer.drop_rpc(rpc, peer)
            # re-queue GRAFT/PRUNE for retry; gossip is not retried
            # (gossipsub.go:1285-1300 doDropRPC/pushControl)
            if rpc.control is not None and (rpc.control.graft or rpc.control.prune):
                self.push_control(peer, ControlMessage(
                    graft=rpc.control.graft, prune=rpc.control.prune))

    def push_control(self, peer: PeerID, ctl: ControlMessage) -> None:
        if ctl.graft or ctl.prune:
            existing = self.control.get(peer)
            if existing is None:
                self.control[peer] = ControlMessage(graft=list(ctl.graft),
                                                    prune=list(ctl.prune))
            else:
                existing.graft.extend(ctl.graft)
                existing.prune.extend(ctl.prune)

    def piggyback_control(self, peer: PeerID, out: RPC, ctl: ControlMessage) -> None:
        """Drop stale retries (gossipsub.go:1822-1864)."""
        tograft = [g for g in ctl.graft if peer in self.mesh.get(g.topic, set())]
        toprune = [pr for pr in ctl.prune if peer not in self.mesh.get(pr.topic, set())]
        if not tograft and not toprune:
            return
        if out.control is None:
            out.control = ControlMessage()
        out.control.graft.extend(tograft)
        out.control.prune.extend(toprune)

    def make_prune(self, peer: PeerID, topic: str, do_px: bool,
                   is_unsubscribe: bool) -> ControlPrune:
        """gossipsub.go:1866-1906."""
        assert self.p is not None
        if not self.feature(GossipSubFeature.PX, self.peers.get(peer, "")):
            return ControlPrune(topic=topic)
        backoff = self.params.unsubscribe_backoff if is_unsubscribe \
            else self.params.prune_backoff
        px: list[PeerInfo] = []
        if do_px:
            plst = self.get_peers(topic, self.params.prune_peers, lambda xp: (
                xp != peer and self._score_of(xp) >= 0))
            # attach the signed record when the certified store has one;
            # otherwise just the id — unsigned PX addresses can't be
            # trusted anyway (gossipsub.go:1885-1901)
            px = [PeerInfo(peer_id=p,
                           signed_peer_record=(
                               self.p.host.certified_records.get(p)))
                  for p in plst]
        return ControlPrune(topic=topic, peers=px, backoff=backoff)

    def get_peers(self, topic: str, count: int, flt) -> list[PeerID]:
        """Random topic peers passing the filter (gossipsub.go:1908-1928)."""
        assert self.p is not None
        tmap = self.p.topics.get(topic)
        if not tmap:
            return []
        peers = [p for p in sorted(tmap)
                 if self.feature(GossipSubFeature.MESH, self.peers.get(p, ""))
                 and flt(p) and self.p.peer_filter(p, topic)]
        self.rng.shuffle(peers)
        if 0 < count < len(peers):
            peers = peers[:count]
        return peers

    # -- heartbeat (gossipsub.go:1345-1606) --

    def heartbeat(self) -> None:
        """Timed wrapper: warn when one heartbeat burns more wall-clock than
        slow_heartbeat_warning x the (virtual) interval — the reference's
        slow-heartbeat observability (gossipsub.go:1346-1354)."""
        start = time.perf_counter()
        try:
            self._heartbeat()
        finally:
            if self.params.slow_heartbeat_warning > 0:
                dt = time.perf_counter() - start
                slow = (self.params.slow_heartbeat_warning *
                        self.params.heartbeat_interval)
                if dt > slow:
                    logging.getLogger(__name__).warning(
                        "slow heartbeat: took %.3fs (interval %.1fs)",
                        dt, self.params.heartbeat_interval)

    def _heartbeat(self) -> None:
        assert self.p is not None
        self.heartbeat_ticks += 1
        tograft: dict[PeerID, list[str]] = {}
        toprune: dict[PeerID, list[str]] = {}
        no_px: dict[PeerID, bool] = {}

        self.clear_backoff()
        self.peerhave.clear()
        self.iasked.clear()
        self.apply_iwant_penalties()
        if self.heartbeat_ticks % self.params.direct_connect_ticks == 0 \
                and self.direct:
            self._connect_direct()

        scores: dict[PeerID, float] = {}

        def score(p: PeerID) -> float:
            if p not in scores:
                scores[p] = self._score_of(p)
            return scores[p]

        for topic, peers in self.mesh.items():
            def prune_peer(p: PeerID, topic=topic, peers=peers):
                self.p.tracer.prune(p, topic)
                peers.discard(p)
                self.add_backoff(p, topic, is_unsubscribe=False)
                toprune.setdefault(p, []).append(topic)

            def graft_peer(p: PeerID, topic=topic, peers=peers):
                self.p.tracer.graft(p, topic)
                peers.add(p)
                tograft.setdefault(p, []).append(topic)

            # drop negative-score peers, no PX
            for p in sorted(peers):
                if score(p) < 0:
                    prune_peer(p)
                    no_px[p] = True

            backoff = self.backoff.get(topic, {})
            # undersubscription
            if len(peers) < self.params.dlo:
                ineed = self.params.d - len(peers)
                for p in self.get_peers(topic, ineed, lambda p: (
                        p not in peers and p not in backoff
                        and p not in self.direct and score(p) >= 0)):
                    graft_peer(p)

            # oversubscription (gossipsub.go:1430-1490)
            if len(peers) > self.params.dhi:
                plst = sorted(peers)
                self.rng.shuffle(plst)
                plst.sort(key=lambda p: -score(p))
                tail = plst[self.params.dscore:]
                self.rng.shuffle(tail)
                plst[self.params.dscore:] = tail
                outbound = sum(1 for p in plst[:self.params.d]
                               if self.outbound.get(p, False))
                if outbound < self.params.dout:
                    def rotate(i):
                        p = plst.pop(i)
                        plst.insert(0, p)
                    if outbound > 0:
                        ihave_ct = outbound
                        i = 1
                        while i < self.params.d and ihave_ct > 0:
                            if self.outbound.get(plst[i], False):
                                rotate(i)
                                ihave_ct -= 1
                            i += 1
                    ineed = self.params.dout - outbound
                    i = self.params.d
                    while i < len(plst) and ineed > 0:
                        if self.outbound.get(plst[i], False):
                            rotate(i)
                            ineed -= 1
                        i += 1
                for p in plst[self.params.d:]:
                    prune_peer(p)

            # outbound quota (gossipsub.go:1493-1518)
            if len(peers) >= self.params.dlo:
                outbound = sum(1 for p in peers if self.outbound.get(p, False))
                if outbound < self.params.dout:
                    ineed = self.params.dout - outbound
                    for p in self.get_peers(topic, ineed, lambda p: (
                            p not in peers and p not in backoff
                            and p not in self.direct
                            and self.outbound.get(p, False) and score(p) >= 0)):
                        graft_peer(p)

            # opportunistic grafting (gossipsub.go:1521-1552)
            if self.heartbeat_ticks % self.params.opportunistic_graft_ticks == 0 \
                    and len(peers) > 1:
                plst = sorted(peers, key=score)
                median_score = score(plst[len(plst) // 2])
                if median_score < self.opportunistic_graft_threshold:
                    for p in self.get_peers(
                            topic, self.params.opportunistic_graft_peers,
                            lambda p: (p not in peers and p not in backoff
                                       and p not in self.direct
                                       and score(p) > median_score)):
                        graft_peer(p)

            self.emit_gossip(topic, peers)

        # fanout expiry + maintenance (gossipsub.go:1560-1596)
        now = self.p.scheduler.now()
        for topic in list(self.lastpub):
            if self.lastpub[topic] + self.params.fanout_ttl < now:
                self.fanout.pop(topic, None)
                del self.lastpub[topic]
        for topic, peers in self.fanout.items():
            tmap = self.p.topics.get(topic, set())
            for p in sorted(peers):
                if p not in tmap or score(p) < self.publish_threshold:
                    peers.discard(p)
            if len(peers) < self.params.d:
                for p in self.get_peers(topic, self.params.d - len(peers),
                                        lambda p: (p not in peers
                                                   and p not in self.direct
                                                   and score(p) >= self.publish_threshold)):
                    peers.add(p)
            self.emit_gossip(topic, peers)

        self.send_graft_prune(tograft, toprune, no_px)
        self.flush()
        self.mcache.shift()

    def apply_iwant_penalties(self) -> None:
        if self.gossip_tracer is not None and self.score is not None:
            for p, count in self.gossip_tracer.get_broken_promises().items():
                self.score.add_penalty(p, count)

    def clear_backoff(self) -> None:
        """Every 15 ticks, expire with 2-heartbeat slack (gossipsub.go:1627-1646)."""
        if self.heartbeat_ticks % 15 != 0:
            return
        assert self.p is not None
        now = self.p.scheduler.now()
        for topic in list(self.backoff):
            bk = self.backoff[topic]
            for p in list(bk):
                if bk[p] + 2 * self.params.heartbeat_interval < now:
                    del bk[p]
            if not bk:
                del self.backoff[topic]

    def send_graft_prune(self, tograft, toprune, no_px) -> None:
        """Coalesced per-peer GRAFT/PRUNE (gossipsub.go:1672-1707)."""
        for p, topics in tograft.items():
            graft = [ControlGraft(topic=t) for t in topics]
            prune = []
            pruning = toprune.pop(p, None)
            if pruning:
                prune = [self.make_prune(p, t, self.do_px and not no_px.get(p, False), False)
                         for t in pruning]
            self.send_rpc(p, RPC(control=ControlMessage(graft=graft, prune=prune)))
        for p, topics in toprune.items():
            prune = [self.make_prune(p, t, self.do_px and not no_px.get(p, False), False)
                     for t in topics]
            self.send_rpc(p, RPC(control=ControlMessage(prune=prune)))

    def emit_gossip(self, topic: str, exclude: set[PeerID]) -> None:
        """gossipsub.go:1711-1775."""
        assert self.p is not None
        mids = self.mcache.get_gossip_ids(topic)
        if not mids:
            return
        self.rng.shuffle(mids)
        tmap = self.p.topics.get(topic, set())
        peers = [p for p in sorted(tmap)
                 if p not in exclude and p not in self.direct
                 and self.feature(GossipSubFeature.MESH, self.peers.get(p, ""))
                 and self._score_of(p) >= self.gossip_threshold]
        target = max(self.params.dlazy,
                     int(self.params.gossip_factor * len(peers)))
        if target < len(peers):
            self.rng.shuffle(peers)
            peers = peers[:target]
        for p in peers:
            peer_mids = mids
            if len(mids) > self.params.max_ihave_length:
                self.rng.shuffle(mids)
                peer_mids = mids[:self.params.max_ihave_length]
            self.gossip.setdefault(p, []).append(
                ControlIHave(topic=topic, message_ids=list(peer_mids)))

    def flush(self) -> None:
        """gossipsub.go:1777-1791."""
        for p in list(self.gossip):
            ihave = self.gossip.pop(p)
            self.send_rpc(p, RPC(control=ControlMessage(ihave=ihave)))
        for p in list(self.control):
            ctl = self.control.pop(p)
            self.send_rpc(p, RPC(control=ControlMessage(graft=ctl.graft,
                                                        prune=ctl.prune)))


def fragment_rpc(rpc: RPC, limit: int) -> list[RPC]:
    """Split an oversized RPC (gossipsub.go:1204-1293). Raises ValueError for
    a single message exceeding the limit."""
    if rpc.size() < limit:
        return [rpc]
    out: list[RPC] = [RPC()]

    def out_rpc(size_to_add: int, with_ctl: bool) -> RPC:
        cur = out[-1]
        if cur.size() + size_to_add + 1 < limit:
            if with_ctl and cur.control is None:
                cur.control = ControlMessage()
            return cur
        nxt = RPC(control=ControlMessage() if with_ctl else None)
        out.append(nxt)
        return nxt

    for msg in rpc.publish:
        s = RPC(publish=[msg]).size()
        if s > limit:
            raise ValueError(f"message with len={s} exceeds limit {limit}")
        out_rpc(s, False).publish.append(msg)
    for sub in rpc.subscriptions:
        out_rpc(len(sub.topicid) + 4, False).subscriptions.append(sub)
    ctl = rpc.control
    if ctl is None or ctl.is_empty():
        return out
    whole = RPC(control=ctl)
    if whole.size() < limit:
        out.append(whole)
        return out
    for graft in ctl.graft:
        out_rpc(len(graft.topic) + 4, True).control.graft.append(graft)
    for prune in ctl.prune:
        sz = RPC(control=ControlMessage(prune=[prune])).size()
        out_rpc(sz, True).control.prune.append(prune)
    overhead = 6
    for iwant in ctl.iwant:
        for ids in fragment_message_ids(iwant.message_ids, limit - overhead):
            piece = ControlIWant(message_ids=ids)
            sz = RPC(control=ControlMessage(iwant=[piece])).size()
            out_rpc(sz, True).control.iwant.append(piece)
    for ihave in ctl.ihave:
        for ids in fragment_message_ids(ihave.message_ids, limit - overhead):
            piece = ControlIHave(topic=ihave.topic, message_ids=ids)
            sz = RPC(control=ControlMessage(ihave=[piece])).size()
            out_rpc(sz, True).control.ihave.append(piece)
    return out


def fragment_message_ids(mids: list[str], limit: int) -> list[list[str]]:
    """gossipsub.go:1295-1316."""
    overhead = 2
    out: list[list[str]] = [[]]
    blen = 0
    for mid in mids:
        size = len(mid) + overhead
        if size > limit:
            continue  # pathological single id; dropped like the reference
        blen += size
        if blen > limit:
            out.append([])
            blen = size
        out[-1].append(mid)
    return out
