"""Simulated network substrate: the L0/L1 replacement (SURVEY.md §1).

The reference sits on libp2p hosts with real TCP/QUIC streams and one
goroutine per stream (comm.go). Here the substrate is a deterministic
discrete-event simulation:

- ``Scheduler``: a (time, seq)-ordered event heap driving ONE virtual clock;
  every callback runs to completion before the next (the single-threaded
  ``processLoop`` invariant, pubsub.go:561, holds globally by construction).
- ``Host``: peer identity + addresses + connection table + notifiee fan-out
  (notify.go) + per-protocol stream handlers.
- RPC transfer: ``Host.send`` schedules delivery at now + latency with a
  bounded in-flight cap per (src, dst) modeling the reference's per-peer
  32-slot writer queue with silent-but-traced drops (comm.go:156-191,
  gossipsub.go:1195-1202).

Determinism: event order is (time, seq); all randomness comes from seeded
RNGs owned by nodes.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Callable, Protocol

from ..core.clock import VirtualClock
from ..core.params import DEFAULT_PEER_OUTBOUND_QUEUE_SIZE
from ..core.types import RPC, PeerID


class Scheduler:
    def __init__(self):
        self.clock = VirtualClock()
        self._heap: list[tuple[float, int, Callable[[], None]]] = []
        self._seq = itertools.count()

    def now(self) -> float:
        return self.clock.now()

    def call_at(self, t: float, fn: Callable[[], None]) -> None:
        if t < self.now():
            raise ValueError("scheduling into the past")
        heapq.heappush(self._heap, (t, next(self._seq), fn))

    def call_later(self, dt: float, fn: Callable[[], None]) -> None:
        self.call_at(self.now() + dt, fn)

    def call_every(self, interval: float, fn: Callable[[], None],
                   initial_delay: float | None = None) -> Callable[[], None]:
        """Periodic timer; returns a cancel function."""
        cancelled = False

        def tick():
            if cancelled:
                return
            fn()
            self.call_later(interval, tick)

        self.call_later(interval if initial_delay is None else initial_delay, tick)

        def cancel():
            nonlocal cancelled
            cancelled = True
        return cancel

    def run_until(self, t: float) -> None:
        while self._heap and self._heap[0][0] <= t:
            when, _, fn = heapq.heappop(self._heap)
            self.clock.advance_to(when)
            fn()
        self.clock.advance_to(max(t, self.now()))

    def run_for(self, dt: float) -> None:
        self.run_until(self.now() + dt)


class Notifiee(Protocol):
    """Network event listener (notify.go:11-75)."""

    def connected(self, peer: PeerID) -> None: ...
    def disconnected(self, peer: PeerID) -> None: ...


class Host:
    """A simulated libp2p host: identity, addresses, connections, handlers."""

    def __init__(self, network: "Network", peer_id: PeerID, addr: str):
        self.network = network
        self.peer_id = peer_id
        self.addr = addr                     # source IP for P6 colocation
        self.conns: dict[PeerID, str] = {}   # peer -> "outbound"/"inbound"
        self.protocols: dict[PeerID, str] = {}  # negotiated protocol per peer
        self._notifiees: list[Notifiee] = []
        # protocol registration: ordered preference list + handler
        self.supported: list[str] = []
        self.stream_handler: Callable[[PeerID, str], None] | None = None
        self.rpc_handler: Callable[[PeerID, RPC], None] | None = None
        self.match_fn: Callable[[str], Callable[[str], bool]] | None = None
        self._inflight: dict[PeerID, int] = {}
        self.outbound_queue_size = DEFAULT_PEER_OUTBOUND_QUEUE_SIZE
        self.dropped_rpcs = 0
        self.faulted_rpcs = 0        # RPCs lost to an injected link fault
        # certified-addr-book analogue (peerstore.GetCertifiedAddrBook):
        # this host's own sealed record + validated records learned from
        # peers (identify exchange on connect, ConsumePeerRecord after PX)
        self.local_record: bytes | None = None
        self.certified_records: dict[PeerID, bytes] = {}
        from .connmgr import ConnManager
        self.conn_manager = ConnManager(network.scheduler)

    # -- wiring --

    def set_protocols(self, protos: list[str],
                      stream_handler: Callable[[PeerID, str], None],
                      rpc_handler: Callable[[PeerID, RPC], None],
                      match_fn: Callable[[str], Callable[[str], bool]] | None
                      = None) -> None:
        """Register pubsub's protocol list + handlers (pubsub.go:323-329).

        ``match_fn`` is the WithProtocolMatchFn hook (pubsub.go:520-531):
        maps each locally supported base protocol to a predicate over a
        peer's proposed protocol id, replacing exact multistream matching
        (e.g. semver-range acceptance, gossipsub_matchfn_test.go:79-90)."""
        self.supported = list(protos)
        self.stream_handler = stream_handler
        self.rpc_handler = rpc_handler
        self.match_fn = match_fn
        # late registration: negotiate streams over connections that existed
        # before this protocol handler did (the reference opens streams
        # lazily per peer, so a pubsub attached after dialing still works —
        # exercised by its preconnected-nodes scenario). Re-fires connected
        # notifications so both sides' pubsubs re-evaluate the peer.
        for peer in list(self.conns):
            other = self.network.hosts.get(peer)
            if other is None or peer in self.protocols:
                continue
            proto_out = next((p for p in self.supported
                              if other.accepts(p)), None)
            proto_in = next((q for q in other.supported
                             if self.accepts(q)), None)
            if proto_out is None or proto_in is None:
                continue
            self.protocols[peer] = proto_out
            other.protocols[self.peer_id] = proto_in
            for n in self._notifiees:
                n.connected(peer)
            for n in other._notifiees:
                n.connected(self.peer_id)

    def accepts(self, proposal: str) -> bool:
        """Would this host's mux accept a peer's proposed protocol id?"""
        if self.match_fn is None:
            return proposal in self.supported
        return any(self.match_fn(base)(proposal) for base in self.supported)

    def notify(self, n: Notifiee) -> None:
        self._notifiees.append(n)

    # -- connectivity --

    def connect(self, other: "Host") -> bool:
        """Dial ``other``; negotiates each direction's stream protocol: the
        dialer proposes its list in order, the listener's mux accepts via
        exact match or its match_fn (the multistream-select analogue; the
        per-direction proposal mirrors the reference opening one outbound
        stream per side, comm.go:114-133). Returns False when either
        direction has no acceptable proposal — a simplification of the
        reference, where the transport connection survives but no pubsub
        streams open (observable pubsub behavior is identical)."""
        if other.peer_id in self.conns:
            return True
        proto_out = next((p for p in self.supported if other.accepts(p)), None)
        proto_in = next((q for q in other.supported if self.accepts(q)), None)
        if self.supported and other.supported and \
                (proto_out is None or proto_in is None):
            return False
        self.conns[other.peer_id] = "outbound"
        other.conns[self.peer_id] = "inbound"
        # identify exchange: each side learns the other's signed record
        if other.local_record is not None:
            self.certified_records[other.peer_id] = other.local_record
        if self.local_record is not None:
            other.certified_records[self.peer_id] = self.local_record
        if proto_out is not None:
            self.protocols[other.peer_id] = proto_out
            other.protocols[self.peer_id] = proto_in
        for n in self._notifiees:
            n.connected(other.peer_id)
        for n in other._notifiees:
            n.connected(self.peer_id)
        return True

    def disconnect(self, peer: PeerID) -> None:
        other = self.network.hosts.get(peer)
        self.conns.pop(peer, None)
        self.protocols.pop(peer, None)
        if other is not None:
            other.conns.pop(self.peer_id, None)
            other.protocols.pop(self.peer_id, None)
            for n in other._notifiees:
                n.disconnected(self.peer_id)
        for n in self._notifiees:
            n.disconnected(peer)

    def conns_to_peer(self, peer: PeerID) -> list[str]:
        """Remote addresses for a connected peer (score.go getIPs source)."""
        other = self.network.hosts.get(peer)
        if peer in self.conns and other is not None:
            return [other.addr]
        return []

    # -- wire transfer (comm.go equivalent) --

    def send(self, peer: PeerID, rpc: RPC) -> bool:
        """Queue an RPC to ``peer``. Models the bounded per-peer writer: at
        most ``outbound_queue_size`` RPCs in flight; overflow is dropped and
        reported to the caller (who traces it, gossipsub.go:1195-1202).

        The network's ``link_fault`` hook (sim/faults.py HostFaultInjector)
        is consulted per send: ``"drop"`` loses the RPC in flight — the
        sender believes it sent (True), nothing arrives, ``faulted_rpcs``
        counts it; ``"drop_data"`` strips the publish payload and lets the
        control/subscription planes through (the batched half's link drop
        masks only the DATA admission — ops/propagate.forward_tick — so a
        lossy-link plan must not eat GRAFT/PRUNE/IHAVE here either; same
        shape as the gater's RED drop, peer_gater.go:320-363); ``"dup"``
        delivers the RPC twice (a retransmitting link)."""
        if peer not in self.conns:
            return False
        copies = 1
        if self.network.link_fault is not None:
            action = self.network.link_fault(self.peer_id, peer,
                                             bool(rpc.publish))
            if action == "drop":
                self.faulted_rpcs += 1
                return True           # lost in flight, not queue overflow
            if action == "drop_data":
                self.faulted_rpcs += 1
                if rpc.control is None and not rpc.subscriptions:
                    return True       # data-only frame: fully eaten
                from ..core.types import RPC as _RPC
                rpc = _RPC(subscriptions=list(rpc.subscriptions),
                           publish=[], control=rpc.control)
            if action == "dup":
                copies = 2
        inflight = self._inflight.get(peer, 0)
        if inflight >= self.outbound_queue_size:
            self.dropped_rpcs += 1
            return False
        # a duplicating link still honors the bounded writer: the second
        # copy is shed when only one slot remains (the cap is the
        # invariant, comm.go's 32-slot queue; duplication is best-effort)
        copies = min(copies, self.outbound_queue_size - inflight)
        self._inflight[peer] = inflight + copies
        rpc.from_peer = self.peer_id
        sched = self.network.scheduler
        delay = self.network.latency(self.peer_id, peer)

        def deliver():
            self._inflight[peer] = self._inflight.get(peer, 1) - 1
            other = self.network.hosts.get(peer)
            # connection may have died in flight
            if other is not None and self.peer_id in other.conns \
                    and other.rpc_handler is not None:
                other.rpc_handler(self.peer_id, rpc)

        for _ in range(copies):
            sched.call_later(delay, deliver)
        return True


class Network:
    """The swarm: host registry + shared scheduler + latency model
    (the getNetHosts/connect test substrate, floodsub_test.go:45-100)."""

    def __init__(self, latency: float | Callable[[PeerID, PeerID], float] = 0.001):
        self.scheduler = Scheduler()
        self.hosts: dict[PeerID, Host] = {}
        self._latency = latency
        # per-send fault hook (sim/faults.py HostFaultInjector installs
        # it): (src, dst, has_data) -> "ok" | "drop" | "drop_data" |
        # "dup", consulted by Host.send. "drop" loses the whole frame
        # (cut/dark links); "drop_data" models a lossy link that sheds
        # the data plane but passes control (batched-half parity)
        self.link_fault: Callable[[PeerID, PeerID, bool], str] | None = None

    def latency(self, a: PeerID, b: PeerID) -> float:
        if callable(self._latency):
            return self._latency(a, b)
        return self._latency

    def add_host(self, peer_id: PeerID | None = None, addr: str | None = None) -> Host:
        pid = peer_id if peer_id is not None else f"peer-{len(self.hosts)}"
        if pid in self.hosts:
            raise ValueError(f"duplicate peer id {pid}")
        h = Host(self, pid, addr or f"10.0.{len(self.hosts) // 256}.{len(self.hosts) % 256}")
        self.hosts[pid] = h
        return h

    # topology builders mirroring floodsub_test.go:58-100
    def connect(self, a: Host, b: Host) -> None:
        a.connect(b)

    def connect_all(self, hosts: list[Host]) -> None:
        for i, a in enumerate(hosts):
            for b in hosts[i + 1:]:
                a.connect(b)

    def sparse_connect(self, hosts: list[Host], degree: int = 3, seed: int = 314159) -> None:
        self.connect_some(hosts, degree, seed)

    def dense_connect(self, hosts: list[Host], degree: int = 10, seed: int = 314159) -> None:
        self.connect_some(hosts, degree, seed)

    def connect_some(self, hosts: list[Host], d: int, seed: int = 314159) -> None:
        import random
        rng = random.Random(seed)
        n = len(hosts)
        for i, a in enumerate(hosts):
            for _ in range(d):
                j = rng.randrange(n)
                if j != i:
                    a.connect(hosts[j])
