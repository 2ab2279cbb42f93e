"""Export a batched-sim run as a pb/trace event stream (port of
sim/trace_export.py).

The inverse of trace/replay.py: where replay injects a recorded event
stream into ``SimState``, this module diffs consecutive states of a
``cfg.record_provenance`` run into tracer-bus event dicts (the dicts the
reference's ``pb.codec.encode_trace_event`` serializes and
``tensorize_trace`` consumes). A sim run can be serialized, analyzed by
trace tooling, or replayed into a fresh state.

Event coverage: JOIN/LEAVE, ADD_PEER/REMOVE_PEER (connection churn),
GRAFT/PRUNE, PUBLISH_MESSAGE, DELIVER_MESSAGE (with first-delivery
provenance from ``deliver_from``). Duplicate and reject streams are not
exported: the batched engine aggregates them into counters without
per-event provenance, so a replay reproduces mesh/subscription/delivery
state and the P1/P2 counters exactly, while P3/P4 duplicate- and
invalid-driven counters replay as zero.

Timestamps: events of the step that advanced ``tick`` T -> T+1 are stamped
T + 0.5, so tensorize_trace's decay boundaries (1 s == 1 tick) interleave
as the engine's decay does.

:func:`export_events` reads both states to the host, every tick: a
diagnostic path, not a captured one.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from .config import SimConfig, TopicParams
from .hostio import fetch_local
from .state import SimState

_FIELDS = ("tick", "subscribed", "connected", "neighbors", "mesh",
           "msg_publish_tick", "msg_publisher", "msg_topic", "deliver_tick",
           "deliver_from")


def default_peer_name(i: int) -> str:
    return f"p{i}"


def default_topic_name(t: int) -> str:
    return f"t{t}"


def _host(state: SimState):
    return SimpleNamespace(**{f: fetch_local(getattr(state, f))
                              for f in _FIELDS})


def export_events(prev: SimState, cur: SimState,
                  peer_name=default_peer_name,
                  topic_name=default_topic_name) -> list[dict]:
    """Tracer-bus event dicts for one engine.step (prev -> cur)."""
    prev = _host(prev)
    cur = _host(cur)
    tick = int(prev.tick)               # the step that ran
    ts = tick + 0.5
    out: list[dict] = []

    def ev(typ, pid, key, payload):
        out.append({"type": typ, "peerID": peer_name(pid),
                    "timestamp": ts, key: payload})

    # --- subscriptions (churn_subscriptions runs first in the step) ---
    joined = np.argwhere(cur.subscribed & ~prev.subscribed)
    left = np.argwhere(prev.subscribed & ~cur.subscribed)
    for n, t in joined:
        ev("JOIN", n, "join", {"topic": topic_name(t)})
    for n, t in left:
        ev("LEAVE", n, "leave", {"topic": topic_name(t)})

    # --- connection churn (both directions exist in state; each side
    # reports its own view, matching the notifiee fan-out) ---
    nbr = cur.neighbors
    for n, k in np.argwhere(cur.connected & ~prev.connected):
        ev("ADD_PEER", n, "addPeer", {"peerID": peer_name(nbr[n, k])})
    for n, k in np.argwhere(prev.connected & ~cur.connected):
        ev("REMOVE_PEER", n, "removePeer", {"peerID": peer_name(nbr[n, k])})

    # --- mesh maintenance (heartbeat GRAFT/PRUNE exchange) ---
    for n, t, k in np.argwhere(cur.mesh & ~prev.mesh):
        ev("GRAFT", n, "graft", {"peerID": peer_name(nbr[n, k]),
                                 "topic": topic_name(t)})
    for n, t, k in np.argwhere(prev.mesh & ~cur.mesh):
        ev("PRUNE", n, "prune", {"peerID": peer_name(nbr[n, k]),
                                 "topic": topic_name(t)})

    # --- data plane: publishes then deliveries ---
    pub_slots = np.flatnonzero(cur.msg_publish_tick == tick)
    for s in pub_slots:
        ev("PUBLISH_MESSAGE", int(cur.msg_publisher[s]), "publishMessage",
           {"messageID": f"m{tick}_{s}",
            "topic": topic_name(int(cur.msg_topic[s]))})

    def mid(s):
        # a slot delivered this tick was published at msg_publish_tick[s]
        return f"m{int(cur.msg_publish_tick[s])}_{s}"

    dlv = np.argwhere((cur.deliver_tick == tick)
                      & (cur.msg_topic[None, :] >= 0))
    for n, s in dlv:
        topic = topic_name(int(cur.msg_topic[s]))
        if cur.msg_publisher[s] == n and int(cur.msg_publish_tick[s]) == tick:
            rf = peer_name(n)           # local publish: received_from == self
        else:
            slot = cur.deliver_from[n, s]
            rf = peer_name(nbr[n, slot]) if slot >= 0 else peer_name(n)
        ev("DELIVER_MESSAGE", n, "deliverMessage",
           {"messageID": mid(s), "topic": topic, "receivedFrom": rf})
    return out


def run_traced(state: SimState, cfg: SimConfig, tp: TopicParams, key,
               n_ticks: int, health_out: list | None = None,
               keys=None, device=None):
    """Host-stepped run collecting the exported event stream, on ``device``
    (cuda unless the caller passes ``device="cpu"``; the state must lie
    there). Returns (final_state, events). Requires
    ``cfg.record_provenance``; the per-tick host reads make it a
    diagnostic path, not a benchmark.

    ``health_out``: a list that receives one row dict per tick: the
    telemetry aggregates (sim/telemetry.py) plus ``fault_flags`` and its
    decoded ``flags`` (both None under ``invariant_mode="off"``: nothing
    tracked, as opposed to 0 = tracked and clean). Kept out of the event
    stream, whose wire schema has no health message.

    ``keys``: an explicit per-tick key array ([C, 2]; ``key``/``n_ticks``
    are then ignored). ``rng.split(key, n_ticks)`` puts the traced run on
    ``engine.run``'s trajectory, as the supervisor's traced chunks do; with
    no ``keys`` each tick splits the carried key (the reference's chain
    split).
    """
    assert cfg.record_provenance, "run_traced needs cfg.record_provenance"
    from .. import rng
    from ..device import check_on
    from .engine import step
    from .invariants import decode_flags
    from .telemetry import health_record, record_to_row

    dev = check_on(state.tick.device, device)
    events: list[dict] = []
    for i in range(n_ticks if keys is None else len(keys)):
        if keys is None:
            key, k = rng.split(key.to(dev))
        else:
            k = keys[i].to(dev)
        nxt = step(state, cfg, tp, k, device=dev)
        events.extend(export_events(state, nxt))
        if health_out is not None:
            row = record_to_row(health_record(nxt, cfg, tp))
            if cfg.invariant_mode != "off":
                flags = int(fetch_local(nxt.fault_flags, np.uint32))
                row["fault_flags"] = flags
                row["flags"] = decode_flags(flags)
            else:
                row["fault_flags"] = None
                row["flags"] = None
            health_out.append(row)
        state = nxt
    return state, events
