"""The simulation engine: one step = publish + heartbeat + traffic (port of
sim/engine.py on the slice's path).

    step: (state, key) -> state
      1. publish            P scenario-chosen messages enter the network
      2. heartbeat          mesh maintenance + GRAFT/PRUNE exchange + gossip
                            peer selection (score decay applies inline)
      3. forward_tick       IWANT resolution, mesh forwarding hops, IHAVE emit
      4. record_flags       the invariant sentinel closes the tick

``run`` splits ONE master key into per-tick keys on the host, as the
reference's ``key_schedule="host"``, and steps eagerly. Every branch of the
reference's ``step`` outside this slice raises NotImplementedError.
"""

from __future__ import annotations

import torch

from .. import rng
from ..device import check_on
from ..ops.heartbeat import heartbeat
from ..ops.propagate import forward_tick, publish
from .config import SimConfig, TopicParams
from .invariants import record_flags
from .state import SimState, unpack_have

_SLICE = "is a later slice of the port (ROADMAP.md, Queue 1)"


def check_slice(cfg: SimConfig) -> None:
    """Raise NotImplementedError for any config outside the slice: the
    fused-kernel gossipsub step with scoring, recorded invariants and the
    host key schedule."""
    refusals = [
        (cfg.fault_plan is not None, "fault_plan"),
        (cfg.gater_enabled, "gater_enabled"),
        (cfg.churn_disconnect_prob > 0.0 or cfg.churn_reconnect_prob > 0.0,
         "connection churn"),
        (cfg.sub_leave_prob > 0.0 or cfg.sub_join_prob > 0.0,
         "subscription churn"),
        (cfg.router != "gossipsub", f"router={cfg.router!r}"),
        (cfg.flood_publish, "flood_publish"),
        (cfg.record_provenance, "record_provenance"),
        (cfg.edge_queue_cap > 0 or cfg.validation_queue_cap > 0,
         "queue caps"),
        (cfg.invariant_mode != "record",
         f"invariant_mode={cfg.invariant_mode!r}"),
        (cfg.key_schedule != "host", f"key_schedule={cfg.key_schedule!r}"),
        (cfg.hop_mode not in ("auto", "pallas"), f"hop_mode={cfg.hop_mode!r}"),
        (cfg.edge_gather_mode not in ("auto", "pallas"),
         f"edge_gather_mode={cfg.edge_gather_mode!r}"),
        (cfg.count_dtype != "uint8", f"count_dtype={cfg.count_dtype!r}"),
        (cfg.state_precision != "f32",
         f"state_precision={cfg.state_precision!r}"),
        (cfg.degree_buckets is not None, "degree_buckets"),
    ]
    for refused, what in refusals:
        if refused:
            raise NotImplementedError(f"{what} {_SLICE}")


def choose_publishers(state: SimState, cfg: SimConfig, key: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Default scenario: P random peers publish, each to a random topic it
    subscribes to (peers with no subscriptions fall back to topic 0)."""
    kp, kt = rng.split(key, 2)
    p = cfg.publishers_per_tick
    peers = rng.randint(kp, (p,), 0, cfg.n_peers)
    sub = state.subscribed[peers.long()]                  # [P, T]
    g = rng.gumbel(kt, tuple(sub.shape))
    topics = torch.argmax(torch.where(sub, g, torch.full_like(g, -float("inf"))),
                          dim=-1).to(torch.int32)
    return peers, topics


def step(state: SimState, cfg: SimConfig, tp: TopicParams,
         key: torch.Tensor, device=None) -> SimState:
    """Advance the network one heartbeat on ``device`` (cuda unless the
    caller passes ``device="cpu"``; the state must lie there)."""
    check_on(state.tick.device, device)
    check_slice(cfg)
    k_pub, k_hb, k_fwd, _k_churn, k_ign, _k_sub = rng.split(key, 6)
    peers, topics = choose_publishers(state, cfg, k_pub)
    state = publish(state, cfg, peers, topics, k_ign)
    hb = heartbeat(state, cfg, tp, k_hb)
    state = forward_tick(hb.state, cfg, tp, hb.inc_gossip, hb.scores, k_fwd,
                         fwd_send=hb.fwd_send)
    state = record_flags(state, cfg)
    return state._replace(tick=state.tick + 1)


def run(state: SimState, cfg: SimConfig, tp: TopicParams, key: torch.Tensor,
        n_ticks: int, device=None) -> SimState:
    """Advance ``n_ticks`` heartbeats: one master key split into per-tick
    keys (the reference's ``key_schedule="host"``)."""
    check_on(state.tick.device, device)
    keys = rng.split(key.to(state.tick.device), n_ticks)
    for i in range(n_ticks):
        state = step(state, cfg, tp, keys[i], device=state.tick.device)
    return state


def mesh_degrees(state: SimState) -> torch.Tensor:
    """[N, T] current mesh degree."""
    return state.mesh.sum(-1).to(torch.int32)


def delivery_fraction(state: SimState, cfg: SimConfig,
                      min_age_ticks: int = 0,
                      topic: int | None = None) -> torch.Tensor:
    """Fraction of (subscribed peer, alive message) pairs delivered, over
    messages at least ``min_age_ticks`` old (optionally one topic)."""
    age = state.tick - state.msg_publish_tick
    alive = (age < cfg.history_length) & (age >= min_age_ticks)
    t_m = state.msg_topic.clamp(0, cfg.n_topics - 1).long()
    should = state.subscribed[:, t_m] & alive[None, :] \
        & (state.msg_topic >= 0)[None, :]
    if topic is not None:
        should = should & (state.msg_topic == topic)[None, :]
    got = unpack_have(state, cfg.msg_window) & should
    return got.sum() / torch.clamp(should.sum(), min=1)
