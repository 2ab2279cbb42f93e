"""The reference's step: one heartbeat of the whole network in plain
PyTorch, frozen from the program's plain tensor path.

    tick: (state, key) -> state
      1. churn_subscriptions (sub churn configs) topic Join/Leave round
      2. publish            P chosen messages enter the network
      3. gater_decay        (gater configs) the peer gater's stats decay
      4. heartbeat          mesh maintenance + GRAFT/PRUNE exchange + gossip
                            peer selection; floodsub and randomsub run none
      5. forward_tick       IWANT resolution, forwarding hops, IHAVE emit
      6. churn_edges        (churn configs) edges go down and come back
      7. tick_flags         violation bits close the tick

Every seam runs its plainest formulation: the non-fused hop, one indexed
gather per exchange, rank selection. A compact state is decoded at entry
and encoded at exit, as the program's step does. Fault plans are refused.
"""

from __future__ import annotations

import torch

from . import kc, rng
from .churn import churn_edges, churn_subscriptions
from .config import SimConfig, TopicParams
from .gater import gater_decay
from .heartbeat import HeartbeatOut, heartbeat
from .invariants import tick_flags
from .propagate import forward_tick, publish
from .state import SimState, check_precision, decode_state, encode_state
from .telemetry import health_record, stack_records


def choose_publishers(state: SimState, cfg: SimConfig, key: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Default scenario: P random peers publish, each to a random topic it
    subscribes to (peers with no subscriptions fall back to topic 0)."""
    kp, kt = rng.split(key, 2)
    p = cfg.publishers_per_tick
    peers = rng.randint(kp, (p,), 0, cfg.n_peers)
    sub = kc.owner_rows(state.subscribed, peers)          # [P, T]
    g = rng.gumbel(kt, tuple(sub.shape))
    topics = torch.argmax(torch.where(sub, g, torch.full_like(g, -float("inf"))),
                          dim=-1).to(torch.int32)
    return peers, topics


def _step(state: SimState, cfg: SimConfig, tp: TopicParams,
          key: torch.Tensor) -> tuple[SimState, torch.Tensor | None]:
    """One tick of a stored state (engine.py:103-192): decoded at entry,
    :func:`_tick`, encoded at exit (both identities under ``"f32"``)."""
    state, flags = _tick(decode_state(state, cfg), cfg, tp, key)
    return encode_state(state, cfg), flags


def _tick(state: SimState, cfg: SimConfig, tp: TopicParams,
          key: torch.Tensor) -> tuple[SimState, torch.Tensor | None]:
    """One tick in the compute layout: the next state and this tick's flag
    word (violation | injected bits; None under ``invariant_mode="off"``)."""
    if cfg.fault_plan is not None:
        raise ValueError("the reference runs plan-free configurations only")
    k_pub, k_hb, k_fwd, k_churn, k_ign, k_sub = rng.split(key, 6)
    if cfg.sub_leave_prob > 0.0 or cfg.sub_join_prob > 0.0:
        state = churn_subscriptions(state, cfg, tp, k_sub)
    peers, topics = choose_publishers(state, cfg, k_pub)
    state = publish(state, cfg, peers, topics, k_ign)
    if cfg.gater_enabled:
        state = gater_decay(state, cfg)
    gossipsub = cfg.router == "gossipsub"
    if gossipsub:
        hb = heartbeat(state, cfg, tp, k_hb)
    else:
        # floodsub and randomsub run no heartbeat: no mesh, no gossip, no
        # scoring (engine.py:147-161)
        n, t, k = state.mesh.shape
        dev = state.mesh.device
        zf = torch.zeros((n, k), dtype=torch.float32, device=dev)
        zb = torch.zeros((n, t, k), dtype=torch.bool, device=dev)
        hb = HeartbeatOut(state=state, scores=zf, scores_all=zf,
                          inc_gossip=zb, fwd_send=zb)
    state = forward_tick(hb.state, cfg, tp, hb.inc_gossip, hb.scores, k_fwd,
                         fwd_send=hb.fwd_send if gossipsub else None)
    if cfg.churn_disconnect_prob > 0.0:
        # connection churn closes the tick, reusing the heartbeat's
        # unmasked score cache for the PX reconnect gate
        state = churn_edges(state, cfg, tp, k_churn,
                            scores_all=hb.scores_all)
    flags = None
    if cfg.invariant_mode != "off":
        # the sentinel closes the tick: invariant violations OR into the
        # sticky flag word
        flags = tick_flags(state, cfg, n_global=state.mesh.shape[0])
        state = state._replace(fault_flags=state.fault_flags | flags)
    return state._replace(tick=state.tick + 1), flags


def run_keys(state: SimState, cfg: SimConfig, tp: TopicParams,
             keys: torch.Tensor, telemetry: bool = False):
    """One tick per row of ``keys`` ([C, 2]); with ``telemetry`` also the
    stacked health records of every tick's post-step state."""
    check_precision(cfg)
    records = []
    for i in range(keys.shape[0]):
        state = _step(state, cfg, tp, keys[i])[0]
        if telemetry:
            records.append(health_record(state, cfg, tp))
    return (state, stack_records(records)) if telemetry else state
