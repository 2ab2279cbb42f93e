"""The simulation engine: one step = faults + publish + heartbeat + traffic
+ churn (port of sim/engine.py on the ported paths).

    step: (state, key) -> state
      0. apply_faults       (fault plans) partition/outage/eclipse/wave cuts
                            and heals, this tick's link and corruption draws
      1. publish            P scenario-chosen messages enter the network
      2. gater_decay        (gater configs) the peer gater's stats decay
      3. heartbeat          mesh maintenance + GRAFT/PRUNE exchange + gossip
                            peer selection (score decay applies inline);
                            floodsub and randomsub run none
      4. forward_tick       IWANT resolution, forwarding hops, IHAVE emit
      5. churn_edges        (churn configs) edges go down and come back
      6. record_flags       injected-fault and violation bits close the tick

``run`` splits ONE master key into per-tick keys on the host, as the
reference's ``key_schedule="host"``, and steps eagerly. Every config
outside the ported paths raises NotImplementedError (:func:`check_slice`).
"""

from __future__ import annotations

import torch

from .. import rng
from ..device import check_on
from ..ops.bits import pack_words
from ..ops.churn import churn_edges
from ..ops.gater import gater_decay
from ..ops.heartbeat import HeartbeatOut, heartbeat
from ..ops.hopkernel import resolve_hop_mode
from ..ops.permgather import resolve_gather_mode
from ..ops.propagate import forward_tick, publish
from .config import SimConfig, TopicParams
from .faults import apply_faults, censor_word_mask, storm_publishers
from .invariants import FAULT_CORRUPT, record_flags
from .state import NEVER, SimState, unpack_have


def _later(item: int) -> str:
    return f"is not ported yet (ROADMAP.md, Queue 1 item {item})"


def check_slice(cfg: SimConfig) -> None:
    """Raise NotImplementedError for any config outside the ported paths:
    the step under every router (gossipsub with scoring, floodsub,
    randomsub), flood publish, the peer gater, the validation and edge
    queue caps, provenance, every fault-plan family and connection churn
    with PX, on the fused kernels or the non-fused data path (hop_mode
    ``auto``/``pallas``/``pallas-mxu``/``xla``) in the ``pallas`` or
    ``mxu`` gather formulation, uint8 or int32 hop counts (int32 on the
    non-fused path), with recorded invariants and the host key schedule.
    Each refusal names the queue item that lifts it."""
    refusals = [
        (cfg.sub_leave_prob > 0.0 or cfg.sub_join_prob > 0.0,
         "subscription churn", 2),
        (cfg.invariant_mode != "record",
         f"invariant_mode={cfg.invariant_mode!r}", 2),
        (cfg.key_schedule != "host", f"key_schedule={cfg.key_schedule!r}", 2),
        (cfg.state_precision != "f32",
         f"state_precision={cfg.state_precision!r}", 5),
        (cfg.degree_buckets is not None, "degree_buckets", 8),
    ]
    for refused, what, item in refusals:
        if refused:
            raise NotImplementedError(f"{what} {_later(item)}")
    resolve_hop_mode(cfg)
    resolve_gather_mode(cfg.edge_gather_mode)


def choose_publishers(state: SimState, cfg: SimConfig, key: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Default scenario: P random peers publish, each to a random topic it
    subscribes to (peers with no subscriptions fall back to topic 0). A
    plan's active storm windows then re-skew the draw toward their hot
    publishers; the storm split exists only for storm plans."""
    storms = cfg.fault_plan is not None and cfg.fault_plan.storms
    if storms:
        key, k_storm = rng.split(key, 2)
    kp, kt = rng.split(key, 2)
    p = cfg.publishers_per_tick
    peers = rng.randint(kp, (p,), 0, cfg.n_peers)
    sub = state.subscribed[peers.long()]                  # [P, T]
    g = rng.gumbel(kt, tuple(sub.shape))
    topics = torch.argmax(torch.where(sub, g, torch.full_like(g, -float("inf"))),
                          dim=-1).to(torch.int32)
    if storms:
        peers, topics = storm_publishers(state, cfg, peers, topics, k_storm)
    return peers, topics


def _iwant_answer_extras(state: SimState, cfg: SimConfig,
                         censor_bits: torch.Tensor | None = None
                         ) -> list | None:
    """The IWANT answer table, to ride the heartbeat's final exchange as
    extra word rows (engine.py:64-100): it reads only deliver_tick and
    malicious, which the heartbeat never writes, and censors withhold the
    victim's messages from it as forward_tick does. In the port the
    carrier is the flat take of ``edge_gather_mode="mxu"``, for the
    non-fused resolve only (the fused resolve kernel gathers the table
    itself); otherwise None."""
    if resolve_hop_mode(cfg) == "pallas" \
            or resolve_gather_mode(cfg.edge_gather_mode) != "mxu":
        return None
    zero = torch.zeros((), dtype=torch.int32, device=state.tick.device)
    answer_bits = torch.where(state.malicious[None, :], zero,
                              pack_words(state.deliver_tick < NEVER))
    if censor_bits is not None:
        answer_bits = answer_bits & ~censor_bits
    return [answer_bits]


def step(state: SimState, cfg: SimConfig, tp: TopicParams,
         key: torch.Tensor, device=None) -> SimState:
    """Advance the network one heartbeat on ``device`` (cuda unless the
    caller passes ``device="cpu"``; the state must lie there)."""
    check_on(state.tick.device, device)
    check_slice(cfg)
    if cfg.fault_plan is not None:
        # the fault pass opens the tick; its key split exists only under a
        # plan, so plan-free configs keep their exact stream
        key, k_fault = rng.split(key, 2)
        state, fault = apply_faults(state, cfg, tp, k_fault)
    else:
        fault = None
    k_pub, k_hb, k_fwd, k_churn, k_ign, _k_sub = rng.split(key, 6)
    peers, topics = choose_publishers(state, cfg, k_pub)
    if fault is not None and fault.corrupt is not None:
        # effective corruption: a draw on a malicious publisher corrupts
        # nothing (its message is invalid already)
        corrupt = fault.corrupt & ~state.malicious[peers.long()]
        fault = fault._replace(corrupt=corrupt, injected=fault.injected | (
            corrupt.any().to(torch.int32) * FAULT_CORRUPT))
    state = publish(state, cfg, peers, topics, k_ign,
                    corrupt=fault.corrupt if fault is not None else None)
    # the censor mask reads msg_publisher, so it follows publish
    censor_bits = censor_word_mask(state, cfg)
    if cfg.gater_enabled:
        state = gater_decay(state, cfg)
    gossipsub = cfg.router == "gossipsub"
    if gossipsub:
        hb = heartbeat(state, cfg, tp, k_hb,
                       extra_words=_iwant_answer_extras(state, cfg,
                                                        censor_bits))
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
                         fwd_send=hb.fwd_send if gossipsub else None,
                         answers_k=hb.extra_routed[0] if hb.extra_routed
                         else None,
                         link_ok=fault.link_ok if fault is not None else None,
                         dup_edges=fault.dup_edges if fault is not None
                         else None,
                         censor_bits=censor_bits)
    if cfg.churn_disconnect_prob > 0.0:
        # connection churn closes the tick, reusing the heartbeat's
        # unmasked score cache for the PX reconnect gate; plan-cut edges
        # stay down
        state = churn_edges(state, cfg, tp, k_churn,
                            scores_all=hb.scores_all,
                            forbid_up=fault.want_down if fault is not None
                            else None)
    state = record_flags(state, cfg, injected=fault.injected
                         if fault is not None else None)
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
