"""Connection churn: batched dead-peer / reconnect dynamics (port of
ops/churn.py).

An edge going down is the reference's dead-peer path (comm.go:144-154,
pubsub.go:711-757): the peer leaves every mesh and fanout, its P3 deficit
becomes a sticky mesh-failure penalty, pending pulls through the slot are
dropped, and the score is retained. An edge coming back after more than
``retain_score_ticks`` has its per-slot counters reset (score.go:611-644).
Both directions of an edge go down and up together: the lower-id
endpoint's draw wins, exchanged through the reverse-edge permutation
(``permutation_gather`` in the formulation ``edge_gather_mode``
resolves to: kernel 6 under ``"pallas"``). Subscription churn
(:func:`churn_subscriptions`) is the topic Join/Leave round. The sharded
halo route is a later slice (ROADMAP.md, Queue 1 item 7).
"""

from __future__ import annotations

import torch

from .. import rng
from ..sim.config import SimConfig, TopicParams
from ..sim.state import NEVER, SimState, refresh_nbr_subscribed
from .bits import pack_bool, to_i32
from .heartbeat import edge_gather
from .permgather import edge_sort_key, permutation_gather, resolve_mode
from .score_ops import apply_prune_penalty, compute_scores


def _edge_exchange(state: SimState, x: torch.Tensor,
                   mode: str = "auto") -> torch.Tensor:
    """One [N, K] 4-byte payload routed through the reverse-edge
    involution: ``out[n, k] = x[jn, rk]`` (churn.py:39-61), the sort
    formulation by the n-major ``edge_sort_key``. The reference's sharded
    halo route needs a kernel mesh: ROADMAP.md, Queue 1 item 7."""
    n, k = state.neighbors.shape
    nbr = state.neighbors.clamp(0, n - 1)
    rk = state.reverse_slot.clamp(0, k - 1)
    sk = edge_sort_key(state.neighbors, state.reverse_slot, k_major=False) \
        if resolve_mode(mode, x.dtype, n, k, have_sort_key=True) == "sort" \
        else None
    return permutation_gather(x, nbr, rk, mode, sort_key=sk)


def _mine_wins(state: SimState) -> torch.Tensor:
    """[N, K]: this endpoint has the lower id, so its value wins."""
    n = state.neighbors.shape[0]
    nbr = state.neighbors.clamp(0, n - 1)
    return torch.arange(n, device=nbr.device)[:, None] < nbr


def _symmetric_value(state: SimState, x: torch.Tensor,
                     mode: str = "auto") -> torch.Tensor:
    """[N, K] per-edge values made equal on both directions of each edge:
    the lower-id endpoint's value wins (churn.py:64-72)."""
    return torch.where(_mine_wins(state), x, _edge_exchange(state, x, mode))


def _symmetric_bools(state: SimState, bits: list,
                     mode: str = "auto") -> list:
    """Symmetrize up to 32 boolean per-edge decisions in ONE packed
    exchange: both directions use the lower-id endpoint's bit
    (churn.py:75-90)."""
    if len(bits) > 32:
        raise ValueError(f"_symmetric_bools packs at most 32 planes, got "
                         f"{len(bits)}")
    payload = torch.zeros(state.neighbors.shape, dtype=torch.int64,
                          device=state.neighbors.device)
    for i, b in enumerate(bits):
        payload = payload | (b.to(torch.int64) << i)
    g = _edge_exchange(state, to_i32(payload), mode)
    mine = _mine_wins(state)
    return [torch.where(mine, b, ((g >> i) & 1).bool())
            for i, b in enumerate(bits)]


def churn_subscriptions(state: SimState, cfg: SimConfig, tp: TopicParams,
                        key: torch.Tensor) -> SimState:
    """One batched topic Join/Leave round (churn.py:93-144).

    Leave (gossipsub.go:1104-1124): the leaver PRUNEs every mesh member of
    the topic; both sides drop the edge, take the P3b prune penalty and
    enter the unsubscribe backoff. Join (gossipsub.go:1047-1102): live
    fanout edges not under backoff on either side promote straight into
    the mesh, mirrored on the remote side; the rest fill in at the next
    heartbeat's undersubscribed graft. The three receiver views are bool
    masks, so they ride the packed exchange."""
    n, t, k = state.mesh.shape
    kj, kl = rng.split(key, 2)
    leave = state.subscribed & (rng.uniform(kl, (n, t)) < cfg.sub_leave_prob)
    join = ~state.subscribed & (rng.uniform(kj, (n, t)) < cfg.sub_join_prob)

    mode = cfg.edge_gather_mode
    removed = state.mesh & leave[:, :, None]
    mesh_removed = removed | (edge_gather(removed, state, mode=mode)
                              & state.mesh)
    state = apply_prune_penalty(state, mesh_removed, tp)
    backoff = torch.where(mesh_removed,
                          state.tick + cfg.unsubscribe_backoff_ticks,
                          state.backoff)

    backoff_ok = state.tick >= backoff
    remote_ok = edge_gather(backoff_ok, state, mode=mode)
    promote = join[:, :, None] & state.fanout & \
        state.connected[:, None, :] & backoff_ok & remote_ok
    promoted = promote | edge_gather(promote, state, mode=mode)
    new_mesh = (state.mesh & ~mesh_removed) | promoted
    grafted = promoted & ~state.mesh
    state = refresh_nbr_subscribed(state._replace(
        subscribed=(state.subscribed | join) & ~leave))
    return state._replace(
        mesh=new_mesh, backoff=backoff,
        fanout=state.fanout & ~join[:, :, None],
        fanout_lastpub=torch.where(join, NEVER, state.fanout_lastpub),
        graft_tick=torch.where(grafted, state.tick, state.graft_tick),
        mesh_active=state.mesh_active & ~grafted)


def take_edges_down(state: SimState, cfg: SimConfig, tp: TopicParams,
                    go_down: torch.Tensor) -> SimState:
    """RemovePeer semantics for an edge-symmetric [N, K] edge-down mask
    (churn.py:147-176): prune penalty, mesh/fanout eviction, pending
    gossip-pull cancellation, disconnect-tick stamp."""
    n, t, k = state.mesh.shape
    down3 = go_down[:, None, :]
    state = apply_prune_penalty(state, state.mesh & down3, tp)
    # a dead peer's pending pulls never resolve and are dropped, not
    # charged (gossip_tracer.go:154-162): slot bits of go_down packed
    # along K, picked per pending slot by a word select and a shift
    gd_words = pack_bool(go_down)                   # [N, ceil(K/32)] int32
    pend = state.iwant_pending
    pc = pend.clamp(0, k - 1)
    sel = gd_words[:, 0][:, None].expand(pend.shape)
    for wi in range(1, gd_words.shape[1]):
        sel = torch.where(pc // 32 == wi, gd_words[:, wi][:, None], sel)
    # an arithmetic shift followed by & 1 reads the right bit of int32 words
    pend_down = (((sel >> (pc % 32)) & 1) != 0) & (pend >= 0)
    return state._replace(
        mesh=state.mesh & ~down3,
        fanout=state.fanout & ~down3,
        iwant_pending=torch.where(pend_down, -1, pend),
        connected=state.connected & ~go_down,
        disconnect_tick=torch.where(go_down, state.tick,
                                    state.disconnect_tick))


def bring_edges_up(state: SimState, cfg: SimConfig,
                   come_up: torch.Tensor) -> SimState:
    """Reconnect a [N, K] down-edge mask with score retention
    (churn.py:179-200): an edge down longer than ``retain_score_ticks``
    resets its per-slot counters; a faster reconnect keeps its old score."""
    down_age = state.tick - state.disconnect_tick
    expired = come_up & (down_age > cfg.retain_score_ticks)
    exp3 = expired[:, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=come_up.device)
    return state._replace(
        first_message_deliveries=torch.where(
            exp3, zero, state.first_message_deliveries),
        mesh_message_deliveries=torch.where(
            exp3, zero, state.mesh_message_deliveries),
        mesh_failure_penalty=torch.where(
            exp3, zero, state.mesh_failure_penalty),
        invalid_message_deliveries=torch.where(
            exp3, zero, state.invalid_message_deliveries),
        behaviour_penalty=torch.where(expired, zero, state.behaviour_penalty),
        graft_tick=torch.where(exp3, NEVER, state.graft_tick),
        mesh_active=state.mesh_active & ~exp3,
        connected=state.connected | come_up,
        disconnect_tick=torch.where(come_up, NEVER, state.disconnect_tick))


def churn_edges(state: SimState, cfg: SimConfig, tp: TopicParams,
                key: torch.Tensor,
                scores_all: torch.Tensor | None = None,
                forbid_up: torch.Tensor | None = None) -> SimState:
    """One churn round (churn.py:203-269): take down a random fraction of
    live edges, bring back a random fraction of down edges, PX-gated when
    ``cfg.px_enabled``. ``scores_all`` is the heartbeat's unmasked score
    cache (HeartbeatOut.scores_all); without it the scores are computed.
    ``forbid_up`` ([N, K] bool, symmetric) masks the edges a fault plan
    holds down out of the reconnect draw."""
    kd, ku = rng.split(key, 2)
    known = state.neighbors >= 0
    down = known & ~state.connected
    live = known & state.connected
    n, k = state.neighbors.shape
    d_down = rng.uniform(kd, (n, k)) < cfg.churn_disconnect_prob
    if cfg.px_enabled:
        # PX-seeded reconnects (gossipsub.go:893-973): edges to peers the
        # dialer scores below accept_px_threshold come back at a fraction
        # of the rate; a score past its retention window reads 0
        if scores_all is None:
            scores_all = compute_scores(state, cfg, tp,
                                        mask_disconnected=False)
        down_age = state.tick - state.disconnect_tick
        px_score = torch.where(down_age > cfg.retain_score_ticks,
                               torch.zeros_like(scores_all), scores_all)
        p_up = torch.where(px_score >= cfg.accept_px_threshold,
                           cfg.churn_reconnect_prob,
                           cfg.churn_reconnect_prob * cfg.px_low_score_factor)
    else:
        p_up = cfg.churn_reconnect_prob
    d_up = rng.uniform(ku, (n, k)) < p_up
    # the decisions are taken locally and the lower-id endpoint's bits are
    # exchanged in one packed gather
    d_down, d_up, direct_low = _symmetric_bools(
        state, [d_down, d_up, state.direct], cfg.edge_gather_mode)
    go_down = live & d_down
    come_up = down & d_up
    # direct peers are redialed every direct_connect_ticks
    # (gossipsub.go:1648-1670), tick 0 included
    redial = (state.tick % cfg.direct_connect_ticks) == 0
    come_up = come_up | (down & direct_low & redial)
    if forbid_up is not None:
        come_up = come_up & ~forbid_up
    state = take_edges_down(state, cfg, tp, go_down)
    return bring_edges_up(state, cfg, come_up)
