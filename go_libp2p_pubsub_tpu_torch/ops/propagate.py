"""Batched message propagation: publish, eager mesh forwarding, lazy gossip
(port of ops/propagate.py on the fused-kernel path).

The model is the reference's (ops/propagate.py module docstring): the
message window lives in [W, N] packed words, a tick runs last tick's IWANT
resolution, up to ``prop_substeps`` forwarding hops that stop early on an
empty frontier, the P2/P3/P4 counter folds, and the IHAVE->IWANT emit.
Each of the three fused steps is one kernel (ops/hopkernel.py). The
reference's non-fused XLA formulations (cap/gater/provenance/flood-publish
configs) are a later slice of the port.
"""

from __future__ import annotations

import torch

from .. import rng
from ..sim.config import SimConfig, TopicParams
from ..sim.state import NEVER, SimState
from .bits import I32, pack_bool, pack_words, popcount_sum, unpack_words
from .hopkernel import _hop_config_ok, emit, hop, iwant_resolve
from .score_ops import decayed

_LATER = ("is not ported yet: the port runs the fused-kernel path only; the "
          "non-fused XLA hop and its config branches are a later slice "
          "(ROADMAP.md, Queue 1 item 10)")


def publish(state: SimState, cfg: SimConfig, publishers: torch.Tensor,
            topics: torch.Tensor, key: torch.Tensor | None = None
            ) -> SimState:
    """Start ``P`` new messages this tick, rotating through message slots
    (propagate.py:70-143): slot reuse resets the per-peer seen state,
    non-subscribed publishers stamp ``fanout_lastpub``, malicious
    publishers emit invalid messages, a ``cfg.ignore_fraction`` of honest
    messages draw validation verdict IGNORE."""
    p = publishers.shape[0]
    m = cfg.msg_window
    if p > m:
        raise ValueError(
            f"publish: {p} publishers per tick exceed msg_window={m}; "
            "message slots must be distinct within one batch")
    dev = publishers.device
    tick = state.tick
    pub = publishers.long()
    top = topics.long()
    slots = ((tick.long() * p + torch.arange(p, device=dev)) % m)

    invalid_pub = state.malicious[pub]
    msg_topic = state.msg_topic.clone()
    msg_topic[slots] = topics.to(I32)
    msg_publish_tick = state.msg_publish_tick.clone()
    msg_publish_tick[slots] = tick
    msg_invalid = state.msg_invalid.clone()
    msg_invalid[slots] = invalid_pub
    if cfg.ignore_fraction > 0.0 and key is not None:
        ign = (rng.uniform(key, (p,)) < cfg.ignore_fraction) \
            & ~state.malicious[pub]
    else:
        ign = torch.zeros((p,), dtype=torch.bool, device=dev)
    msg_ignored = state.msg_ignored.clone()
    msg_ignored[slots] = ign
    msg_publisher = state.msg_publisher.clone()
    msg_publisher[slots] = publishers.to(I32)
    # reset recycled slots (word-AND), then set the publisher's slot bit
    # (a scatter-add: the bits were just cleared and the slots of one batch
    # are distinct, so added bits never carry)
    recycled = torch.zeros((1, m), dtype=torch.bool, device=dev)
    recycled[0, slots] = True
    clear_w = pack_bool(recycled)[0]
    have = state.have & ~clear_w[None, :]
    bit = (torch.ones_like(slots) << (slots % 32))
    bit = torch.where(bit >= 2 ** 31, bit - 2 ** 32, bit).to(I32)
    have = have.index_put((pub, slots // 32), bit, accumulate=True)
    deliver_tick = state.deliver_tick.clone()
    deliver_tick[:, slots] = NEVER
    deliver_tick[pub, slots] = tick
    iwant_pending = state.iwant_pending.clone()
    iwant_pending[:, slots] = -1
    # fanout lastpub for non-subscribed publishers
    sub_pub = state.subscribed[pub, top]
    cur_lp = state.fanout_lastpub[pub, top]
    fanout_lastpub = state.fanout_lastpub.clone()
    fanout_lastpub[pub, top] = torch.where(sub_pub, cur_lp, tick)
    return state._replace(msg_topic=msg_topic, msg_publish_tick=msg_publish_tick,
                          msg_invalid=msg_invalid, msg_ignored=msg_ignored,
                          msg_publisher=msg_publisher, have=have,
                          deliver_tick=deliver_tick,
                          iwant_pending=iwant_pending,
                          fanout_lastpub=fanout_lastpub)


def forward_tick(state: SimState, cfg: SimConfig, tp: TopicParams,
                 inc_gossip: torch.Tensor, scores: torch.Tensor,
                 key: torch.Tensor, *,
                 fwd_send: torch.Tensor | None = None) -> SimState:
    """One tick of data-plane traffic on the fused path: resolve last
    tick's IWANTs, run up to ``prop_substeps`` forwarding hops, fold the
    counters, emit this tick's IHAVE/IWANT (propagate.py:229-853).

    ``scores`` is the heartbeat's [N, K] score cache; ``inc_gossip`` and
    ``fwd_send`` are its receiver views (HeartbeatOut). ``key`` is unused on
    this path (the reference splits it for the randomsub and gater draws)."""
    if cfg.router != "gossipsub":
        raise NotImplementedError(f"router={cfg.router!r} {_LATER}")
    if fwd_send is None:
        raise NotImplementedError(f"forward_tick without fwd_send {_LATER}")
    if not _hop_config_ok(cfg):
        raise NotImplementedError(f"a config outside the fused hop {_LATER}")
    n, t, k = state.mesh.shape
    m = cfg.msg_window
    if m > 255:
        raise ValueError(f"msg_window={m} > 255 would wrap the uint8 "
                         "hop-count accumulators")
    dev = state.mesh.device
    tick = state.tick
    nbr = state.neighbors.clamp(0, n - 1)                  # [N, K]
    mal = state.malicious
    zero = torch.zeros((), dtype=I32, device=dev)

    # --- per-tick packed masks ---
    age_pub = tick - state.msg_publish_tick
    alive = (age_pub >= 0) & (age_pub < cfg.history_length)            # [M]
    t_m = state.msg_topic.clamp(0, t - 1)
    live_topic = (state.msg_topic >= 0) & alive
    topic_bits = pack_bool((t_m[None, :] == torch.arange(t, device=dev)[:, None])
                           & live_topic[None, :])                      # [T, W]
    alive_bits = pack_bool(alive[None, :])[0]                          # [W]
    invalid_bits = pack_bool((state.msg_invalid & alive)[None, :])[0]
    ignored_bits = pack_bool((state.msg_ignored & alive)[None, :])[0]
    valid_msg_bits = alive_bits & ~invalid_bits & ~ignored_bits
    # honest peers deliver only ACCEPT-verdict messages; malicious receivers
    # accept + forward anything. P4 charges REJECT only.
    vm = torch.where(mal[None, :], alive_bits[:, None],
                     valid_msg_bits[:, None])                           # [W,N]
    inv_n = torch.where(mal[None, :], zero, invalid_bits[:, None])      # [W,N]

    have_bits = state.have.T.contiguous()                               # [W,N]
    dlv_bits = pack_words(state.deliver_tick < NEVER)                   # [W,N]
    dlv_start = dlv_bits
    n_have_start = popcount_sum(have_bits, axis=(0, 1))

    if cfg.scoring_enabled:
        accept_ok = scores >= cfg.graylist_threshold      # [N,K] AcceptFrom
        gossip_ok = scores >= cfg.gossip_threshold        # [N,K] handleIHave
    else:
        accept_ok = torch.ones((n, k), dtype=torch.bool, device=dev)
        gossip_ok = accept_ok
    data_ok = accept_ok

    # -- step 1: resolve pending IWANTs from last tick (gossipsub.go:698-739).
    # Malicious sources never answer; honest sources answer from their
    # mcache, which rejected/ignored messages never enter.
    answer_bits = torch.where(mal[None, :], zero, dlv_bits)            # [W,N]
    r = iwant_resolve(state.iwant_pending, answer_bits, have_bits, vm, inv_n,
                      alive_bits[:, None].contiguous(),
                      data_ok.to(torch.uint8), topic_bits, nbr, m)
    behaviour_penalty = state.behaviour_penalty + r.broken.float().T
    have_bits = have_bits | r.got_any
    dlv_bits = dlv_bits | r.got_valid_any

    # -- step 2: eager forwarding, up to prop_substeps hops --
    fwd_u8 = (fwd_send & data_ok[:, None, :]).to(torch.uint8)
    mesh_u8 = state.mesh.to(torch.uint8)
    # P3 duplicate-credit window (score.go:949-981)
    age_dlv = tick - state.deliver_tick
    window_old = pack_words((age_dlv >= 0)
                            & (age_dlv <= cfg.mesh_message_deliveries_window_ticks))
    valid_msg = valid_msg_bits[:, None].contiguous()
    # frontier: messages that entered this peer THIS tick (fresh publishes
    # and IWANT pulls); a peer forwards a message one hop after it first
    # receives it, so per-hop counts sum to the tick's event counts
    frontier = pack_words(state.deliver_tick == tick) | r.got_valid_any
    h_have, h_dlv = have_bits, dlv_bits
    h_dlv_new = r.got_valid_any.clone()
    nv, ni = r.nv, r.ni
    dup = torch.zeros((t, k, n), dtype=torch.uint8, device=dev)
    i = 0
    # the early exit reads the frontier on the host once per hop (a device
    # sync in eager mode); a hop with an empty frontier is a no-op
    while i < cfg.prop_substeps and bool((frontier != 0).any()):
        h = hop(frontier, h_have, h_dlv, h_dlv_new, vm, inv_n, window_old,
                valid_msg, nbr, fwd_u8, mesh_u8, topic_bits, nv, ni, dup)
        frontier, h_have, h_dlv, h_dlv_new = h.new_valid, h.have, h.dlv, \
            h.dlv_new
        nv, ni, dup = h.nv, h.ni, h.dup
        i += 1
    have_bits, dlv_bits = h_have, h_dlv

    # [T,K,N] counts -> [N,T,K] f32 counter increments, folded with this
    # tick's decay: min(zclamp(counter * decay) + arrivals, cap)
    fmd_add = nv.permute(2, 0, 1).float()
    imd_add = ni.permute(2, 0, 1).float()
    mmd_add = dup.permute(2, 0, 1).float()

    def t2(x):
        return x[None, :, None]
    z = cfg.decay_to_zero
    fmd = torch.minimum(
        decayed(state.first_message_deliveries,
                t2(tp.first_message_deliveries_decay), z) + fmd_add,
        t2(tp.first_message_deliveries_cap))
    mmd = torch.minimum(
        decayed(state.mesh_message_deliveries,
                t2(tp.mesh_message_deliveries_decay), z) + mmd_add,
        t2(tp.mesh_message_deliveries_cap))
    imd = decayed(state.invalid_message_deliveries,
                  t2(tp.invalid_message_deliveries_decay), z) + imd_add

    newly_dlv = dlv_bits & ~dlv_start
    new_dlv_mask = unpack_words(newly_dlv, m)
    deliver_tick = torch.where(new_dlv_mask, tick, state.deliver_tick)
    delivered = popcount_sum(have_bits, axis=(0, 1)) - n_have_start
    state = state._replace(
        have=have_bits.T.contiguous(), deliver_tick=deliver_tick,
        first_message_deliveries=fmd,
        mesh_message_deliveries=mmd,
        invalid_message_deliveries=imd,
        behaviour_penalty=behaviour_penalty,
        delivered_total=state.delivered_total + delivered)

    # -- step 3: IHAVE/IWANT for next tick (gossipsub.go:1711-1775) --
    valid_slots = ((state.neighbors >= 0)
                   & (state.reverse_slot >= 0))[:, None, :]
    inc_gossip = inc_gossip & valid_slots & gossip_ok[:, None, :]
    # sender gossip window = the mcache gossip slice: DELIVERED within the
    # last history_gossip ticks; malicious peers advertise everything alive
    age = tick - state.deliver_tick
    window_bits = pack_words((age >= 0) & (age < cfg.history_gossip)) \
        & alive_bits[:, None]
    window_bits = torch.where(mal[None, :], alive_bits[:, None], window_bits)
    iwant_pending = emit(window_bits, have_bits, inc_gossip.to(torch.uint8),
                         topic_bits, nbr, m,
                         budget=min(cfg.max_iwant_per_tick, m))
    return state._replace(iwant_pending=iwant_pending)
