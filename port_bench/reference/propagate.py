"""Batched message propagation: publish, eager mesh forwarding, lazy gossip
(port of ops/propagate.py).

The model is the reference's (ops/propagate.py module docstring): the
message window lives in [W, N] packed words, a tick runs last tick's IWANT
resolution, ``prop_substeps`` forwarding hops (the reference stops early
on an empty frontier, where a hop is a no-op; the port runs them all, so
it reads nothing on the host), the P2/P3/P4 counter folds, and the
IHAVE->IWANT emit.

This copy keeps the non-fused formulation only: the per-slot ask sets
of ``_slot_bitplanes``, one words gather per hop (``gw``), the
validation-queue cap, the peer gater's admission and stats, and the emit
through ``_bits_to_slot`` / ``_budgeted_iwant``.

The data plane's other branches follow the reference (propagate.py:146-177
and :229-853): the floodsub and randomsub forwarding masks, flood publish
(the sender-side score and direct planes through ``permutation_gather``,
the origin words through ``gw``), per-edge queue caps in the resolve and
the hops, delivery provenance (``deliver_from``), and the fault plane's
inputs: ``link_ok`` (lossy and slow links), ``dup_edges`` (re-offered
deliveries) and ``censor_bits`` (withheld messages).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import rng
from . import kc
from .config import SimConfig, TopicParams
from .state import NEVER, SimState
from .bits import (
    I32,
    exclusive_prefix_or,
    gather_words_rows,
    pack_bool,
    pack_words,
    popcount,
    popcount_sum,
    prefix_count_words,
    reduce_or,
    unpack_words,
)
from .gater import accept_data
from .heartbeat import edge_gather
from .permgather import permutation_gather
from .score_ops import decayed
from .selection import select_random

U8 = torch.uint8
# the per-(topic, slot, receiver) hop-count accumulators (propagate.py:361-372)
_COUNT_DTYPES = {"uint8": U8, "int32": I32}


def publish(state: SimState, cfg: SimConfig, publishers: torch.Tensor,
            topics: torch.Tensor, key: torch.Tensor | None = None,
            corrupt: torch.Tensor | None = None) -> SimState:
    """Start ``P`` new messages this tick, rotating through message slots
    (propagate.py:70-143): slot reuse resets the per-peer seen state (and
    ``deliver_from`` under provenance), non-subscribed publishers stamp
    ``fanout_lastpub``, malicious publishers emit invalid messages, a
    ``cfg.ignore_fraction`` of honest messages draw validation verdict
    IGNORE. ``corrupt`` ([P] bool, sim/faults.py) marks publishes corrupted
    in flight: honest receivers REJECT them as they do a sybil's."""
    p = publishers.shape[0]
    m = cfg.msg_window
    n = state.have.shape[0]
    if p > m:
        raise ValueError(
            f"publish: {p} publishers per tick exceed msg_window={m}; "
            "message slots must be distinct within one batch")
    dev = publishers.device
    tick = state.tick
    pub = publishers.long()
    top = topics.long()
    slots = ((tick.long() * p + torch.arange(p, device=dev)) % m)
    # inside a peer group a rank writes its own publishers' rows (the
    # others' land on a scratch row) and reads the publishers' malicious
    # flags, which the replicated message table takes, from the group
    lp = kc.own_rows(pub, n)
    mal_pub = kc.owner_rows(state.malicious, pub)

    invalid_pub = mal_pub
    if corrupt is not None:
        invalid_pub = invalid_pub | corrupt
    msg_topic = state.msg_topic.clone()
    msg_topic[slots] = topics.to(I32)
    msg_publish_tick = state.msg_publish_tick.clone()
    msg_publish_tick[slots] = tick
    msg_invalid = state.msg_invalid.clone()
    msg_invalid[slots] = invalid_pub
    if cfg.ignore_fraction > 0.0 and key is not None:
        ign = (rng.uniform(key, (p,)) < cfg.ignore_fraction) \
            & ~mal_pub
    else:
        ign = torch.zeros((p,), dtype=torch.bool, device=dev)
    msg_ignored = state.msg_ignored.clone()
    msg_ignored[slots] = ign
    msg_publisher = state.msg_publisher.clone()
    msg_publisher[slots] = publishers.to(I32)
    deliver_from = state.deliver_from
    if cfg.record_provenance:
        deliver_from = deliver_from.index_fill(1, slots, -1)
    # reset recycled slots (word-AND), then set the publisher's slot bit
    # (a scatter-add: the bits were just cleared and the slots of one batch
    # are distinct, so added bits never carry)
    recycled = torch.zeros((1, m), dtype=torch.bool,
                           device=dev).index_fill_(1, slots, True)
    clear_w = pack_bool(recycled)[0]
    have = state.have & ~clear_w[None, :]
    bit = (torch.ones_like(slots) << (slots % 32))
    bit = torch.where(bit >= 2 ** 31, bit - 2 ** 32, bit).to(I32)
    have = kc.scratch_row(have).index_put((lp, slots // 32), bit,
                                          accumulate=True)[:n]
    # the scalar fills are index_fill's (a Python scalar assigned through
    # indexing would be made into a tensor from host data first)
    deliver_tick = kc.scratch_row(
        state.deliver_tick.index_fill(1, slots, NEVER))
    deliver_tick[lp, slots] = tick
    deliver_tick = deliver_tick[:n]
    iwant_pending = state.iwant_pending.index_fill(1, slots, -1)
    # fanout lastpub for non-subscribed publishers
    sub_pub = kc.scratch_row(state.subscribed)[lp, top]
    fanout_lastpub = kc.scratch_row(state.fanout_lastpub).clone()
    cur_lp = fanout_lastpub[lp, top]
    fanout_lastpub[lp, top] = torch.where(sub_pub, cur_lp, tick)
    fanout_lastpub = fanout_lastpub[:n]
    return state._replace(msg_topic=msg_topic, msg_publish_tick=msg_publish_tick,
                          msg_invalid=msg_invalid, msg_ignored=msg_ignored,
                          msg_publisher=msg_publisher, have=have,
                          deliver_tick=deliver_tick, deliver_from=deliver_from,
                          iwant_pending=iwant_pending,
                          fanout_lastpub=fanout_lastpub)


def _ones(cond: torch.Tensor) -> torch.Tensor:
    """bool -> int32 word mask: all 32 bits set where ``cond``, else 0."""
    return -cond.to(I32)


def _edge_forward_mask(state: SimState, cfg: SimConfig, key: torch.Tensor,
                       fwd_send: torch.Tensor | None = None) -> torch.Tensor:
    """[N, T, K] receiver-view forwarding mask: slot s's peer would forward
    a topic-t message to me, per router (propagate.py:146-177)."""
    n, t, _ = state.mesh.shape
    conn = state.connected[:, None, :]
    my_sub = state.subscribed[:, :, None]
    if cfg.router == "gossipsub":
        # along the sender's mesh, or its fanout when it is not subscribed;
        # the engine passes the heartbeat's receiver view
        if fwd_send is not None:
            return fwd_send
        send = state.mesh | (state.fanout & ~my_sub)
        return edge_gather(send, state, mode=cfg.edge_gather_mode)
    if cfg.router == "floodsub":
        # to every subscribed neighbour (floodsub.go:76-100)
        return conn & my_sub
    if cfg.router == "randomsub":
        # to max(D, ceil(sqrt N)) random subscribed neighbours, drawn
        # sender-side (randomsub.go:124-143) and seen through the edge
        # permutation; every candidate is chosen when the target exceeds K
        target = max(cfg.d, math.ceil(math.sqrt(cfg.n_peers)))
        cand = conn & state.nbr_subscribed                     # sender view
        sel = select_random(cand, torch.full((n, t), target,
                                             device=cand.device), key,
                            max_count=min(target, cfg.k_slots),
                            mode=cfg.selection_mode)
        return edge_gather(sel, state, mode=cfg.edge_gather_mode) \
            & conn & my_sub
    raise ValueError(f"unknown router {cfg.router!r}")


def _edge_topic_bits(mask_ntk: torch.Tensor, topic_bits: torch.Tensor,
                     w: int) -> torch.Tensor:
    """[N, T, K] edge mask -> [W, K, N] packed per-edge message words:
    OR over the topics t with mask[n, t, k] of topic_bits[t]
    (propagate.py:180-192; topic sets are disjoint, so OR == sum)."""
    n, t, k = mask_ntk.shape
    acc = torch.zeros((w, k, n), dtype=I32, device=topic_bits.device)
    zero = torch.zeros((), dtype=I32, device=topic_bits.device)
    for ti in range(t):
        acc = acc | torch.where(mask_ntk[:, ti, :].T[None, :, :],
                                topic_bits[ti][:, None, None], zero)
    return acc


def _slot_bitplanes(pend: torch.Tensor, k: int) -> torch.Tensor:
    """iwant_pending [N, M] (slot id or -1) -> packed per-slot ask sets
    [W, K, N], bit m of out[:, s, n] iff pend[n, m] == s, through
    ceil(log2 K) bit-planes of the slot index (propagate.py:195-212)."""
    n, m = pend.shape
    nbits = max(1, (k - 1).bit_length())
    valid = pack_words(pend >= 0)                              # [W, N]
    planes = [pack_words((pend > -1) & (((pend >> b) & 1) == 1))
              for b in range(nbits)]
    out = valid[:, None, :].expand(valid.shape[0], k, n)
    kk = torch.arange(k, device=pend.device)
    for b in range(nbits):
        kbit = ((kk >> b) & 1).bool()[None, :, None]
        out = out & torch.where(kbit, planes[b][:, None, :],
                                ~planes[b][:, None, :])
    return out


def _bits_to_slot(chosen: torch.Tensor, m: int) -> torch.Tensor:
    """Packed disjoint per-slot sets [W, K, N] -> [N, M] slot id or -1
    (inverse of :func:`_slot_bitplanes`, propagate.py:215-226)."""
    w, k, n = chosen.shape
    nbits = max(1, (k - 1).bit_length())
    any_bits = reduce_or(chosen, axis=1)                       # [W, N]
    slot = torch.zeros((n, m), dtype=I32, device=chosen.device)
    kk = torch.arange(k, device=chosen.device)
    for b in range(nbits):
        kbit = ((kk >> b) & 1).bool()[None, :, None]
        plane = reduce_or(torch.where(kbit, chosen, 0), axis=1)
        slot = slot + (unpack_words(plane, m).to(I32) << b)
    return torch.where(unpack_words(any_bits, m), slot, -1)


def _budgeted_iwant(offer: torch.Tensor, have_bits: torch.Tensor, m: int,
                    budget: int) -> torch.Tensor:
    """[W, K, N] packed offers -> [N, M] chosen slot per message (or -1),
    asking at most ``budget`` ids from any one slot, slots in order
    (the iasked counter, propagate.py:856-878)."""
    _, k, n = offer.shape
    assigned = have_bits
    pend = torch.full((n, m), -1, dtype=I32, device=offer.device)
    for ki in range(k):
        masked = offer[:, ki] & ~assigned                      # [W, N]
        rank = prefix_count_words(masked.T, m)
        take = unpack_words(masked, m) & (rank <= budget)
        pend = torch.where(take, ki, pend)
        assigned = assigned | pack_words(take)
    return pend


class _Tables(NamedTuple):
    """The tick's packed message tables, shared by both formulations."""
    topic_bits: torch.Tensor      # [T, W] live message sets per topic
    alive_bits: torch.Tensor      # [W]
    valid_msg_bits: torch.Tensor  # [W] alive, not invalid, not ignored
    vm: torch.Tensor              # [W, N] deliverable per receiver
    inv_n: torch.Tensor           # [W, N] REJECT per receiver (P4)
    ign_n: torch.Tensor           # [W, N] IGNORE per receiver
    window_old: torch.Tensor      # [W, N] P3 duplicate-credit window
    data_ok: torch.Tensor         # [N, K] bool data admission
    fwd_mask: torch.Tensor        # [N, T, K] bool receiver-view forwarding


class _Traffic(NamedTuple):
    """What the resolve and the hops leave behind."""
    have: torch.Tensor            # [W, N]
    dlv: torch.Tensor             # [W, N]
    behaviour_penalty: torch.Tensor  # [N, K] f32, broken promises added
    nv: torch.Tensor              # [T, K, N] first deliveries (count dtype)
    ni: torch.Tensor              # [T, K, N] invalid deliveries
    dup: torch.Tensor             # [T, K, N] mesh duplicates
    gater: dict | None            # ig, gdup, validated, throttled
    nv_acc: torch.Tensor | None = None  # [W, K, N] first-delivery slot sets
                                        # (provenance only)


def _flood_offer(state: SimState, cfg: SimConfig, tb: _Tables,
                 scores: torch.Tensor, nbr: torch.Tensor, gw) -> torch.Tensor:
    """[W, K, N] hop-0 offers of flood publish (propagate.py:498-545): the
    origin sends its own new messages to every subscribed topic peer that
    scores it >= publish_threshold (direct peers bypass the gate). The
    sender-side planes, its score of me and its direct flag for me, come
    through the edge permutation (``permutation_gather``: a float32 and an
    int32 payload; under ``"sort"`` both take one sort's permutation,
    propagate.py:500-530); with scoring off the gate is open and neither
    is gathered."""
    n, t, k = state.mesh.shape
    w = tb.topic_bits.shape[1]
    mode = cfg.edge_gather_mode
    rk = state.reverse_slot.clamp(0, k - 1)
    if cfg.scoring_enabled:
        sender_scores_me = permutation_gather(scores, nbr, rk, mode)
        sender_direct_me = permutation_gather(
            state.direct.to(I32), nbr, rk, mode) != 0
        score_gate = sender_direct_me \
            | (sender_scores_me >= cfg.publish_threshold)
    else:
        score_gate = torch.ones((n, k), dtype=torch.bool, device=nbr.device)
    flood_mask = state.connected[:, None, :] & state.subscribed[:, :, None] \
        & score_gate[:, None, :] & tb.data_ok[:, None, :]
    origin_bits = pack_words((state.deliver_tick == state.tick)
                             & (state.msg_publish_tick == state.tick)[None, :])
    return gw(origin_bits) & _edge_topic_bits(flood_mask, tb.topic_bits, w)


def _xla_traffic(state: SimState, cfg: SimConfig, tb: _Tables, have_bits,
                 dlv_bits, answer_bits, gw, answers_k, flood_offer,
                 link_ok, dup_edges, censor) -> _Traffic:
    """Resolve and hops in the non-fused formulation (propagate.py:425-483
    and :635-725): packed [W, K, N] per-slot sets, one words gather per
    hop, and the admission layers in the reference's order (graylist and
    gater in ``tb.data_ok``, then the per-edge queue cap, then the
    validation-queue cap), the gater's stats, flood publish's and link
    duplication's hop-0 offers, censors' withheld forwards and the
    provenance sets (the fault inputs as forward_tick takes them). Counts
    are kept in ``cfg.count_dtype`` (uint8 wraps as the reference's uint8
    adds do)."""
    n, t, k = state.mesh.shape
    w = have_bits.shape[0]
    cdt = _COUNT_DTYPES[cfg.count_dtype]
    cap = cfg.validation_queue_cap
    ecap = cfg.edge_queue_cap
    gater = cfg.gater_enabled

    def topic_counts(events):
        """[W, K, N] event words -> [T, K, N] per-topic counts."""
        return torch.stack([
            popcount_sum(events & tb.topic_bits[ti][:, None, None], axis=0,
                         dtype=cdt) for ti in range(t)])

    # -- step 1: last tick's IWANTs (gossipsub.go:698-739); pulled data is
    # still data, so graylist, gater, link faults and both budgets apply
    asked_k = _slot_bitplanes(state.iwant_pending, k) \
        & tb.alive_bits[:, None, None]
    if answers_k is None:
        answers_k = gw(answer_bits)                            # [W, K, N]
    got_k = asked_k & answers_k & ~have_bits[:, None, :] \
        & _ones(tb.data_ok.T)[None]
    if link_ok is None:
        broken_k = asked_k & ~answers_k
    else:
        # an answer the link ate is still a broken promise; a graylist,
        # gater or queue drop is not (propagate.py:441-451)
        broken_k = asked_k & ~(answers_k & _ones(link_ok.T)[None])
    throttled = torch.zeros((n,), dtype=I32, device=have_bits.device)
    if ecap > 0:
        # a pull that would blow the edge's budget drops whole
        pull_sz = popcount_sum(got_k, axis=0, dtype=I32)       # [K, N]
        got_k = got_k & _ones(pull_sz <= ecap)[None]
    if cap > 0:
        # over-budget pulls are dropped unseen and charged as throttle
        # events; the sender answered, so no broken promise
        cnt0 = popcount_sum(reduce_or(got_k, axis=1), axis=0, dtype=I32)
        fits0 = cnt0 <= cap
        got_k = got_k & _ones(fits0)[None, None, :]
        throttled = throttled + torch.where(fits0, 0, cnt0)
    got_any = reduce_or(got_k, axis=1)                         # [W, N]
    got_valid = got_k & tb.vm[:, None, :]
    got_valid_any = reduce_or(got_valid, axis=1)
    # broken promises: one P7 point per unfulfilled message id
    behaviour_penalty = state.behaviour_penalty \
        + popcount_sum(broken_k, axis=0).T
    have_bits = have_bits | got_any
    dlv_bits = dlv_bits | got_valid_any
    edge_used = popcount_sum(got_k, axis=0, dtype=I32) if ecap > 0 else None
    arrivals = popcount_sum(got_any, axis=0, dtype=I32)        # [N]
    validated = arrivals.float()

    # -- step 2: eager forwarding, up to prop_substeps hops
    allowed = _edge_topic_bits(tb.fwd_mask, tb.topic_bits, w)  # [W, K, N]
    mesh_eb = _edge_topic_bits(state.mesh, tb.topic_bits, w)   # [W, K, N]
    if dup_edges is not None:
        # a duplicating mesh edge re-offers the sender's recent deliveries
        # (its mcache gossip slice) on hop 0 (propagate.py:549-565)
        age_d = state.tick - state.deliver_tick
        dup_window = pack_words((age_d >= 0) & (age_d < cfg.history_gossip)) \
            & tb.alive_bits[:, None]
        if censor is not None:
            dup_window = dup_window & ~censor
        dup_kn = _ones((dup_edges & tb.data_ok).T)[None]
        dup_offer = gw(dup_window) & mesh_eb & dup_kn
    else:
        dup_offer = None
    frontier = pack_words(state.deliver_tick == state.tick) | got_valid_any
    dlv_new = got_valid_any
    nv = topic_counts(got_valid)
    ni = topic_counts(got_k & tb.inv_n[:, None, :])
    dup = torch.zeros((t, k, n), dtype=cdt, device=have_bits.device)
    nv_acc = got_valid if cfg.record_provenance else None
    if gater:
        ig = popcount_sum(got_k & tb.ign_n[:, None, :], axis=0, dtype=cdt)
        gdup = torch.zeros((k, n), dtype=cdt, device=have_bits.device)
    # exactly prop_substeps hops, with no host read. The reference's
    # while_loop runs no hop at all when the frontier starts empty, so
    # hop 0's extra offers ride only a non-empty frontier (a device-side
    # word mask). Past hop 0 an empty frontier offers nothing, so such a
    # hop adds zero to every count, as the loop's exit leaves them:
    # the edge budget and arrivals grow by 0, throttled and validated by
    # 0, the gater's ig and gdup by 0, provenance ORs in nothing.
    extras = [x for x in (flood_offer, dup_offer) if x is not None]
    if extras:
        started = torch.where(kc.pany((frontier != 0).any()), -1, 0) \
            .to(I32)
    for i in range(cfg.prop_substeps):
        # censors hold censored messages out of their offers; they did
        # receive them, so have and frontier keep them
        src = frontier if censor is None else frontier & ~censor
        offered = gw(src) & allowed                            # [W, K, N]
        if i == 0:
            for extra in extras:
                offered = offered | (extra & started)
        if ecap > 0:
            # drop-on-full, whole-RPC granularity (comm.go:156-191): the
            # hop's RPC on an edge fits the remaining budget or drops
            rpc_size = popcount_sum(offered, axis=0, dtype=I32)   # [K, N]
            edge_fits = (edge_used + rpc_size) <= ecap
            offered = offered & _ones(edge_fits)[None]
            edge_used = edge_used + torch.where(edge_fits, rpc_size, 0)
        excl = exclusive_prefix_or(offered, axis=1)
        new_from_k = offered & ~excl & ~have_bits[:, None, :]
        new_any = (excl[:, -1] | offered[:, -1]) & ~have_bits  # [W, N]
        if cap > 0:
            # validation admission (validation.go:246-260): a receiver
            # whose budget this hop's arrivals would blow drops them unseen
            cnt = popcount_sum(new_any, axis=0, dtype=I32)     # [N]
            fits = (arrivals + cnt) <= cap
            fit_m = _ones(fits)[None, :]
            new_any = new_any & fit_m
            new_from_k = new_from_k & fit_m[:, None, :]
            arrivals = arrivals + torch.where(fits, cnt, 0)
            throttled = throttled + torch.where(fits, 0, cnt)
            validated = validated + torch.where(fits, cnt, 0).float()
        elif gater:
            # unbounded queue: every admitted message counts as validated
            validated = validated + popcount_sum(new_any, axis=0)
        new_valid = new_any & tb.vm
        nv_ev = new_from_k & tb.vm[:, None, :]
        nv = nv + topic_counts(nv_ev)
        ni = ni + topic_counts(new_from_k & tb.inv_n[:, None, :])
        # mesh-delivery credit for every mesh sender of a message held
        # valid within the credit window (score.go:938-981)
        elig = (tb.window_old | dlv_new | new_valid) \
            & tb.valid_msg_bits[:, None]
        dup = dup + topic_counts(offered & mesh_eb & elig[:, None, :])
        if gater:
            ig = ig + popcount_sum(new_from_k & tb.ign_n[:, None, :],
                                   axis=0, dtype=cdt)
            # seen-cache hits: offers of a message already seen or won by
            # another slot this hop (pubsub.go:1145-1148)
            gdup = gdup + popcount_sum(
                offered & ~new_from_k & (have_bits | new_any)[:, None, :],
                axis=0, dtype=cdt)
        if nv_acc is not None:
            nv_acc = nv_acc | nv_ev
        frontier = new_valid
        have_bits = have_bits | new_any
        dlv_bits = dlv_bits | new_valid
        dlv_new = dlv_new | new_valid
    stats = dict(ig=ig, gdup=gdup, validated=validated,
                 throttled=throttled) if gater else None
    return _Traffic(have_bits, dlv_bits, behaviour_penalty, nv, ni, dup,
                    stats, nv_acc)


def forward_tick(state: SimState, cfg: SimConfig, tp: TopicParams,
                 inc_gossip: torch.Tensor, scores: torch.Tensor,
                 key: torch.Tensor, *,
                 fwd_send: torch.Tensor | None = None,
                 answers_k: torch.Tensor | None = None,
                 link_ok: torch.Tensor | None = None,
                 dup_edges: torch.Tensor | None = None,
                 censor_bits: torch.Tensor | None = None) -> SimState:
    """One tick of data-plane traffic: resolve last tick's IWANTs, run
    ``prop_substeps`` forwarding hops, fold the counters, emit this
    tick's IHAVE/IWANT (propagate.py:229-853).

    ``scores`` is the heartbeat's [N, K] score cache; ``inc_gossip`` and
    ``fwd_send`` are its receiver views (HeartbeatOut); ``fwd_send=None``
    makes the gossipsub router gather its own, and floodsub and randomsub
    take none. ``answers_k`` is the IWANT answer table's receiver view when
    the heartbeat routed it (engine._iwant_answer_extras). ``key`` feeds
    randomsub's draw and the gater's admission draw.

    The fault plane's inputs (sim/faults.py): ``link_ok`` ([N, K] bool) is
    the tick's lossy-link draw, ANDed into the data admission; a pull
    answer it eats is still a broken promise. ``dup_edges`` ([N, K] bool)
    makes mesh edges re-offer their recent deliveries on hop 0.
    ``censor_bits`` ([W, N] packed) marks the slots each sender withholds:
    no pull answer, no forward, while it still receives them."""
    n, t, k = state.mesh.shape
    m = cfg.msg_window
    cdt = _COUNT_DTYPES.get(cfg.count_dtype)
    if cdt is None:
        raise ValueError(f"count_dtype={cfg.count_dtype!r}: only 'uint8' and "
                         "'int32' are supported")
    if m > torch.iinfo(cdt).max:
        raise ValueError(f"msg_window={m} > {torch.iinfo(cdt).max} would wrap "
                         f"the {cfg.count_dtype} hop-count accumulators; "
                         "shrink the window or widen count_dtype")
    w = (m + 31) // 32
    k_fwd, k_gate = rng.split(key, 2)
    dev = state.mesh.device
    tick = state.tick
    nbr = state.neighbors.clamp(0, kc.global_rows(n) - 1)  # [N, K]
    mal = state.malicious
    zero = torch.zeros((), dtype=I32, device=dev)

    def gw(table):
        """The tick's words gather."""
        return gather_words_rows(table, nbr, cfg.edge_gather_mode, m=m)

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
    ign_n = torch.where(mal[None, :], zero, ignored_bits[:, None])      # [W,N]

    have_bits = state.have.T.contiguous()                               # [W,N]
    dlv_bits = pack_words(state.deliver_tick < NEVER)                   # [W,N]
    dlv_start = dlv_bits
    n_have_start = popcount(have_bits).to(torch.int64).sum()

    if cfg.scoring_enabled:
        accept_ok = scores >= cfg.graylist_threshold      # [N,K] AcceptFrom
        gossip_ok = scores >= cfg.gossip_threshold        # [N,K] handleIHave
    else:
        accept_ok = torch.ones((n, k), dtype=torch.bool, device=dev)
        gossip_ok = accept_ok
    # gater RED admission for DATA (control still flows); malicious
    # receivers run no gater of their own
    if cfg.gater_enabled:
        data_ok = accept_ok & (accept_data(state, cfg, k_gate) | mal[:, None])
    else:
        data_ok = accept_ok
    if link_ok is not None:
        # lossy links drop the edge's data plane for the tick
        data_ok = data_ok & link_ok
    # P3 duplicate-credit window (score.go:949-981)
    age_dlv = tick - state.deliver_tick
    window_old = pack_words((age_dlv >= 0)
                            & (age_dlv <= cfg.mesh_message_deliveries_window_ticks))
    fwd_mask = _edge_forward_mask(state, cfg, k_fwd, fwd_send)
    tb = _Tables(topic_bits, alive_bits, valid_msg_bits, vm, inv_n, ign_n,
                 window_old, data_ok, fwd_mask & data_ok[:, None, :])

    # malicious sources never answer IWANTs; honest sources answer from
    # their mcache, which rejected/ignored messages never enter; censors
    # withhold the victim's messages
    answer_bits = torch.where(mal[None, :], zero, dlv_bits)            # [W,N]
    if censor_bits is not None:
        answer_bits = answer_bits & ~censor_bits
    flood = _flood_offer(state, cfg, tb, scores, nbr, gw) \
        if cfg.flood_publish and cfg.router == "gossipsub" else None
    tr = _xla_traffic(state, cfg, tb, have_bits, dlv_bits, answer_bits,
                      gw, answers_k, flood, link_ok, dup_edges, censor_bits)
    have_bits, dlv_bits = tr.have, tr.dlv

    # [T,K,N] counts -> [N,T,K] f32 counter increments, folded with this
    # tick's decay: min(zclamp(counter * decay) + arrivals, cap)
    fmd_add = tr.nv.permute(2, 0, 1).float()
    imd_add = tr.ni.permute(2, 0, 1).float()
    mmd_add = tr.dup.permute(2, 0, 1).float()

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
    # the seen-set totals are counts over every peer, taken whole before
    # the float32 difference
    totals = kc.psum(torch.stack([popcount(have_bits).to(torch.int64).sum(),
                                  n_have_start]))
    delivered = totals[0].float() - totals[1].float()
    if tr.nv_acc is not None:
        # provenance: the winning sender slot of each first delivery this
        # tick, pulls included (trace export reads it)
        state = state._replace(deliver_from=torch.where(
            new_dlv_mask, _bits_to_slot(tr.nv_acc, m), state.deliver_from))
    state = state._replace(
        have=have_bits.T.contiguous(), deliver_tick=deliver_tick,
        first_message_deliveries=fmd,
        mesh_message_deliveries=mmd,
        invalid_message_deliveries=imd,
        behaviour_penalty=tr.behaviour_penalty,
        delivered_total=state.delivered_total + delivered)

    if tr.gater is not None:
        # gater stats where the reference's RawTracer hooks fire
        # (peer_gater.go:366-453); per-topic counts sum over T
        g = tr.gater

        def sum_t(c):
            return c.float().sum(0).T

        state = state._replace(
            gater_deliver=state.gater_deliver + sum_t(tr.nv),
            gater_duplicate=state.gater_duplicate + g["gdup"].float().T,
            gater_ignore=state.gater_ignore + g["ig"].float().T,
            gater_reject=state.gater_reject + sum_t(tr.ni),
            gater_validate=state.gater_validate + g["validated"],
            gater_throttle=state.gater_throttle + g["throttled"].float(),
            gater_last_throttle=torch.where(g["throttled"] > 0, tick,
                                            state.gater_last_throttle))

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
    offer = gw(window_bits) & _edge_topic_bits(inc_gossip, topic_bits, w)
    if cfg.max_iwant_per_tick >= m:
        # the budget cannot bind: the lowest offering slot per message
        excl = exclusive_prefix_or(offer, axis=1)
        iwant_pending = _bits_to_slot(
            offer & ~excl & ~have_bits[:, None, :], m)
    else:
        iwant_pending = _budgeted_iwant(offer, have_bits, m,
                                        cfg.max_iwant_per_tick)
    return state._replace(iwant_pending=iwant_pending)
