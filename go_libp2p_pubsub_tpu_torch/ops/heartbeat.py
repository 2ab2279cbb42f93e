"""Batched gossipsub heartbeat: mesh maintenance for all N peers at once
(port of ops/heartbeat.py).

The reference's round semantics hold unchanged: decisions read the
pre-round state, GRAFT/PRUNE exchange resolves in the same round through
the packed edge exchange, and receiver-side GRAFT vetting serializes
acceptance lowest-slot-first (ops/heartbeat.py module docstring). The
reference's ``lax.cond``-gated blocks run unconditionally here, in their
ungated form, which the reference states is bit-identical
(heartbeat.py:260-265): a skipped block equals selecting with count 0,
and the keys are split up front, so running a block uses no extra
randomness. A row a block leaves alone keeps the block's else value:
a zero count selects nothing, the over block merges by ``over``, the
fanout block masks its rows by ``fanout_alive``, and the opportunistic
block takes a ``torch.where`` on the device's tick test. So the
heartbeat reads nothing on the host and a tick can be captured in a CUDA
graph (parallel/compile_plan.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import rng
from ..parallel import kernel_context as kc
from ..sim.config import SimConfig, TopicParams
from ..sim.state import NEVER, SimState
from ..spans import span
from .bits import I32, pack_bool, prefix_count
from .permgather import (_edge_table_mxu, edge_sort_key, edge_table,
                         permutation_gather, resolve_edge_packed_mode,
                         sort_permutation)
from .score_ops import (
    advance_active_latch,
    apply_prune_penalty,
    compute_scores,
    decayed,
)
from .selection import masked_median, select_random, select_top


def edge_gather(x: torch.Tensor, state: SimState, fill=False,
                mode: str = "auto") -> torch.Tensor:
    """incoming[j, t, s] = x[neighbors[j,s], t, reverse_slot[j,s]]
    (heartbeat.py:40-57): the receiver-side view of per-edge state, invalid
    slots reading ``fill``. A boolean mask with ``fill=False`` rides the
    packed exchange; other dtypes and fills take the indexed gather, whose
    output type is the reference's (``x``'s, or float32 for a float fill
    of an integer or bool plane, int32 for an int fill of a bool plane)."""
    if x.dtype == torch.bool and fill is False:
        return edge_gather_packed([x], state, mode)[0][0]
    n, t, k = x.shape
    j = state.neighbors.clamp(0, kc.global_rows(n) - 1).long()[:, None, :]
    x = kc.replicate(x)
    rk = state.reverse_slot.clamp(0, k - 1).long()[:, None, :]
    tt = torch.arange(t, device=x.device)[None, :, None]
    y = x[j, tt, rk]
    valid = ((state.neighbors >= 0) & (state.reverse_slot >= 0))[:, None, :]
    # jnp.where's promotion of a Python scalar fill
    if isinstance(fill, float) and not y.dtype.is_floating_point:
        dtype = torch.float32
    elif y.dtype == torch.bool and not isinstance(fill, bool):
        dtype = torch.int32
    else:
        dtype = y.dtype
    return torch.where(valid, y.to(dtype),
                       torch.full((), fill, dtype=dtype, device=x.device))


def _plane_payloads(planes: torch.Tensor) -> list[torch.Tensor]:
    """[N, B, K] bool planes -> one [N, K] int32 payload per 32 planes, bit
    i of group g holding plane 32 g + i (heartbeat.py:146-151), built one
    plane at a time in int32 (bit 31 is the sign bit): packing the slots'
    bits in place would widen every slot to a 32-bit int64 row."""
    n, b, k = planes.shape
    out = []
    for w0 in range(0, b, 32):
        acc = torch.zeros((n, k), dtype=I32, device=planes.device)
        for i in range(min(32, b - w0)):
            acc = acc | (planes[:, w0 + i, :].to(I32) << i)
        out.append(acc)
    return out


def edge_gather_packed(masks: list, state: SimState, mode: str = "auto",
                       extra_words=()):
    """Gather several [N, T, K] boolean edge masks through the reverse-edge
    permutation: ``incoming[j, t, s] = x[neighbors[j,s], t,
    reverse_slot[j,s]]``, invalid slots False (heartbeat.py:60-199), in the
    formulation ``mode`` resolves to (ops/permgather.
    resolve_edge_packed_mode). ``"pallas"`` packs all B planes x K slots
    into one [N, ceil(B*K/32)] bit-table routed by :func:`edge_table`,
    ``"mxu"`` routes that table through the flat take
    (``_edge_table_mxu``); the others build one [N, K] payload per 32
    planes: ``"scalar"``/``"rows"`` route each through
    ``permutation_gather``, ``"sort"`` routes every group by ONE sort
    permutation of the n-major ``edge_sort_key``.

    ``extra_words``: [W_i, N] int32 word tables that ride the same
    exchange under ``"sort"`` (extra lanes of the sort's permutation) or
    ``"mxu"`` (extra rows of the take); any other formulation raises.
    They come back as [W_i, K, N] receiver views ``out[w, k, n] =
    tab[w, neighbors[n, k]]`` with invalid slots word-ANDed to 0. Returns
    ``(masks, extras)``, the extras empty when none were passed."""
    n, t, k = masks[0].shape
    planes = torch.cat(masks, dim=1)                       # [N, B, K]
    b = planes.shape[1]
    jn = state.neighbors.clamp(0, kc.global_rows(n) - 1)
    rk = state.reverse_slot.clamp(0, k - 1)
    valid = ((state.neighbors >= 0) & (state.reverse_slot >= 0))[:, None, :]
    mode = resolve_edge_packed_mode(mode, kc.global_rows(n), k, b)
    ctx = kc.current_kernel_mesh()
    if extra_words and mode not in ("sort", "mxu"):
        raise ValueError(f"extra_words requires the sort or mxu formulation "
                         f"(resolved {mode!r}); callers gate on "
                         f"resolve_edge_packed_mode")
    extras_views = []
    if mode in ("pallas", "mxu"):
        table = pack_bool(planes.reshape(n, b * k))        # [N, ceil(BK/32)]
        if mode == "mxu":
            groups, extras_views = _edge_table_mxu(table, jn, rk, b,
                                                   tuple(extra_words))
        else:
            groups = edge_table(table, jn, rk, b)
    else:
        payloads = _plane_payloads(planes)
        if mode == "sort" and ctx is not None and ctx.route == "halo":
            # every group and extra lane rides one halo route
            # (heartbeat.py:155-162): an extra lane carries tab[w, j] on
            # each of j's K slots
            from ..parallel.halo import route_payloads_halo
            lanes = [tab[i][:, None].expand(n, k).contiguous()
                     for tab in extra_words for i in range(tab.shape[0])]
            routed = route_payloads_halo(payloads + lanes, state.neighbors,
                                         state.reverse_slot)
            groups, ofs = routed[:len(payloads)], len(payloads)
            for tab in extra_words:
                wt = tab.shape[0]
                extras_views.append(torch.stack(
                    [routed[ofs + i].T for i in range(wt)]))
                ofs += wt                                  # [W_i, K, N]
        elif mode == "sort":
            perm = sort_permutation(edge_sort_key(
                state.neighbors, state.reverse_slot, k_major=False))
            groups = [kc.replicate(p).reshape(-1)[perm].reshape(n, k)
                      for p in payloads]
            # an extra lane carries tab[w, j] on each of j's K slots
            src = torch.div(perm, k, rounding_mode="floor")
            extras_views = [kc.replicate(tab, dim=1)[:, src]
                            .reshape(-1, n, k).transpose(1, 2)
                            for tab in extra_words]        # [W_i, K, N]
        else:
            groups = [permutation_gather(p, jn, rk, mode) for p in payloads]
    parts = []
    for w0, g in zip(range(0, b, 32), groups):
        nb = min(32, b - w0)
        bit = 1 << torch.arange(nb, dtype=I32, device=g.device)[None, :, None]
        parts.append((g[:, None, :] & bit) != 0)
    flat = torch.cat(parts, dim=1) & valid
    results = [flat[:, i * t:(i + 1) * t, :] for i in range(len(masks))]
    vmask = torch.where(valid[:, 0, :].T, -1, 0).to(I32)   # [K, N]
    return results, [view & vmask[None] for view in extras_views]


class HeartbeatOut(NamedTuple):
    state: SimState
    scores: torch.Tensor      # [N, K] pre-maintenance scores; disconnected 0
    scores_all: torch.Tensor  # [N, K] same cache WITHOUT the connected mask
    inc_gossip: torch.Tensor  # [N, T, K] receiver view of emitGossip edges
    fwd_send: torch.Tensor    # [N, T, K] receiver view of eager-forward edges
    extra_routed: tuple = ()  # receiver views ([W_i, K, N]) of the caller's
                              # extra_words, routed on the final exchange
                              # (the sort and mxu formulations; invalid
                              # slots read 0); empty when none were passed


def heartbeat(state: SimState, cfg: SimConfig, tp: TopicParams,
              key: torch.Tensor,
              extra_words: list | None = None) -> HeartbeatOut:
    n, t, k = state.mesh.shape
    tick = state.tick
    ks = rng.split(key, 8)
    sel = cfg.selection_mode

    with span("heartbeat.score"):
        state = advance_active_latch(state, tp)
        scores_all = compute_scores(state, cfg, tp, mask_disconnected=False,
                                    apply_decay=True)
        zero = torch.zeros((), dtype=torch.float32,
                           device=scores_all.device)
        scores = torch.where(state.connected, scores_all, zero)   # [N, K]
    s = scores[:, None, :]
    sb = s.expand(n, t, k)
    joined = state.subscribed[:, :, None]
    conn = state.connected[:, None, :]
    out3 = state.outbound[:, None, :]
    direct3 = state.direct[:, None, :]
    nbr_sub = state.nbr_subscribed & conn
    backoff_ok = tick >= state.backoff
    backoff_active = ~backoff_ok

    mesh = state.mesh & joined
    # graft candidates (gossipsub.go:1413-1427)
    candidate = conn & nbr_sub & ~mesh & backoff_ok & (s >= 0) & ~direct3 & joined

    # 1. prune all negative-score mesh members (gossipsub.go:1404-1410)
    prune_neg = mesh & (s < 0)
    mesh1 = mesh & ~prune_neg
    candidate = candidate & ~prune_neg

    # 2. undersubscribed: graft random candidates up to D
    n_mesh = mesh1.sum(-1)
    need = torch.where(n_mesh < cfg.dlo, cfg.d - n_mesh, 0)
    # rows with need 0 or no candidate select nothing
    with span("heartbeat.select"):
        graft1 = select_random(candidate, need, ks[0], max_count=cfg.d,
                               mode=sel)
    mesh2 = mesh1 | graft1

    # 3. oversubscribed: keep top-Dscore by score + random rest to D, then
    # bubble up to Dout outbound among the kept (gossipsub.go:1430-1490)
    n2 = mesh2.sum(-1)
    over = (n2 > cfg.dhi)[..., None]
    with span("heartbeat.select"):
        protected = select_top(sb, mesh2, cfg.dscore, max_count=cfg.dscore,
                               mode=sel)
    rest = mesh2 & ~protected
    with span("heartbeat.select"):
        keep_rand = select_random(rest, cfg.d - cfg.dscore, ks[1],
                                  max_count=cfg.d - cfg.dscore, mode=sel)
    kept = protected | keep_rand
    n_out_kept = (kept & out3).sum(-1)
    deficit_out = torch.clamp(cfg.dout - n_out_kept, min=0)
    with span("heartbeat.select"):
        add_out = select_random(mesh2 & ~kept & out3, deficit_out, ks[2],
                                max_count=cfg.dout, mode=sel)
    with span("heartbeat.select"):
        remove_nonout = select_random(keep_rand & ~out3, add_out.sum(-1),
                                      ks[3], max_count=cfg.dout, mode=sel)
    kept = (kept | add_out) & ~remove_nonout
    # rows that are not over keep mesh2
    mesh3 = torch.where(over, kept, mesh2)
    prune_over = mesh2 & ~mesh3

    # 4. outbound quota top-up in the [Dlo, Dhi] regime (gossipsub.go:1493-1518)
    n3 = mesh3.sum(-1)
    n_out = (mesh3 & out3).sum(-1)
    need_out = torch.where((n3 >= cfg.dlo) & ~over[..., 0] & (n_out < cfg.dout),
                           cfg.dout - n_out, 0)
    out_cand = candidate & out3 & ~mesh3
    with span("heartbeat.select"):
        graft_out = select_random(out_cand, need_out, ks[4],
                                  max_count=cfg.dout, mode=sel)
    mesh4 = mesh3 | graft_out

    # 5. opportunistic grafting every OpportunisticGraftTicks when the median
    # mesh score sags below the threshold (gossipsub.go:1521-1552); off
    # the graft tick every row's count is 0
    og_tick = (tick % cfg.opportunistic_graft_ticks) == 0
    with span("heartbeat.select"):
        med = masked_median(sb, mesh4)                        # [N, T]
    og_cond = (mesh4.sum(-1) > 1) & (med < cfg.opportunistic_graft_threshold) \
        & og_tick
    og_need = torch.where(og_cond, cfg.opportunistic_graft_peers, 0)
    with span("heartbeat.select"):
        og_sel = select_random(candidate & (sb > med[..., None]) & ~mesh4,
                               og_need, ks[5],
                               max_count=cfg.opportunistic_graft_peers,
                               mode=sel)
    mesh5 = mesh4 | og_sel

    grafts = graft1 | graft_out | og_sel
    prunes = prune_neg | prune_over

    # --- cross-peer exchange, all against pre-round state ---
    with span("heartbeat.exchange"):
        (inc_graft, inc_prune), _ = edge_gather_packed(
            [grafts, prunes], state, cfg.edge_gather_mode)

    # receiver-side GRAFT vetting (gossipsub.go:741-837), capacity-budgeted
    # lowest-slot-first against the growing mesh (heartbeat.py:345-375)
    already = inc_graft & mesh5
    hard_refuse = inc_graft & ~already & \
        (~joined | backoff_active | (s < 0) | direct3)
    cand_graft = inc_graft & ~already & ~hard_refuse
    n_mine = mesh5.sum(-1, keepdim=True)
    acc_out = cand_graft & out3
    nonout = cand_graft & ~out3
    c_out_excl = prefix_count(acc_out, exclusive=True)
    rank = prefix_count(nonout)                             # 1-based
    accept = already | acc_out | \
        (nonout & (n_mine + c_out_excl + rank <= cfg.dhi))
    refuse = inc_graft & ~accept
    # graft-during-backoff behaviour penalty (gossipsub.go:781-795)
    prune_tick = state.backoff - cfg.prune_backoff_ticks
    flood = backoff_active & (tick < prune_tick + cfg.graft_flood_ticks)
    bp_add = (inc_graft & backoff_active).sum(1).float() \
        + (inc_graft & flood).sum(1).float()
    behaviour_penalty = decayed(state.behaviour_penalty,
                                cfg.behaviour_penalty_decay,
                                cfg.decay_to_zero) + bp_add

    with span("heartbeat.exchange"):
        (refused_back,), _ = edge_gather_packed([refuse], state,
                                                cfg.edge_gather_mode)

    new_mesh = ((mesh5 | accept) & ~inc_prune & ~refused_back) & joined
    pruned_any = prunes | inc_prune | refused_back | (refuse & joined)
    new_backoff = torch.where(pruned_any, tick + cfg.prune_backoff_ticks,
                              state.backoff)

    # score hooks: Graft (score.go:649-667), Prune (score.go:669-694)
    newly = new_mesh & ~state.mesh
    removed = state.mesh & ~new_mesh

    # fanout maintenance (gossipsub.go:1560-1596)
    fanout_alive = (state.fanout_lastpub < NEVER) & \
        (tick <= state.fanout_lastpub + cfg.fanout_ttl_ticks) & ~state.subscribed
    fa3 = fanout_alive[..., None]
    # rows with no live fanout keep nothing and add nothing (all zeros, the
    # reference's else value)
    keep_f = state.fanout & conn & nbr_sub & \
        (s >= cfg.publish_threshold) & fa3
    need_f = torch.where(fanout_alive,
                         torch.clamp(cfg.d - keep_f.sum(-1), min=0), 0)
    with span("heartbeat.select"):
        add_f = select_random(
            conn & nbr_sub & ~keep_f & ~direct3
            & (s >= cfg.publish_threshold) & fa3,
            need_f, ks[7], max_count=cfg.d, mode=sel)
    new_fanout = keep_f | add_f
    fanout_lastpub = torch.where(fanout_alive, state.fanout_lastpub,
                                 torch.full_like(state.fanout_lastpub, NEVER))

    st = state._replace(mesh=new_mesh, backoff=new_backoff,
                        behaviour_penalty=behaviour_penalty,
                        fanout=new_fanout, fanout_lastpub=fanout_lastpub)
    st = apply_prune_penalty(st, removed, tp,
                             decay_to_zero=cfg.decay_to_zero,
                             apply_decay=True)
    st = st._replace(
        graft_tick=torch.where(newly, tick, st.graft_tick),
        mesh_active=torch.where(newly, False, st.mesh_active))

    # emitGossip peer selection (gossipsub.go:1711-1775): target
    # max(Dlazy, floor(f32(factor) * n_cand)) in float32 as the reference
    gossip_cand = conn & nbr_sub & ~new_mesh & ~new_fanout & ~direct3 & \
        (s >= cfg.gossip_threshold) & (joined | fa3)
    n_cand = gossip_cand.sum(-1)
    # the float32 factor as a Python float (exact), multiplied in float32
    factor = float(np.float32(cfg.gossip_factor))
    target = torch.clamp(torch.floor(n_cand.float() * factor).to(I32),
                         min=cfg.dlazy)
    # the static bound on target, in the same float32 arithmetic
    # (heartbeat.py:460-465)
    gossip_bound = max(cfg.dlazy, int(np.floor(
        np.float32(cfg.gossip_factor) * np.float32(k))))
    with span("heartbeat.select"):
        gossip_sel = select_random(gossip_cand, target, ks[6],
                                   max_count=gossip_bound, mode=sel)

    # one shared exchange hands forward_tick its receiver views: who gossips
    # to me, and whose eager forwarding reaches me (gossipsub.go:1020-1035)
    send = new_mesh | (new_fanout & ~state.subscribed[:, :, None])
    with span("heartbeat.exchange"):
        (inc_gossip, fwd_send), extras = edge_gather_packed(
            [gossip_sel, send], st, cfg.edge_gather_mode,
            extra_words=extra_words or ())

    return HeartbeatOut(state=st, scores=scores, scores_all=scores_all,
                        inc_gossip=inc_gossip, fwd_send=fwd_send,
                        extra_routed=tuple(extras))
