"""Batched peer scoring: P1-P7 over [N, T, K] counters (port of
ops/score_ops.py).

Decay placement is the reference's (its module docstring, PERF_MODEL.md
S5): stored counters are pre-decay values, every reader applies
``zclamp(counter * decay)`` inline, every per-tick writer folds the same
decay into its write. The float32 arithmetic is written op for op as the
reference's so that the port's counters equal its bits.
"""

from __future__ import annotations

import torch

from ..sim.config import SimConfig, TopicParams
from ..sim.state import NEVER, SimState


def _t(x: torch.Tensor) -> torch.Tensor:
    return x[None, :, None]


def decayed(v: torch.Tensor, factor, z: float) -> torch.Tensor:
    """One refreshScores decay step applied inline at a read/write site:
    multiply by the decay factor, zero below decay_to_zero (score.go:504-565)."""
    v = v * factor
    return torch.where(v < z, torch.zeros_like(v), v)


def compute_scores(state: SimState, cfg: SimConfig, tp: TopicParams,
                   mask_disconnected: bool = True,
                   apply_decay: bool = False) -> torch.Tensor:
    """Score of the peer in slot k as seen by observer n -> [N, K] f32
    (score.go:265-342). ``apply_decay`` applies this tick's decay inline at
    the read, as the engine's heartbeat does."""
    if not cfg.scoring_enabled:
        return torch.zeros(state.behaviour_penalty.shape, dtype=torch.float32,
                           device=state.behaviour_penalty.device)
    z = cfg.decay_to_zero
    dec = decayed if apply_decay else (lambda v, factor, z: v)
    in_mesh = state.mesh
    zero = torch.zeros((), dtype=torch.float32, device=in_mesh.device)
    mesh_time = torch.where(in_mesh, (state.tick - state.graft_tick).float(),
                            zero)
    # P1: floor(mesh_time/quantum), capped (score.go:285-291)
    p1 = torch.minimum(torch.floor(mesh_time / _t(tp.time_in_mesh_quantum_ticks)
                                   + 1e-9), _t(tp.time_in_mesh_cap))
    topic_score = torch.where(in_mesh, p1 * _t(tp.time_in_mesh_weight), zero)
    # P2
    topic_score = topic_score + dec(
        state.first_message_deliveries, _t(tp.first_message_deliveries_decay),
        z) * _t(tp.first_message_deliveries_weight)
    # P3: squared deficit once activated (score.go:297-303)
    deficit = _t(tp.mesh_message_deliveries_threshold) - dec(
        state.mesh_message_deliveries, _t(tp.mesh_message_deliveries_decay), z)
    p3 = torch.where(state.mesh_active & (deficit > 0), deficit * deficit, zero)
    topic_score = topic_score + p3 * _t(tp.mesh_message_deliveries_weight)
    # P3b
    topic_score = topic_score + dec(
        state.mesh_failure_penalty, _t(tp.mesh_failure_penalty_decay), z) \
        * _t(tp.mesh_failure_penalty_weight)
    # P4: squared counter
    imd = dec(state.invalid_message_deliveries,
              _t(tp.invalid_message_deliveries_decay), z)
    topic_score = topic_score + (imd * imd) * \
        _t(tp.invalid_message_deliveries_weight)

    weighted = topic_score * _t(tp.topic_weight)
    score = torch.zeros_like(weighted[:, 0, :])
    for ti in range(weighted.shape[1]):          # the reference's T-sum order
        score = score + weighted[:, ti, :]
    if cfg.topic_score_cap > 0:
        score = torch.clamp(score, max=cfg.topic_score_cap)

    nbr = state.neighbors.clamp(min=0).long()
    # P5: app-specific (score.go:326-327)
    if cfg.app_specific_weight != 0.0:
        score = score + cfg.app_specific_weight * state.app_score[nbr]
    # P6: IP colocation surplus^2 (score.go:329-331, 344-385)
    if cfg.ip_colocation_factor_weight != 0.0:
        # a scatter into the static bound (torch.bincount reads the
        # input's maximum on the host); groups outside [0, n_ip_groups)
        # are dropped, not clamped
        g = state.ip_group.long()
        inside = (g >= 0) & (g < cfg.n_ip_groups)
        counts = torch.zeros(cfg.n_ip_groups, dtype=torch.int64,
                             device=g.device).index_add_(
            0, torch.where(inside, g, 0), inside.long())
        surplus = (counts[state.ip_group.long()]
                   - cfg.ip_colocation_factor_threshold).float()
        p6 = torch.where(surplus > 0, surplus * surplus, zero)
        score = score + cfg.ip_colocation_factor_weight * p6[nbr]
    # P7: behaviour penalty excess^2 (score.go:334-339)
    if cfg.behaviour_penalty_weight != 0.0:
        bp = dec(state.behaviour_penalty, cfg.behaviour_penalty_decay, z)
        excess = bp - cfg.behaviour_penalty_threshold
        score = score + torch.where(excess > 0, excess * excess, zero) \
            * cfg.behaviour_penalty_weight

    if mask_disconnected:
        return torch.where(state.connected, score, zero)
    return torch.where(state.neighbors >= 0, score, zero)


def advance_active_latch(state: SimState, tp: TopicParams) -> SimState:
    """Advance the P3 activation latch (score.go:550-556) at the top of the
    heartbeat, before compute_scores."""
    mesh_time = (state.tick - state.graft_tick).float()
    active = state.mesh_active | (
        state.mesh & (mesh_time > _t(tp.mesh_message_deliveries_activation_ticks)))
    return state._replace(mesh_active=active)


def apply_prune_penalty(state: SimState, pruned: torch.Tensor, tp: TopicParams,
                        decay_to_zero: float = 0.0,
                        apply_decay: bool = False) -> SimState:
    """P3b sticky failure penalty on prune (score.go:672-694): where an edge
    is pruned while the P3 penalty is active and under threshold, add the
    squared deficit; then clear the activation latch for the slot.
    ``apply_decay=True`` (the heartbeat's call) folds this tick's decay of
    mmd/mfp in, exactly once per tick."""
    if apply_decay:
        mmd = decayed(state.mesh_message_deliveries,
                      _t(tp.mesh_message_deliveries_decay), decay_to_zero)
        mfp = decayed(state.mesh_failure_penalty,
                      _t(tp.mesh_failure_penalty_decay), decay_to_zero)
    else:
        mmd = state.mesh_message_deliveries
        mfp = state.mesh_failure_penalty
    deficit = _t(tp.mesh_message_deliveries_threshold) - mmd
    zero = torch.zeros((), dtype=torch.float32, device=mmd.device)
    add = torch.where(pruned & state.mesh_active & (deficit > 0),
                      deficit * deficit, zero)
    return state._replace(
        mesh_failure_penalty=mfp + add,
        mesh_active=torch.where(pruned, False, state.mesh_active),
        graft_tick=torch.where(pruned, torch.full_like(state.graft_tick, NEVER),
                               state.graft_tick))
