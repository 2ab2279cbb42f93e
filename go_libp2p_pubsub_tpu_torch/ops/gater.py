"""Batched peer gater: Random-Early-Drop admission over neighbour slots
(port of ops/gater.py, peer_gater.go:119-363).

Per-receiver ``validate``/``throttle`` counters decay with
``gater_global_decay``, per-source deliver/duplicate/ignore/reject stats
with ``gater_source_decay``; ``accept_data`` admits data from a source
with probability (1 + deliver) / (1 + weighted total) unless the gate is
off. Throttle events come from the validation admission cap, charged in
ops/propagate.py. The float32 arithmetic is the reference's op for op, with
every Python float applied as a float32 constant (JAX's weak type), so a
draw ``noise < p`` falls the same way in both packages.
"""

from __future__ import annotations

import torch

from .. import rng
from ..sim.config import SimConfig
from ..sim.state import SimState


def gater_decay(state: SimState, cfg: SimConfig) -> SimState:
    """Per-tick stat decay (peer_gater.go:219-259): multiply by the decay
    factor, zero below ``decay_to_zero``, every slot alike."""
    z = cfg.decay_to_zero

    def dec(v, factor):
        v = v * factor
        return torch.where(v < z, torch.zeros_like(v), v)

    return state._replace(
        gater_validate=dec(state.gater_validate, cfg.gater_global_decay),
        gater_throttle=dec(state.gater_throttle, cfg.gater_global_decay),
        gater_deliver=dec(state.gater_deliver, cfg.gater_source_decay),
        gater_duplicate=dec(state.gater_duplicate, cfg.gater_source_decay),
        gater_ignore=dec(state.gater_ignore, cfg.gater_source_decay),
        gater_reject=dec(state.gater_reject, cfg.gater_source_decay))


def accept_data(state: SimState, cfg: SimConfig, key: torch.Tensor,
                noise: torch.Tensor | None = None) -> torch.Tensor:
    """[N, K] bool: receiver n admits DATA from the peer in slot k this tick
    (AcceptFrom, peer_gater.go:320-363); control always flows. ``noise``
    replaces the [N, K] uniform draw (``key`` then unused)."""
    n, k = state.gater_deliver.shape
    quiet = (state.tick - state.gater_last_throttle) > cfg.gater_quiet_ticks
    ratio_low = (state.gater_validate != 0.0) & (
        state.gater_throttle / torch.clamp(state.gater_validate, min=1e-9)
        < cfg.gater_threshold)
    gate_off = quiet | (state.gater_throttle == 0.0) | ratio_low      # [N]
    total = (state.gater_deliver
             + cfg.gater_duplicate_weight * state.gater_duplicate
             + cfg.gater_ignore_weight * state.gater_ignore
             + cfg.gater_reject_weight * state.gater_reject)          # [N, K]
    p = (1.0 + state.gater_deliver) / (1.0 + total)
    if noise is None:
        noise = rng.uniform(key, (n, k))
    return gate_off[:, None] | (total == 0.0) | (noise < p)
