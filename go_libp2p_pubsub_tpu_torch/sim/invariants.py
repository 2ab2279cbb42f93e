"""In-step invariant sentinel: the ``SimState.fault_flags`` bit word (port
of sim/invariants.py, ``"record"`` mode).

The bit layout is the reference's (flags version 2): the low half-word
holds injected-fault bits (set by the fault plane, a later slice of the
port), bits 16+ invariant violations that must never hold in a healthy run.
"""

from __future__ import annotations

import torch

from .config import SimConfig
from .state import NEVER, SimState

FLAGS_VERSION = 2
FLAG_NONFINITE = 1 << 16     # NaN/Inf in a score counter / app score
FLAG_NEG_COUNTER = 1 << 17   # a monotone/decayed counter went negative
FLAG_MESH_DEAD_EDGE = 1 << 18  # mesh slot points at a down/absent edge
FLAG_GRAFT_IN_BACKOFF = 1 << 19  # edge grafted while its backoff was live
FLAG_SLOT_GARBAGE = 1 << 20  # slot/topic index out of range
FLAG_DELIVER_FUTURE = 1 << 21  # deliver_tick > tick, negative, or
#                                delivered-but-not-seen
FLAG_HALO_OVERFLOW = 1 << 22  # halo-route bucket overflow (counter > 0)

VIOLATION_MASK = 0xFFFF0000
INJECTED_MASK = 0x0000FFFF


def _bit(cond: torch.Tensor, bit: int) -> torch.Tensor:
    return torch.where(cond, bit, 0).to(torch.int32)


def violation_flags(state: SimState, cfg: SimConfig) -> torch.Tensor:
    """int32 scalar of violation bits for the END-OF-TICK state (called by
    engine.step before the tick increments). NaN fails every ``>= 0`` and
    ``< inf`` comparison, so it lands in the nonfinite bit only."""
    n, t, k = state.mesh.shape
    tick = state.tick
    nonneg = [state.first_message_deliveries, state.mesh_message_deliveries,
              state.mesh_failure_penalty, state.invalid_message_deliveries,
              state.behaviour_penalty, state.gater_validate,
              state.gater_throttle, state.gater_deliver,
              state.gater_duplicate, state.gater_ignore, state.gater_reject]
    dev = tick.device
    bad_neg = torch.zeros((), dtype=torch.bool, device=dev)
    bad_fin = torch.zeros((), dtype=torch.bool, device=dev)
    for a in nonneg:
        bad_neg = bad_neg | (a < 0).any()
        bad_fin = bad_fin | ~(a.abs() < float("inf")).all()
    bad_neg = bad_neg | (state.delivered_total < 0) | (state.halo_overflow < 0)
    bad_fin = bad_fin | ~(state.app_score.abs() < float("inf")).all() \
        | ~(state.delivered_total < float("inf"))
    f = _bit(bad_fin, FLAG_NONFINITE) | _bit(bad_neg, FLAG_NEG_COUNTER)

    live = (state.connected & (state.neighbors >= 0))[:, None, :]
    f = f | _bit((state.mesh & ~live).any(), FLAG_MESH_DEAD_EDGE)
    f = f | _bit((state.mesh & (state.graft_tick == tick)
                  & (state.backoff > tick)).any(), FLAG_GRAFT_IN_BACKOFF)

    def out_of(x, hi):
        return ((x < -1) | (x >= hi)).any()
    bad_rng = out_of(state.iwant_pending, k) | out_of(state.deliver_from, k) \
        | out_of(state.msg_topic, t) | out_of(state.msg_publisher, n)
    f = f | _bit(bad_rng, FLAG_SLOT_GARBAGE)

    from ..ops.bits import pack_words
    dlv = state.deliver_tick < NEVER
    bad_dlv = (dlv & (state.deliver_tick > tick)).any() \
        | (dlv & (state.deliver_tick < 0)).any() \
        | (pack_words(dlv) & ~state.have.T).ne(0).any()
    f = f | _bit(bad_dlv, FLAG_DELIVER_FUTURE)
    f = f | _bit(state.halo_overflow > 0, FLAG_HALO_OVERFLOW)
    return f


def record_flags(state: SimState, cfg: SimConfig) -> SimState:
    """OR this tick's violation bits into ``state.fault_flags``."""
    if cfg.invariant_mode != "record":
        raise NotImplementedError(
            f"invariant_mode={cfg.invariant_mode!r}: the port records flags "
            "only; 'raise' and 'off' are a later slice")
    return state._replace(
        fault_flags=state.fault_flags | violation_flags(state, cfg))


def decode_violations(flags: int) -> list[str]:
    """Names of the violation bits set in ``flags``."""
    names = {FLAG_NONFINITE: "nonfinite_counter",
             FLAG_NEG_COUNTER: "negative_counter",
             FLAG_MESH_DEAD_EDGE: "mesh_dead_edge",
             FLAG_GRAFT_IN_BACKOFF: "graft_in_backoff",
             FLAG_SLOT_GARBAGE: "slot_garbage",
             FLAG_DELIVER_FUTURE: "deliver_future",
             FLAG_HALO_OVERFLOW: "halo_overflow"}
    return [name for bit, name in sorted(names.items()) if flags & bit]
