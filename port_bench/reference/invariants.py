"""In-step invariant sentinel: the ``SimState.fault_flags`` bit word (port
of sim/invariants.py).

The bit layout is the reference's (flags version 2): the low half-word
holds injected-fault bits (which faults of the plan fired, sim/faults.py),
bits 16+ invariant violations that must never hold in a healthy run.

``SimConfig.invariant_mode`` picks the escalation:

- ``"record"`` (default): OR the tick's flags into ``state.fault_flags``;
- ``"raise"``: the same state, and ``sim.engine.run_checked`` reads the
  tick's violation bits on the host after every tick and raises
  :class:`InvariantViolation` at the first tick that sets one (the
  reference's checkify check; a device-side assert would poison the CUDA
  context);
- ``"off"``: no checks, no flag writes (the engine skips
  :func:`record_flags`).
"""

from __future__ import annotations

import torch

from .config import SimConfig
from .state import NEVER, SimState

FLAGS_VERSION = 2
FAULT_LINK_DROP = 1 << 0     # >=1 link dropped a data plane this run
FAULT_LINK_DUP = 1 << 1      # >=1 link duplicated traffic
FAULT_PARTITION = 1 << 2     # a partition window was active
FAULT_OUTAGE = 1 << 3        # an outage window was active
FAULT_CORRUPT = 1 << 4       # >=1 honest publish was corrupted
FAULT_STORM = 1 << 5         # a flash-crowd publish storm window was active
FAULT_SLOWLINK = 1 << 6      # >=1 slow-link class stalled a live edge
FAULT_ECLIPSE = 1 << 7       # an eclipse window was active
FAULT_CENSOR = 1 << 8        # a censorship window was active
FAULT_WAVE = 1 << 9          # a diurnal churn wave's dark phase was active

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


def violation_flags(state: SimState, cfg: SimConfig,
                    n_global: int | None = None) -> torch.Tensor:
    """int32 scalar of violation bits for the END-OF-TICK state (called by
    engine.step before the tick increments). NaN fails every ``>= 0`` and
    ``< inf`` comparison, so it lands in the nonfinite bit only.

    ``n_global`` bounds the publisher ids of a row slice of a larger
    network (a degree-bucket view, sim/bucketed.py), whose own row count
    is not the id space (invariants.py:128-146). Every check is an any()
    reduction, so the words of the slices OR into the whole network's."""
    n, t, k = state.mesh.shape
    if n_global is not None:
        n = n_global
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

    from .bits import pack_words
    dlv = state.deliver_tick < NEVER
    bad_dlv = (dlv & (state.deliver_tick > tick)).any() \
        | (dlv & (state.deliver_tick < 0)).any() \
        | (pack_words(dlv) & ~state.have.T).ne(0).any()
    f = f | _bit(bad_dlv, FLAG_DELIVER_FUTURE)
    f = f | _bit(state.halo_overflow > 0, FLAG_HALO_OVERFLOW)
    return f


class InvariantViolation(ValueError):
    """A tick set an invariant-violation bit under ``invariant_mode=
    "raise"`` (raised by ``sim.engine.run_checked``). ``flags`` holds the
    violation bits of the first failing tick, ``tick`` that tick's
    number; the message begins ``invariant violation: fault_flags=``, and
    the class is a ValueError, as the reference's checkify error."""

    def __init__(self, flags: int, tick: int):
        self.flags, self.tick = flags, tick
        super().__init__(f"invariant violation: fault_flags={flags} "
                         f"(tick {tick}: {', '.join(decode_flags(flags))})")


def tick_flags(state: SimState, cfg: SimConfig,
               injected: torch.Tensor | None = None,
               n_global: int | None = None) -> torch.Tensor:
    """This tick's (violation | injected) bits, the word
    :func:`record_flags` ORs into the state (``n_global`` as
    :func:`violation_flags`')."""
    if cfg.invariant_mode not in ("record", "raise"):
        raise ValueError(
            f"invariant_mode={cfg.invariant_mode!r}: expected 'off', "
            "'record', or 'raise'")
    flags = violation_flags(state, cfg, n_global=n_global)
    if injected is not None:
        flags = flags | injected
    return flags


def record_flags(state: SimState, cfg: SimConfig,
                 injected: torch.Tensor | None = None,
                 n_global: int | None = None) -> SimState:
    """OR this tick's violation bits, and the fault plane's ``injected``
    bits when given, into ``state.fault_flags`` (``"record"`` and
    ``"raise"``; the engine skips the call under ``"off"``)."""
    return state._replace(fault_flags=state.fault_flags | tick_flags(
        state, cfg, injected, n_global=n_global))


_NAMES = {
    FAULT_LINK_DROP: "link_drop",
    FAULT_LINK_DUP: "link_dup",
    FAULT_PARTITION: "partition",
    FAULT_OUTAGE: "outage",
    FAULT_CORRUPT: "corrupt",
    FAULT_STORM: "storm",
    FAULT_SLOWLINK: "slowlink",
    FAULT_ECLIPSE: "eclipse",
    FAULT_CENSOR: "censor",
    FAULT_WAVE: "wave",
    FLAG_NONFINITE: "VIOLATION:nonfinite_counter",
    FLAG_NEG_COUNTER: "VIOLATION:negative_counter",
    FLAG_MESH_DEAD_EDGE: "VIOLATION:mesh_dead_edge",
    FLAG_GRAFT_IN_BACKOFF: "VIOLATION:graft_in_backoff",
    FLAG_SLOT_GARBAGE: "VIOLATION:slot_garbage",
    FLAG_DELIVER_FUTURE: "VIOLATION:deliver_future",
    FLAG_HALO_OVERFLOW: "VIOLATION:halo_overflow",
}


def decode_flags(flags: int, flags_version: int | None = None) -> list[str]:
    """Names of the set bits, injected faults and violations (invariants.py
    :100). ``flags_version`` is the layout the word was recorded under;
    any version but :data:`FLAGS_VERSION` is refused, since version 1
    kept violations at bits 8+, where this layout puts FAULT_CENSOR and
    FAULT_WAVE. ``None`` decodes under the current layout."""
    if flags_version is not None and int(flags_version) != FLAGS_VERSION:
        raise ValueError(
            f"fault_flags word was recorded under flags_version="
            f"{int(flags_version)} but this build decodes "
            f"flags_version={FLAGS_VERSION} — the bit layouts differ "
            "(version 1 kept violations at bits 8+, where this layout "
            "puts FAULT_CENSOR/FAULT_WAVE); decode it with the build "
            "that wrote it instead of misreading the bits")
    out = [name for bit, name in sorted(_NAMES.items()) if flags & bit]
    unknown = flags & ~sum(_NAMES)
    if unknown:
        out.append(f"unknown:0x{unknown:x}")
    return out
