"""The simulation engine: one step = faults + publish + heartbeat + traffic
+ churn (port of sim/engine.py).

    step: (state, key) -> state
      0. apply_faults       (fault plans) partition/outage/eclipse/wave cuts
                            and heals, this tick's link and corruption draws
      1. churn_subscriptions (sub churn configs) topic Join/Leave round
      2. publish            P scenario-chosen messages enter the network
      3. gater_decay        (gater configs) the peer gater's stats decay
      4. heartbeat          mesh maintenance + GRAFT/PRUNE exchange + gossip
                            peer selection (score decay applies inline);
                            floodsub and randomsub run none
      5. forward_tick       IWANT resolution, forwarding hops, IHAVE emit
      6. churn_edges        (churn configs) edges go down and come back
      7. record_flags       injected-fault and violation bits close the tick
                            (skipped under invariant_mode="off")

The state travels between ticks in the layout ``cfg.state_precision``
stores (sim/state.py): ``step`` decodes a compact state at entry and
encodes it at exit, so every op computes in the f32 layout.

The entry points step eagerly, one Python loop iteration a tick, as the
reference's ``lax.scan``s do on device:

- :func:`run` dispatches on ``key_schedule``: ``"host"`` splits ONE master
  key into per-tick keys (:func:`run_keys` over them), ``"fold_in"``
  derives each tick's key from the master and the state's absolute tick
  (:func:`run_window`), so any chunking of a run lands on the same
  trajectory;
- :func:`window_keys` gives the per-tick keys of a window of a run under
  either schedule;
- :func:`run_checked` / :func:`run_checked_keys` escalate
  ``invariant_mode="raise"``: the tick's violation bits are read on the
  host after every tick, and the first tick that sets one raises
  :class:`~.invariants.InvariantViolation`. The plain entry points refuse
  ``"raise"`` with a ValueError, as the reference's do;
- ``telemetry=True`` on :func:`run_keys`, :func:`run_window` and
  :func:`run_checked_keys` returns ``(state, HealthRecord)``: one
  :func:`~.telemetry.health_record` of each tick's post-step state,
  stacked to ``[C]`` leaves, on the device (sim/telemetry.py).

An unknown storage precision, compact storage at k_slots > 127 or an
unknown formulation raises ValueError (:func:`check_slice`). The dense
step ignores ``degree_buckets``, as the reference's does: it runs the
config on its dense [N, k_slots] layout; the degree-bucketed layout runs
through sim/bucketed.py.
"""

from __future__ import annotations

import torch

from .. import rng
from ..parallel import kernel_context as kc
from ..device import check_on
from ..spans import span
from ..ops.bits import pack_words, popcount
from ..ops.churn import churn_edges, churn_subscriptions
from ..ops.dispatch import resolved_formulations
from ..ops.gater import gater_decay
from ..ops.heartbeat import HeartbeatOut, heartbeat
from ..ops.hopkernel import resolve_hop_mode
from ..ops.permgather import resolve_edge_packed_mode
from ..ops.propagate import forward_tick, publish
from .config import SimConfig, TopicParams
from .faults import apply_faults, censor_word_mask, storm_publishers
from .invariants import (FAULT_CORRUPT, VIOLATION_MASK, InvariantViolation,
                         tick_flags)
from .state import (NEVER, SimState, check_precision, decode_state,
                    encode_state, is_compact, unpack_have)
from .telemetry import health_record, stack_records


def check_slice(cfg: SimConfig) -> None:
    """Check a config against the step's paths: every router (gossipsub
    with scoring, floodsub, randomsub), flood publish, the peer gater, the
    validation and edge queue caps, provenance, every fault-plan family,
    connection churn with PX and subscription churn, on the fused kernels
    or the non-fused data path (hop_mode ``auto``/``pallas``/
    ``pallas-mxu``/``xla``) in every gather formulation (``auto``,
    ``pallas``, ``mxu``, ``scalar``, ``rows``, ``sort``) and selection
    formulation, uint8 or int32 hop counts (int32 on the non-fused path),
    under every invariant mode, key schedule and storage precision, with
    or without ``degree_buckets`` (which the dense step does not read). An
    unknown precision, compact storage at k_slots > 127, or an unknown
    formulation raises ValueError."""
    check_precision(cfg)
    resolved_formulations(cfg)


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
    sub = kc.owner_rows(state.subscribed, peers)          # [P, T]
    g = rng.gumbel(kt, tuple(sub.shape))
    topics = torch.argmax(torch.where(sub, g, torch.full_like(g, -float("inf"))),
                          dim=-1).to(torch.int32)
    if storms:
        peers, topics = storm_publishers(state, cfg, peers, topics, k_storm)
    return peers, topics


def _iwant_answer_extras(state: SimState, cfg: SimConfig,
                         censor_bits: torch.Tensor | None = None
                         ) -> list | None:
    """The IWANT answer table, to ride the heartbeat's final exchange
    (engine.py:64-100): it reads only deliver_tick and malicious, which the
    heartbeat never writes, and censors withhold the victim's messages
    from it as forward_tick does. The carriers are the exchange's ``sort``
    (extra lanes of its permutation) and ``mxu`` (extra rows of the take)
    formulations, for the non-fused resolve only (the fused resolve
    kernel gathers the table itself); otherwise None."""
    n, t, k = state.mesh.shape
    if resolve_hop_mode(cfg) == "pallas" or resolve_edge_packed_mode(
            cfg.edge_gather_mode, kc.global_rows(n), k, 2 * t) \
            not in ("sort", "mxu"):
        return None
    zero = torch.zeros((), dtype=torch.int32, device=state.tick.device)
    answer_bits = torch.where(state.malicious[None, :], zero,
                              pack_words(state.deliver_tick < NEVER))
    if censor_bits is not None:
        answer_bits = answer_bits & ~censor_bits
    return [answer_bits]


def _step(state: SimState, cfg: SimConfig, tp: TopicParams,
          key: torch.Tensor) -> tuple[SimState, torch.Tensor | None]:
    """One tick of a stored state (engine.py:103-192): decoded at entry,
    :func:`_tick`, encoded at exit (both identities under ``"f32"``)."""
    with span("engine.codec"):
        state = decode_state(state, cfg)
    state, flags = _tick(state, cfg, tp, key)
    with span("engine.codec"):
        state = encode_state(state, cfg)
    return state, flags


def _tick(state: SimState, cfg: SimConfig, tp: TopicParams,
          key: torch.Tensor) -> tuple[SimState, torch.Tensor | None]:
    """One tick in the compute layout: the next state and this tick's flag
    word (violation | injected bits; None under ``invariant_mode="off"``).
    Each stage runs inside its span (spans.NAMES); the stage functions are
    looked up as this module's globals at call time, so a wrapper set on
    the module (port_bench/tracing.py's eager spans) sees every call."""
    if cfg.fault_plan is not None:
        # the fault pass opens the tick; its key split exists only under a
        # plan, so plan-free configs keep their exact stream
        with span("engine.faults"):
            key, k_fault = rng.split(key, 2)
            state, fault = apply_faults(state, cfg, tp, k_fault)
    else:
        fault = None
    with span("engine.keys"):
        k_pub, k_hb, k_fwd, k_churn, k_ign, k_sub = rng.split(key, 6)
    if cfg.sub_leave_prob > 0.0 or cfg.sub_join_prob > 0.0:
        with span("engine.sub_churn"):
            state = churn_subscriptions(state, cfg, tp, k_sub)
    with span("engine.publish"):
        peers, topics = choose_publishers(state, cfg, k_pub)
        if fault is not None and fault.corrupt is not None:
            # effective corruption: a draw on a malicious publisher
            # corrupts nothing (its message is invalid already)
            corrupt = fault.corrupt & ~kc.owner_rows(state.malicious, peers)
            fault = fault._replace(corrupt=corrupt, injected=fault.injected | (
                corrupt.any().to(torch.int32) * FAULT_CORRUPT))
        state = publish(state, cfg, peers, topics, k_ign,
                        corrupt=fault.corrupt if fault is not None else None)
        # the censor mask reads msg_publisher, so it follows publish
        censor_bits = censor_word_mask(state, cfg)
    if cfg.gater_enabled:
        with span("engine.gater"):
            state = gater_decay(state, cfg)
    gossipsub = cfg.router == "gossipsub"
    with span("engine.heartbeat"):
        if gossipsub:
            hb = heartbeat(state, cfg, tp, k_hb,
                           extra_words=_iwant_answer_extras(state, cfg,
                                                            censor_bits))
        else:
            # floodsub and randomsub run no heartbeat: no mesh, no gossip,
            # no scoring (engine.py:147-161)
            n, t, k = state.mesh.shape
            dev = state.mesh.device
            zf = torch.zeros((n, k), dtype=torch.float32, device=dev)
            zb = torch.zeros((n, t, k), dtype=torch.bool, device=dev)
            hb = HeartbeatOut(state=state, scores=zf, scores_all=zf,
                              inc_gossip=zb, fwd_send=zb)
    with span("engine.forward"):
        state = forward_tick(hb.state, cfg, tp, hb.inc_gossip, hb.scores,
                             k_fwd,
                             fwd_send=hb.fwd_send if gossipsub else None,
                             answers_k=hb.extra_routed[0] if hb.extra_routed
                             else None,
                             link_ok=fault.link_ok if fault is not None
                             else None,
                             dup_edges=fault.dup_edges if fault is not None
                             else None,
                             censor_bits=censor_bits)
    if cfg.churn_disconnect_prob > 0.0:
        # connection churn closes the tick, reusing the heartbeat's
        # unmasked score cache for the PX reconnect gate; plan-cut edges
        # stay down
        with span("engine.churn"):
            state = churn_edges(state, cfg, tp, k_churn,
                                scores_all=hb.scores_all,
                                forbid_up=fault.want_down if fault is not None
                                else None)
    with span("engine.flags"):
        notes = kc.drain_halo_overflow()
        if notes:
            # halo-route bucket overflows this tick (parallel/halo.py
            # capacity rule, engine.py:177-183): a poisoned run identifies
            # itself
            state = state._replace(halo_overflow=state.halo_overflow
                                   + sum(notes))
        flags = None
        if cfg.invariant_mode != "off":
            # the sentinel closes the tick: injected-fault bits and
            # invariant violations OR into the sticky flag word (inside a
            # peer group every rank's bits)
            flags = kc.por(tick_flags(
                state, cfg, injected=fault.injected if fault is not None
                else None, n_global=kc.global_rows(state.mesh.shape[0])))
            state = state._replace(fault_flags=state.fault_flags | flags)
    return state._replace(tick=state.tick + 1), flags


def step(state: SimState, cfg: SimConfig, tp: TopicParams,
         key: torch.Tensor, device=None) -> SimState:
    """Advance the network one heartbeat on ``device`` (cuda unless the
    caller passes ``device="cpu"``; the state must lie there). Under
    ``invariant_mode="raise"`` it computes the ``"record"`` state; only
    :func:`run_checked` and :func:`run_checked_keys` raise."""
    check_on(state.tick.device, device)
    check_slice(cfg)
    return _step(state, cfg, tp, key)[0]


def _ticks(state: SimState, cfg: SimConfig, tp: TopicParams, n_ticks: int,
           key_of, checked: bool, telemetry: bool = False):
    """Step ``n_ticks`` times, tick i under the key ``key_of(i, state)``.
    ``checked`` under ``invariant_mode="raise"`` reads each tick's
    violation bits on the host and raises at the first tick that sets
    one. ``telemetry`` returns ``(state, HealthRecord)``, the records of
    every tick's post-step state stacked to ``[C]``."""
    check_slice(cfg)
    check = checked and cfg.invariant_mode == "raise"
    records = []
    for i in range(n_ticks):
        state, flags = _step(state, cfg, tp, key_of(i, state))
        if check:
            viol = int(flags) & VIOLATION_MASK
            if viol:
                raise InvariantViolation(viol, int(state.tick) - 1)
        if telemetry:
            with span("engine.telemetry"):
                records.append(health_record(state, cfg, tp))
    return (state, stack_records(records)) if telemetry else state


def _plain(cfg: SimConfig, what: str) -> None:
    """The reference's unchecked entry points cannot evaluate a checkify
    check, so ``"raise"`` fails there; so it does here."""
    if cfg.invariant_mode == "raise":
        raise ValueError(
            f"{what} under invariant_mode='raise': the raise mode escalates "
            "through run_checked or run_checked_keys (use 'record' for a "
            "plain run)")


def _folded(key: torch.Tensor):
    """Tick keys of the ``"fold_in"`` schedule: the master folded with the
    state's absolute tick, on the state's device (no host read)."""
    return lambda i, st: rng.fold_in(key, st.tick)


def _rows(keys: torch.Tensor):
    return lambda i, st: keys[i]


def _schedule(state: SimState, cfg: SimConfig, key: torch.Tensor,
              n_ticks: int):
    """``key_of`` of a run of ``n_ticks`` from one master key under
    ``cfg.key_schedule`` (engine.py:238-250): the host pre-split, or one
    fold of the master with the state's tick before each step."""
    key = key.to(state.tick.device)
    if cfg.key_schedule == "fold_in":
        return _folded(key)
    if cfg.key_schedule != "host":
        raise ValueError(f"unknown key_schedule {cfg.key_schedule!r}; "
                         "expected 'host' or 'fold_in'")
    return _rows(rng.split(key, n_ticks))


def run(state: SimState, cfg: SimConfig, tp: TopicParams, key: torch.Tensor,
        n_ticks: int, device=None) -> SimState:
    """Advance ``n_ticks`` heartbeats from one master key under
    ``cfg.key_schedule``."""
    check_on(state.tick.device, device)
    _plain(cfg, "run")
    return _ticks(state, cfg, tp, n_ticks,
                  _schedule(state, cfg, key, n_ticks), False)


def run_keys(state: SimState, cfg: SimConfig, tp: TopicParams,
             keys: torch.Tensor, telemetry: bool = False, device=None):
    """Advance one tick per row of ``keys`` ([C, 2]): the chunkable core of
    ``run`` (engine.py:195-218). Any contiguous windows of ``run``'s own
    keys (:func:`window_keys`) land on ``run``'s trajectory.
    ``telemetry=True`` returns ``(state, HealthRecord)``."""
    check_on(state.tick.device, device)
    _plain(cfg, "run_keys")
    return _ticks(state, cfg, tp, keys.shape[0],
                  _rows(keys.to(state.tick.device)), False, telemetry)


def run_window(state: SimState, cfg: SimConfig, tp: TopicParams,
               key: torch.Tensor, n_ticks: int, telemetry: bool = False,
               device=None):
    """The ``key_schedule="fold_in"`` core (engine.py:221-235): each tick's
    key is ``fold_in(key, state.tick)``, folded on the state's device, so
    any chunking of a run, or a resume from a saved tick, lands on the
    same trajectory. ``telemetry=True`` returns ``(state,
    HealthRecord)``."""
    check_on(state.tick.device, device)
    _plain(cfg, "run_window")
    return _ticks(state, cfg, tp, n_ticks,
                  _folded(key.to(state.tick.device)), False, telemetry)


def window_keys(cfg: SimConfig, key: torch.Tensor, start_tick: int,
                lo: int, hi: int, n_ticks: int) -> torch.Tensor:
    """The [hi - lo, 2] per-tick keys that a run of ``n_ticks`` from
    ``start_tick`` consumes for its run-relative window ``[lo, hi)``
    (engine.py:253-266): a slice of the one master split under ``"host"``,
    folds of the absolute tick numbers under ``"fold_in"``."""
    if cfg.key_schedule == "fold_in":
        return rng.fold_in(key, torch.arange(start_tick + lo, start_tick + hi,
                                             device=key.device))
    return rng.split(key, n_ticks)[lo:hi]


def run_checked(state: SimState, cfg: SimConfig, tp: TopicParams,
                key: torch.Tensor, n_ticks: int, device=None) -> SimState:
    """``run`` with the invariant sentinel escalated (engine.py:297-312):
    under ``invariant_mode="raise"`` the first tick that sets a violation
    bit raises :class:`~.invariants.InvariantViolation` with that tick's
    violation bits. Under the other modes, a plain run."""
    check_on(state.tick.device, device)
    return _ticks(state, cfg, tp, n_ticks,
                  _schedule(state, cfg, key, n_ticks), True)


def run_checked_keys(state: SimState, cfg: SimConfig, tp: TopicParams,
                     keys: torch.Tensor, telemetry: bool = False,
                     device=None):
    """``run_keys`` with the invariant sentinel escalated, as
    :func:`run_checked` (engine.py:315-331); ``telemetry`` as
    ``run_keys``'."""
    check_on(state.tick.device, device)
    return _ticks(state, cfg, tp, keys.shape[0],
                  _rows(keys.to(state.tick.device)), True, telemetry)


def mesh_degrees(state: SimState) -> torch.Tensor:
    """[N, T] current mesh degree, in either storage layout: a packed mesh
    plane counts by popcount (its pad bits are zero)."""
    if is_compact(state):
        return popcount(state.mesh).sum(-1).to(torch.int32)
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


def delivery_latency_ticks(state: SimState, cfg: SimConfig) -> torch.Tensor:
    """Mean ticks from publish to delivery over delivered (peer, message)
    pairs in the live window (engine.py:372-391), the propagation-latency
    metric of BASELINE config #5. The publisher's own zero-latency pair is
    excluded by subtracting one pair per live message; 0 when nothing but
    publishers delivered. A compact state is decoded first."""
    if is_compact(state):
        state = decode_state(state, cfg)
    alive = (state.msg_publish_tick < NEVER) & \
        ((state.tick - state.msg_publish_tick) < cfg.history_length)
    dlv = (state.deliver_tick < NEVER) & alive[None, :]
    lat = (state.deliver_tick - state.msg_publish_tick[None, :]).float()
    n_pairs = dlv.sum() - dlv.any(0).sum()
    return torch.where(dlv, lat, torch.zeros_like(lat)).sum() \
        / torch.clamp(n_pairs, min=1)
