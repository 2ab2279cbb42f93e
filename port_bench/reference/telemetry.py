"""Streaming telemetry: the per-tick health record and its journal (port of
sim/telemetry.py).

A :class:`HealthRecord` reduces the state a tick left behind to a few
aggregates on the device: per-topic settled delivery, mesh degree
min/mean/max, the backoff and graylist census split by the attacker mask,
score stats, the message window, the delivery counter, ``halo_overflow``
and the ``fault_flags`` word. ``engine.run_keys``, ``run_window`` and
``run_checked_keys`` with ``telemetry=True``, and
``parallel.compile_plan.engine_chunk`` / ``engine_window`` with
``telemetry=True``, return ``(state, HealthRecord)`` with ``[C]``-stacked
leaves: one record per tick, computed from the post-step state, with no
host read (a captured chunk records them into its graph). Telemetry never
writes to the state.

Parity (tests/test_torch_telemetry.py): every column equals the
reference's exactly (integer counts, integer-valued float32 sums below
2**24, min/max) except ``score_mean``, a float32 sum of arbitrary values
whose reduction order differs between torch and XLA (3.1e-6 relative
apart at 1024 terms; the tests hold it to rtol 1e-5).

On the host, :func:`records_to_rows` lays a chunk's records out as one
float64 row matrix (one transfer), :func:`encode_rows` writes NDJSON (the
native codec of trace/native.py formats a chunk in one C call; the Python
encoder where its library cannot be built) and :class:`HealthJournal`
appends fsync'd run / chunk / note markers and health rows;
:func:`read_journal` reads it back, tolerating a torn tail and
deduplicating re-streamed ticks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import SimConfig, TopicParams
from .state import SimState, decode_state, is_compact, unpack_have

# sentinels, as the reference's (telemetry.py:62-63)
_BIG_I32 = 2 ** 30
_BIG_F32 = float(np.float32(3.0e38))


class HealthRecord(NamedTuple):
    """Per-tick aggregates (telemetry.py:67-98). Every leaf is a scalar
    tensor except ``delivery_frac`` (``[T]``); the run lanes stack a
    leading ``[C]`` axis. ``tick`` is the tick that ran (the record
    describes the state after it). ``fault_flags`` is int32 holding the
    reference's uint32 bits."""

    tick: torch.Tensor             # int32: the tick this record closes
    delivery_frac: torch.Tensor    # [T] f32 per-topic settled delivery
    mesh_deg_min: torch.Tensor     # int32 over subscribed (peer, topic)
    mesh_deg_mean: torch.Tensor    # f32
    mesh_deg_max: torch.Tensor     # int32
    backoff_count: torch.Tensor    # int32 live backoff entries
    graylist_count: torch.Tensor   # int32 connected edges below graylist
    connected_edges: torch.Tensor  # int32 connected neighbor slots
    attacker_edges: torch.Tensor   # int32 connected slots to an attacker
    attacker_graylisted: torch.Tensor  # int32 attacker edges graylisted
    honest_graylisted: torch.Tensor    # int32 honest edges graylisted
    score_mean: torch.Tensor       # f32 over connected slots
    score_min: torch.Tensor        # f32
    published_window: torch.Tensor  # int32 live slots of the window
    delivered_total: torch.Tensor  # f32 cumulative delivery counter
    halo_overflow: torch.Tensor    # int32
    fault_flags: torch.Tensor      # int32 bits (sim/invariants.py)


def health_record(state: SimState, cfg: SimConfig,
                  tp: TopicParams) -> HealthRecord:
    """The record of the state a tick left behind (telemetry.py:101-233),
    in either storage layout (a compact state is decoded first). Device
    tensors throughout, so a captured chunk can record it; applied after
    the fact to a stored trajectory it gives the streamed records."""
    from .score_ops import compute_scores

    if is_compact(state):
        state = decode_state(state, cfg)
    n, t_topics, k = state.mesh.shape
    tick = state.tick
    i32, f32 = torch.int32, torch.float32

    # per-topic settled delivery over deliverable traffic (valid, alive,
    # neither invalid nor ignored) to honest subscribers; an empty census
    # reads 1.0
    age = tick - state.msg_publish_tick
    alive = (age < cfg.history_length) & (age >= 0)
    valid = state.msg_topic >= 0
    deliverable = valid & alive & ~state.msg_invalid & ~state.msg_ignored
    t_m = state.msg_topic.clamp(0, t_topics - 1).long()
    att = state.malicious                                         # [N]
    should = state.subscribed[:, t_m] & ~att[:, None] \
        & deliverable[None, :]                                    # [N, M]
    got = unpack_have(state, cfg.msg_window) & should
    zero = torch.zeros((), dtype=f32, device=tick.device)
    # per-topic sums as masked row sums, not a scatter-add: the card's
    # atomic adds would vary the float32 order from run to run, and past
    # 2**24 deliveries (a million peers) the order shows in the sum
    of_topic = (t_m[None, :] == torch.arange(t_topics, device=tick.device)
                [:, None]) & deliverable[None, :]                 # [T, M]
    got_t = torch.where(of_topic, got.sum(0).to(f32), zero).sum(1)
    should_t = torch.where(of_topic, should.sum(0).to(f32), zero).sum(1)
    delivery_frac = torch.where(should_t > 0.0,
                                got_t / should_t.clamp(min=1.0), 1.0)

    # mesh degree over subscribed (peer, topic) pairs
    deg = state.mesh.sum(-1).to(i32)                              # [N, T]
    sub = state.subscribed
    n_sub = sub.sum()
    any_sub = n_sub > 0
    deg_min = torch.where(any_sub, deg.masked_fill(~sub, _BIG_I32).min(),
                          0).to(i32)
    deg_max = torch.where(any_sub, deg.masked_fill(~sub, -1).max(),
                          0).to(i32)
    deg_mean = deg.masked_fill(~sub, 0).sum().to(f32) \
        / n_sub.clamp(min=1).to(f32)

    # backoff / graylist census, split by the attacker mask
    backoff_count = (state.backoff > tick).sum().to(i32)
    scores = compute_scores(state, cfg, tp, apply_decay=True)     # [N, K]
    gray = state.connected & (scores < cfg.graylist_threshold)
    graylist_count = gray.sum().to(i32)
    nbr_att = att[state.neighbors.clamp(0, n - 1).long()] \
        & (state.neighbors >= 0)                                  # [N, K]
    attacker_edges = (state.connected & nbr_att).sum().to(i32)
    attacker_graylisted = (gray & nbr_att).sum().to(i32)

    # score stats over connected slots
    conn = state.connected
    n_conn = conn.sum()
    score_mean = torch.where(conn, scores, zero).sum() \
        / n_conn.clamp(min=1).to(f32)
    score_min = torch.where(n_conn > 0,
                            scores.masked_fill(~conn, _BIG_F32).min(),
                            zero).to(f32)

    return HealthRecord(
        tick=(tick - 1).to(i32),
        delivery_frac=delivery_frac,
        mesh_deg_min=deg_min,
        mesh_deg_mean=deg_mean,
        mesh_deg_max=deg_max,
        backoff_count=backoff_count,
        graylist_count=graylist_count,
        connected_edges=n_conn.to(i32),
        attacker_edges=attacker_edges,
        attacker_graylisted=attacker_graylisted,
        honest_graylisted=graylist_count - attacker_graylisted,
        score_mean=score_mean,
        score_min=score_min,
        published_window=valid.sum().to(i32),
        delivered_total=state.delivered_total,
        halo_overflow=state.halo_overflow,
        fault_flags=state.fault_flags,
    )


def stack_records(records: list) -> HealthRecord:
    """Per-tick records -> one record with ``[C]``-stacked leaves."""
    return HealthRecord(*(torch.stack(leaf) for leaf in zip(*records)))


# ---------------------------------------------------------------------------
# row schema: one flat numeric row per (tick[, member])

_INT_COLS = {"tick", "member", "mesh_deg_min", "mesh_deg_max",
             "backoff_count", "graylist_count", "connected_edges",
             "attacker_edges", "attacker_graylisted", "honest_graylisted",
             "published_window", "halo_overflow", "fault_flags"}

# the ingest marker's fields (telemetry.py:262-270): one
# ``{"kind": "ingest", ...}`` journal note per chunk of a live command
# plane
INGEST_COLUMNS = ("tick", "directives", "shed", "shed_total",
                  "refused_total", "queue_depth", "lag_ticks", "offset",
                  "coasting")

_SCALAR_FIELDS = ["mesh_deg_min", "mesh_deg_mean", "mesh_deg_max",
                  "backoff_count", "graylist_count", "connected_edges",
                  "attacker_edges", "attacker_graylisted",
                  "honest_graylisted", "score_mean", "score_min",
                  "published_window", "delivered_total", "halo_overflow",
                  "fault_flags"]


